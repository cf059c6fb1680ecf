"""The port's own span log (``repro_torch.obs.spans``), read for the
per-layer metrics measured inside the program: the newest log in the
process, which the cell's engine writes on the clock the record's window
is on, and of it the spans that start in the window before its profiled
seconds (the last ``min(3, seconds / 3)`` s, where a traced run's
profiler inflates host time, as trace.py leaves them out). A program
without the log, or a log that does not hold the whole window, gives
nothing to read."""
from __future__ import annotations

from typing import Dict, List, Optional

PROFILE_S = 3.0


def profiled_start(record: dict) -> float:
    w1 = record["window"][1]
    return w1 - min(PROFILE_S, float(record["seconds"]) / 3.0)


def window(record: dict) -> Optional[List]:
    """The spans of the newest log that start in [window start, profiled
    seconds' start), or None."""
    try:
        from repro_torch.obs.spans import logs
    except ImportError:
        return None
    held = logs()
    if not held:
        return None
    log = held[-1]
    w0, w1 = record["window"]
    if not log.covers(w0, w1):
        return None
    p0 = profiled_start(record)
    return [s for s in log.spans() if w0 <= s.start < p0]


def calls(record: dict):
    """(prefill call spans in the window, their direct children by the
    call's sequence number), or None when there are none."""
    spans = window(record)
    if not spans:
        return None
    found = [s for s in spans if s.name == "engine.prefill_call"]
    if not found:
        return None
    kids: Dict[int, List] = {c.seq: [] for c in found}
    for s in spans:
        if s.parent in kids:
            kids[s.parent].append(s)
    return found, kids


def wall(spans) -> float:
    return float(sum(s.end - s.start for s in spans))


def part_share(record: dict, name: str) -> Optional[float]:
    """Seconds in the calls' `name` children over the calls' seconds."""
    got = calls(record)
    if got is None:
        return None
    found, kids = got
    total = wall(found)
    if total <= 0:
        return None
    return wall(k for c in found for k in kids[c.seq] if k.name == name) \
        / total
