"""The two decode readers, ``decode_live_share`` (the live rows over the
batch width of the window's ``engine.decode_block`` spans) and
``moe_slot_use`` (the counters ``moe.routed_slots`` over
``moe.expert_rows``): each on a log and record made by hand with a known
answer, silent where the program writes neither (the parent of the
change that added them), and both reading numbers on a traced run of a
CPU smoke moe cell that decodes."""
import json
import sys
import time

import pytest

from qoebench import registry, smoke


def _log():
    """Window [10, 20) of 10 s, profiled from 17: decode blocks at 9
    (before), 11 and 12 (in) and 18 (profiled); moe counters as a run's
    totals."""
    from repro_torch.obs.spans import SpanLog
    clock = [0.0]
    log = SpanLog(clock=lambda: clock[0])

    def block(t, j, rows, slots=None):
        clock[0] = t
        pay = {"j": j, "rows": rows}
        if slots is not None:
            pay["slots"] = slots
        k = log.begin("engine.decode_block", pay)
        clock[0] = t + 0.2
        log.end(k)

    block(9.0, 8, 2, 16)
    block(11.0, 4, 3, 16)
    block(12.0, 1, 8, 16)
    block(18.0, 8, 16, 16)
    log.count(("moe.routed_slots", 96), ("moe.expert_rows", 1440))
    clock[0] = 25.0
    return log, clock


def _record():
    return dict(window=[10.0, 20.0], seconds=10.0, requests=[])


def _read(name, record):
    return registry.metric(name).read(record)


def test_decode_readers_by_hand():
    log, _clock = _log()
    r = _record()
    # (4 * 3 + 1 * 8) live rows over (4 + 1) * 16 computed
    assert _read("decode_live_share", r) == pytest.approx(20 / 80)
    assert _read("moe_slot_use", r) == pytest.approx(96 / 1440)
    del log


def test_decode_readers_silent_where_nothing_is_written(monkeypatch):
    from repro_torch.obs import spans as spans_lib
    log, clock = _log()
    r = _record()
    clock[0] = 19.0                     # the window is not over
    assert _read("decode_live_share", r) is None
    log2 = spans_lib.SpanLog()          # the newest log holds no counters
    assert _read("moe_slot_use", r) is None
    del log2
    monkeypatch.setattr(spans_lib, "logs", lambda: [])
    assert _read("decode_live_share", r) is None
    assert _read("moe_slot_use", r) is None
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    assert _read("decode_live_share", r) is None
    assert _read("moe_slot_use", r) is None
    del log


def test_a_program_without_the_slots_payload_reads_nothing():
    """The decode block spans of a program older than the ``slots``
    payload: nothing to read."""
    from repro_torch.obs.spans import SpanLog
    clock = [11.0]
    log = SpanLog(clock=lambda: clock[0])
    k = log.begin("engine.decode_block", {"j": 2, "rows": 3})
    clock[0] = 11.5
    log.end(k)
    clock[0] = 25.0
    assert _read("decode_live_share", _record()) is None
    assert _read("moe_slot_use", _record()) is None
    del log


def test_both_read_on_a_traced_smoke_moe_run(tmp_path):
    """The smoke moe (4 experts, top-4) serving the chat mix of 64 clients
    cut to 4: one slot per live row and expert, so every expert row holds
    a routed slot; 4 of the engine's 8 slots hold a request at most."""
    from qoebench.cell import run_cell
    bench = smoke.write_base(tmp_path)
    mix = dict(registry.traffic("chat-closed-64"), clients=4, per_client=8,
               lead_in_s=0.0)
    (tmp_path / "traffic" / "chat-closed-64.json").write_text(
        json.dumps(mix))
    cell = "tiny-moe.chat-closed"
    (tmp_path / "cells" / f"{cell}.json").write_text(json.dumps(
        {"check": {"sample": 8, "preempted": 2,
                   "widest_gap_limit": smoke.LIMIT}}))
    bench["workloads"].append({"name": cell, "config": "tiny-moe",
                               "traffic": "chat-closed-64", "chips": 1,
                               "why": "smoke"})
    entry = registry.workload(bench, cell)
    result, _record = run_cell(bench, entry, 2**31 + 9, 6.0, True,
                               device="cpu", t_start=time.monotonic(),
                               base=tmp_path)
    got = result["metrics"]
    assert got["moe_slot_use"]["value"] == pytest.approx(1.0)
    assert 0.0 < got["decode_live_share"]["value"] <= 0.5
    assert result["correct"], result["checks"]
