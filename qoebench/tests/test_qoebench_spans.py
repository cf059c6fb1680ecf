"""The readers of the port's own span log (``program_spans.py`` and the
seven metrics over it): each on a log and record made by hand with a
known answer, silent with no log, with a program that has none and over
a window the log does not hold, and all reading numbers on a traced run
of the CPU smoke cell ``tiny-dense.score``."""
import sys
import time

import numpy as np
import pytest

from qoebench import registry, smoke
from qoebench.frozen.counts import prefill_flops

READERS = ("schedule_span_ms", "mfu.prefill_call", "prefill_wait_p95_s",
           "prefill_forward_share", "prefill_readback_share",
           "prefill_rows_per_call", "prefill_pad_share")


def _log():
    """Window [10, 20) of 10 s, so the profiled seconds start at 17:
    steps at 9 (before), 11 and 12 (in) and 18 (profiled); a call in
    each of the last three. The first call's host waits for the card
    in a sync outside any span, between its forward and its write (as
    the benchmark's traced run syncs); the second's in its readback."""
    from repro_torch.obs.spans import SpanLog
    clock = [0.0]
    log = SpanLog(clock=lambda: clock[0])

    def at(t, fn, *a):
        clock[0] = t
        return fn(*a)

    def step(t0, sched, t1, call=None):
        s = at(t0, log.begin, "engine.step")
        k = at(t0, log.begin, "engine.schedule")
        at(t0 + sched, log.end, k)
        if call is not None:
            c0, c1, pay, parts = call
            c = at(c0, log.begin, "engine.prefill_call", pay)
            for name, p0, p1 in parts:
                k = at(p0, log.begin, name)
                if name == "model.prefill":
                    f = at(p0, log.begin, "model.cache_fill")
                    at(p1, log.end, f)
                at(p1, log.end, k)
            at(c1, log.end, c)
        at(t1, log.end, s)

    step(9.0, 0.4, 9.5)
    step(11.0, 0.1, 11.5, (11.1, 11.4, dict(rids=(1,), lengths=(100,),
                                            rows=1, bucket=128),
                           [("prefill.stage", 11.1, 11.15),
                            ("model.prefill", 11.15, 11.30),
                            ("prefill.write", 11.33, 11.35),
                            ("prefill.readback", 11.35, 11.4)]))
    step(12.0, 0.3, 13.0, (12.3, 12.9, dict(rids=(2, 3), lengths=(50, 60),
                                            rows=2, bucket=64),
                           [("model.prefill", 12.3, 12.8),
                            ("prefill.readback", 12.8, 12.9)]))
    step(18.0, 0.5, 19.0, (18.5, 18.9, dict(rids=(9,), lengths=(7,),
                                            rows=1, bucket=16),
                           [("model.prefill", 18.5, 18.9)]))
    clock[0] = 25.0
    return log, clock


def _record():
    model = registry.config("granite-3-2b")["model"]
    reqs = [dict(rid=1, due=10.5, admit=10.6), dict(rid=2, due=10.8,
                                                    admit=11.0),
            dict(rid=3, due=11.0, admit=11.5),
            dict(rid=4, due=16.0, admit=16.5),     # no call by 17
            dict(rid=5, due=17.5, admit=17.6),     # admitted when profiled
            dict(rid=6, due=9.0, admit=9.1),       # due before the window
            dict(rid=7, due=12.0, admit=None)]     # never admitted
    return dict(window=[10.0, 20.0], seconds=10.0, model=model,
                requests=reqs)


def _read(name, record):
    return registry.metric(name).read(record)


def test_readers_by_hand():
    log, _clock = _log()
    r = _record()
    assert _read("schedule_span_ms", r) == pytest.approx(200.0)
    assert _read("prefill_forward_share", r) == pytest.approx(0.65 / 0.9)
    # (0.03 sync + 0.05 readback) + 0.1 readback; the write is host work
    assert _read("prefill_readback_share", r) == pytest.approx(0.18 / 0.9)
    assert _read("prefill_rows_per_call", r) == pytest.approx(1.5)
    assert _read("prefill_pad_share", r) == pytest.approx(1 - 210 / 256)
    flops = prefill_flops(r["model"], [100]) + \
        prefill_flops(r["model"], [50, 60])
    assert _read("mfu.prefill_call", r) == pytest.approx(
        100 * flops / 0.9 / 989e12)
    assert _read("prefill_wait_p95_s", r) == pytest.approx(
        float(np.percentile([0.5, 1.3, 0.8, 0.5], 95)))
    del log


def test_readers_silent_without_a_log_or_its_window(monkeypatch):
    from repro_torch.obs import spans as spans_lib
    log, clock = _log()
    r = _record()
    clock[0] = 19.0                     # the clock has not reached the end
    assert all(_read(n, r) is None for n in READERS)
    clock[0] = 25.0
    log.dropped_until = 10.5            # the ring lost part of the window
    assert all(_read(n, r) is None for n in READERS)
    log.dropped_until = 9.9
    assert all(_read(n, r) is not None for n in READERS)
    monkeypatch.setattr(spans_lib, "logs", lambda: [])
    assert all(_read(n, r) is None for n in READERS)
    monkeypatch.undo()
    # a program that has no span log (the parent of the change that
    # added it): the readers return nothing and do not raise
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    assert all(_read(n, r) is None for n in READERS)
    del log


def test_all_seven_read_on_a_traced_smoke_run(tmp_path):
    from qoebench.cell import run_cell
    bench = smoke.write_base(tmp_path)
    entry = registry.workload(bench, "tiny-dense.score")
    result, record = run_cell(bench, entry, 2**31 + 7, 6.0, True,
                              device="cpu", t_start=time.monotonic(),
                              base=tmp_path)
    got = result["metrics"]
    assert set(READERS) <= set(got), got
    assert got["prefill_rows_per_call"]["value"] == 1.0
    assert 0.0 < got["prefill_pad_share"]["value"] < 1.0
    assert 0.0 < got["prefill_forward_share"]["value"] < 1.0
    assert 0.0 < got["prefill_readback_share"]["value"] < 1.0
    assert got["prefill_wait_p95_s"]["value"] > 0.0
    assert got["schedule_span_ms"]["value"] > 0.0
    assert got["mfu.prefill_call"]["unit"] == "%"
    assert result["correct"], result["checks"]
