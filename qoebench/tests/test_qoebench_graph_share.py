"""The reader of ``prefill_graph_share``: the share of the window's
prefill calls whose ``model.prefill`` child carries the graph flag, on a
log made by hand with a known answer, silent on a program whose
``model.prefill`` carries no flag (the parent of the change that added
it), and reading 0 on a traced run of the CPU smoke cell, where every
forward runs eagerly."""
import time

import pytest

from qoebench import registry, smoke


def _log(flags):
    """Window [10, 20), profiled from 17: one call a second from 11 with
    each `flags` payload on its ``model.prefill`` (None: no payload),
    and one more call in the profiled seconds, replayed."""
    from repro_torch.obs.spans import SpanLog
    clock = [0.0]
    log = SpanLog(clock=lambda: clock[0])

    def call(t, pay):
        clock[0] = t
        c = log.begin("engine.prefill_call",
                      dict(rids=(1,), lengths=(9,), rows=1, bucket=16))
        f = log.begin("model.prefill", pay)
        clock[0] = t + 0.2
        log.end(f)
        log.end(c)

    for i, flag in enumerate(flags):
        call(11.0 + i, None if flag is None else {"graph": flag})
    call(18.0, {"graph": 1})
    clock[0] = 25.0
    return log


def _read(record):
    return registry.metric("prefill_graph_share").read(record)


def _record():
    return dict(window=[10.0, 20.0], seconds=10.0)


@pytest.mark.parametrize("flags,share", [
    ((1, 0, 1), 2 / 3), ((1, 1, 1, 1), 1.0), ((0, 0), 0.0),
    ((None, None), None)])
def test_share_of_replayed_calls_by_hand(flags, share):
    log = _log(flags)
    got = _read(_record())
    assert got == (None if share is None else pytest.approx(share))
    del log


def test_reads_zero_on_a_traced_cpu_smoke_run(tmp_path):
    from qoebench.cell import run_cell
    bench = smoke.write_base(tmp_path)
    entry = registry.workload(bench, "tiny-dense.score")
    result, _record = run_cell(bench, entry, 2**31 + 11, 6.0, True,
                               device="cpu", t_start=time.monotonic(),
                               base=tmp_path)
    got = result["metrics"]
    assert got["prefill_graph_share"] == {"value": 0.0, "unit": "ratio"}
    assert result["correct"], result["checks"]
