"""The port's discrete-event ``ServingSimulator`` against the reference.

The simulator is host code over the same floats, so on the same workload
(``repro_torch.workload`` and ``repro.workload`` give it bitwise, see
tests/test_torch_workload.py), the same LatencyModel and the same
scheduler, the port must reproduce the reference **bitwise**: per request
the emit times, preemptions, final QoE, TTFT and TDS, and the run's
makespan, token count, iterations and batch sizes. Covered: every
scheduler in ``SCHEDULERS`` in swap and in recompute mode under a KV
capacity that preempts, the swap-to-recompute fallback when host memory
is full, ``cancel`` of a pending, a running and a swapped request, and
the trace an observer records (equal JSONL). Then the checks of the
reference's ``tests/test_simulator.py`` that hold within the port.
"""
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.core import A100_4X as J_A100_4X
from repro.core import LatencyModel as JLat
from repro.core import SchedulerConfig as JSchedCfg
from repro.core import make_scheduler as j_make_scheduler
from repro.core.request import ReqState as JReqState
from repro.obs import TraceRecorder as JTraceRecorder
from repro.serving.simulator import ServingSimulator as JSim
from repro.serving.simulator import SimConfig as JSimConfig
from repro.workload import make_multitenant_workload as j_multitenant
from repro.workload import make_workload as j_make_workload
from repro_torch.configs import get_config
from repro_torch.core import (A100_4X, SCHEDULERS, LatencyModel,
                              SchedulerConfig, make_scheduler)
from repro_torch.obs import TraceRecorder
from repro_torch.serving import ServingSimulator, SimConfig
from repro_torch.serving.simulator import SimResult
from repro_torch.workload import make_multitenant_workload, make_workload

KV = 12_000          # tokens: tight enough that every scheduler preempts


def _sims(sched, kv=KV, **simkw):
    jlat = JLat(j_get_config("opt-66b"), J_A100_4X)
    lat = LatencyModel(get_config("opt-66b"), A100_4X)
    jsim = JSim(j_make_scheduler(sched, kv, jlat, JSchedCfg()), jlat,
                JSimConfig(kv_capacity_tokens=kv, **simkw))
    sim = ServingSimulator(make_scheduler(sched, kv, lat, SchedulerConfig()),
                           lat, SimConfig(kv_capacity_tokens=kv, **simkw))
    return jsim, sim


def _req_key(r):
    return (r.rid, r.tenant, r.state.name, r.generated,
            tuple(r.emit_times), r.preemptions, r.cancelled,
            r.finish_time if np.isfinite(r.finish_time) else None,
            r.final_qoe(), r.final_ttft(), r.final_tds())


def _result_key(res):
    return ([_req_key(r) for r in res.requests], res.makespan,
            res.total_tokens, res.preemptions, res.iterations,
            list(res.batch_sizes))


def _workloads(kind, n=80):
    if kind == "sharegpt":
        return (j_make_workload(n, 5.0, seed=1),
                make_workload(n, 5.0, seed=1))
    return (j_multitenant(n, 5.0, seed=2), make_multitenant_workload(
        n, 5.0, seed=2))


@pytest.mark.parametrize("mode", ["swap", "recompute"])
@pytest.mark.parametrize("sched", sorted(SCHEDULERS))
def test_simulator_bitwise(sched, mode):
    jsim, sim = _sims(sched, preemption_mode=mode)
    jwl, wl = _workloads("multitenant" if sched in ("vtc", "wsc")
                         else "sharegpt")
    jres, res = jsim.run(jwl), sim.run(wl)
    assert isinstance(res, SimResult)
    assert res.preemptions > 0, "the trace must preempt"
    assert _result_key(res) == _result_key(jres)
    assert res.avg_qoe() == jres.avg_qoe()
    assert res.throughput() == jres.throughput()
    np.testing.assert_array_equal(res.normalized_latencies(),
                                  jres.normalized_latencies())


def test_host_memory_full_falls_back_to_recompute():
    jsim, sim = _sims("andes", host_kv_capacity_tokens=2_000)
    jres, res = jsim.run(_workloads("sharegpt")[0]), \
        sim.run(_workloads("sharegpt")[1])
    assert _result_key(res) == _result_key(jres)
    assert sim.host_kv_used == jsim.host_kv_used == 0


def _pick(sim, state):
    if state == "pending":
        return sim.pending[-1].rid if sim.pending else None
    want = {"running": JReqState.RUNNING, "swapped": JReqState.SWAPPED}[state]
    rids = [r.rid for r in sim.live if r.state == want
            and (state != "running" or r.generated >= 2)]
    return min(rids) if rids else None


@pytest.mark.parametrize("state,mode", [
    ("pending", "swap"), ("pending", "recompute"), ("running", "swap"),
    ("running", "recompute"), ("swapped", "swap")])
def test_cancel_bitwise(state, mode):
    jsim, sim = _sims("andes", preemption_mode=mode)
    jwl, wl = _workloads("sharegpt", n=60)
    for a, b in zip(jwl, wl):
        jsim.submit(a)
        sim.submit(b)
    rid = _pick(jsim, state)
    while rid is None:
        assert jsim.step() and sim.step()
        rid = _pick(jsim, state)
    assert [(r.rid, r.state.name, r.generated) for r in sim.seen] == \
        [(r.rid, r.state.name, r.generated) for r in jsim.seen]
    host = sim.host_kv_used
    assert sim.cancel(rid) and jsim.cancel(rid)
    assert not sim.cancel(rid) and not sim.cancel(10_000)
    r = next(x for x in sim.seen if x.rid == rid)
    assert r.cancelled and r.state.name == "FINISHED"
    assert r not in sim.live and r not in sim.pending
    if state == "swapped":
        assert sim.host_kv_used == host - r.context_len
    while jsim.step():
        pass
    while sim.step():
        pass
    assert _result_key(sim.result()) == _result_key(jsim.result())


def test_observer_trace_bitwise():
    jsim, sim = _sims("andes")
    jrec, rec = JTraceRecorder(), TraceRecorder()
    jsim.attach_observer(jrec)
    sim.attach_observer(rec)
    events = []
    sim.event_sink = lambda kind, req, t, k: events.append(kind)
    assert sim.observer is rec and sim.sched.obs is sim.obs
    jwl, wl = _workloads("sharegpt", n=60)
    jsim.run(jwl)
    sim.run(wl)
    assert rec.to_jsonl() == jrec.to_jsonl()
    assert {"emit", "preempt", "finish"} <= set(events)


# ---------------------------------------------------------------------------
# the reference's checks, within the port
# ---------------------------------------------------------------------------

LAT = LatencyModel(get_config("opt-66b"), A100_4X)
M = 65_000


def _run(sched_name, rate, n=250, seed=1, m=M, **simkw):
    sim = ServingSimulator(make_scheduler(sched_name, m, LAT,
                                          SchedulerConfig()),
                           LAT, SimConfig(kv_capacity_tokens=m, **simkw))
    return sim.run(make_workload(n, rate, seed=seed))


def test_all_requests_complete():
    res = _run("fcfs", 2.0)
    assert all(r.generated >= r.output_len for r in res.requests)
    assert res.total_tokens == sum(r.output_len for r in res.requests)


@pytest.mark.parametrize("sched", ["fcfs", "andes"])
def test_underload_everyone_perfect(sched):
    assert _run(sched, 0.5).avg_qoe() > 0.98


def test_emit_monotone_and_counts():
    for r in _run("andes", 3.0).requests:
        assert len(r.emit_times) == r.generated
        assert all(b >= a for a, b in zip(r.emit_times, r.emit_times[1:]))


def test_memory_never_exceeded():
    sched = make_scheduler("andes", 20_000, LAT, SchedulerConfig())
    sim = ServingSimulator(sched, LAT, SimConfig(kv_capacity_tokens=20_000))
    orig, peaks = sched.schedule, []

    def wrapped(now, live, fluid):
        out = orig(now, live, fluid)
        peaks.append(sum(r.kv_tokens() for r in out))
        return out
    sched.schedule = wrapped
    sim.run(make_workload(150, 3.5, seed=2))
    assert max(peaks) <= 20_000


def test_recompute_mode_runs():
    res = _run("andes", 5.0, n=150, m=25_000, preemption_mode="recompute")
    assert all(r.generated >= r.output_len for r in res.requests)


def test_round_robin_rotates():
    assert _run("round_robin", 5.0, n=300, m=25_000).preemptions > 0
