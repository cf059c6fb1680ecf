"""The port's cluster layer (``repro_torch.cluster``) against the reference.

A simulator-backed ``ClusterSimulator`` is host code over the same
floats, so on the same workload and LatencyModels the port must equal
the reference **bitwise**: the admitted and the shed rids in decision
order, each replica's requests and per-request timelines (emit times,
preemptions, QoE), the defer count, the scale events with the signal
that drove each, the peak fleet size and the makespan. Covered: the
three routers, admission off / shed / defer, the autoscaler off and on
(including a fleet that drains to zero), a heterogeneous fleet, a
contracted multi-tenant mix and ``mixed_backends``. The trace events
recorded by each side's ``TraceRecorder`` through ``ServingClient`` must
be equal as JSONL. Then the invariants of the reference's
``tests/test_cluster.py`` that hold within the port, such as a 1-replica
cluster ≡ the bare simulator.
"""
import copy

import numpy as np
import pytest

from repro.api import ServingClient as JClient
from repro.cluster import AdmissionConfig as JAdmission
from repro.cluster import AutoscalerConfig as JAutoscaler
from repro.cluster import ClusterConfig as JClusterConfig
from repro.cluster import ClusterSimulator as JCluster
from repro.cluster import mixed_backends as j_mixed
from repro.cluster import simulator_backend as j_sim_backend
from repro.configs import get_config as j_get_config
from repro.core import A40_4X as J_A40_4X
from repro.core import A100_4X as J_A100_4X
from repro.core import LatencyModel as JLat
from repro.obs import TraceRecorder as JTraceRecorder
from repro.serving.simulator import ServingSimulator as JSim
from repro.serving.simulator import SimConfig as JSimConfig
import repro.workload as jw
from repro_torch.api import ServingClient
from repro_torch.cluster import (ROUTERS, AdmissionConfig, AutoscalerConfig,
                                 ClusterConfig, ClusterResult,
                                 ClusterSimulator, JSQRouter,
                                 QoEAwareRouter, Replica, RoundRobinRouter,
                                 SteppableBackend, marginal_qoe_gain,
                                 mixed_backends, simulator_backend)
from repro_torch.cluster.router import (RouterConfig, capability,
                                        normalized_queue, shared_token_rate)
from repro_torch.configs import get_config
from repro_torch.core import (A40_4X, A100_4X, LatencyModel, QoESpec,
                              SchedulerConfig, make_scheduler)
from repro_torch.core.request import Request
from repro_torch.obs import TraceRecorder
from repro_torch.serving import ServingSimulator, SimConfig
import repro_torch.workload as tw

LAT = LatencyModel(get_config("opt-66b"), A100_4X)
LAT_SLOW = LatencyModel(get_config("opt-66b"), A40_4X)
J_LAT = JLat(j_get_config("opt-66b"), J_A100_4X)
J_LAT_SLOW = JLat(j_get_config("opt-66b"), J_A40_4X)
M = 65_000


# ---------------------------------------------------------------------------
# the port against the reference, bitwise
# ---------------------------------------------------------------------------

def _req_key(r):
    return (r.rid, r.tenant, r.state.name, r.generated,
            tuple(r.emit_times), r.preemptions, r.final_qoe())


def _cluster_key(res):
    return dict(
        admitted=[r.rid for r in res.admitted],
        shed=[r.rid for r in res.shed],
        shed_emits=[tuple(r.emit_times) for r in res.shed],
        defers=res.n_defer_events,
        makespan=res.makespan,
        replicas={rid: ([_req_key(r) for r in rr.requests], rr.makespan,
                        rr.total_tokens, rr.preemptions, rr.iterations,
                        list(rr.batch_sizes))
                  for rid, rr in res.replica_results.items()},
        scale=[(e.t, e.action, e.replica_id, e.signal)
               for e in res.scale_events],
        peak=res.peak_replicas,
        qoe=(res.avg_qoe(), res.avg_qoe(include_shed=False),
             res.slo_attainment(), res.contract_attainment()),
    )


def _recompute_sim(mod):
    """A second simulator factory for mixed fleets: recompute preemption."""
    sim, cfg = ((ServingSimulator, SimConfig) if mod == "port"
                else (JSim, JSimConfig))

    def factory(replica_id, scheduler, lat, cluster_cfg):
        return sim(scheduler, lat, cfg(
            kv_capacity_tokens=cluster_cfg.kv_capacity_tokens,
            preemption_mode="recompute"))
    return factory


def _configs(case):
    """The case as (reference ClusterConfig, port ClusterConfig)."""
    kw = dict(case)
    adm = kw.pop("admission", None)
    auto = kw.pop("autoscaler", None)
    mix = kw.pop("mixed", False)
    j, t = dict(kw), dict(kw)
    if adm:
        j["admission"], t["admission"] = JAdmission(**adm), \
            AdmissionConfig(**adm)
    if auto:
        j["autoscaler"], t["autoscaler"] = JAutoscaler(**auto), \
            AutoscalerConfig(**auto)
    if mix:
        j["backend_factory"] = j_mixed([j_sim_backend, _recompute_sim("ref")])
        t["backend_factory"] = mixed_backends([simulator_backend,
                                               _recompute_sim("port")])
    return JClusterConfig(**j), ClusterConfig(**t)


SURGE = dict(n_replicas=2, kv_capacity_tokens=6_000)
SCALE = dict(min_replicas=1, max_replicas=4, provision_delay=5.0,
             cooldown=10.0, window=15.0)
CASES = {
    "rr": dict(router="round_robin", **SURGE),
    "jsq": dict(router="jsq", **SURGE),
    "qoe": dict(router="qoe", **SURGE),
    "qoe-3rep-fcfs": dict(router="qoe", n_replicas=3, scheduler="fcfs",
                          kv_capacity_tokens=10_000),
    "rr-shed": dict(router="round_robin", admission=dict(policy="shed"),
                    **SURGE),
    "qoe-shed": dict(router="qoe", admission=dict(policy="shed"), **SURGE),
    "qoe-defer": dict(router="qoe", admission=dict(policy="defer"),
                      **SURGE),
    "jsq-defer-recompute": dict(router="jsq", preemption_mode="recompute",
                                admission=dict(policy="defer",
                                               min_gain=0.2), **SURGE),
    "qoe-autoscale": dict(router="qoe", n_replicas=1,
                          kv_capacity_tokens=6_000, autoscaler=SCALE),
    "qoe-autoscale-shed": dict(router="qoe", n_replicas=1,
                               kv_capacity_tokens=6_000, autoscaler=SCALE,
                               admission=dict(policy="shed")),
    "rr-mixed": dict(router="round_robin", mixed=True, **SURGE),
    "qoe-mixed-shed": dict(router="qoe", mixed=True,
                           admission=dict(policy="shed"), **SURGE),
}


def _trace(mod, n=100, rate=12.0, seed=2):
    return mod.make_workload(n, rate, seed=seed, arrival="gamma", cv=3.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cluster_bitwise(case):
    jcfg, cfg = _configs(CASES[case])
    jres = JCluster(J_LAT, jcfg).run(_trace(jw))
    res = ClusterSimulator(LAT, cfg).run(_trace(tw))
    assert isinstance(res, ClusterResult)
    key = _cluster_key(res)
    assert key == _cluster_key(jres)
    if "shed" in case:
        assert key["shed"], "the surge must shed"
    if "defer" in case:
        assert key["defers"] > 0
    if "autoscale" in case:
        assert key["peak"] > 1 and key["scale"]
    assert res.per_tenant_avg_qoe() == jres.per_tenant_avg_qoe()
    np.testing.assert_array_equal(res.ttfts(), jres.ttfts())


def test_heterogeneous_fleet_bitwise():
    """lat as a sequence: replica i runs on lat[i % len(lat)]."""
    kw = dict(n_replicas=3, router="qoe", kv_capacity_tokens=10_000)
    jres = JCluster([J_LAT, J_LAT_SLOW], JClusterConfig(**kw)).run(
        _trace(jw))
    res = ClusterSimulator([LAT, LAT_SLOW], ClusterConfig(**kw)).run(
        _trace(tw))
    assert _cluster_key(res) == _cluster_key(jres)


def test_contracted_tenants_bitwise():
    """SLO contracts priced through routing, admission and attainment."""
    mix = [dict(name="gold", share=0.4, weight=4.0, qoe_floor=0.95),
           dict(name="scrap", share=0.6, weight=0.25)]
    kw = dict(n_replicas=2, router="qoe", kv_capacity_tokens=6_000)
    jres = JCluster(J_LAT, JClusterConfig(
        **kw, admission=JAdmission(policy="shed"))).run(
        jw.make_multitenant_workload(
            100, 20.0, seed=4, tenants=[jw.TenantSpec(**t) for t in mix]))
    res = ClusterSimulator(LAT, ClusterConfig(
        **kw, admission=AdmissionConfig(policy="shed"))).run(
        tw.make_multitenant_workload(
            100, 20.0, seed=4, tenants=[tw.TenantSpec(**t) for t in mix]))
    key = _cluster_key(res)
    assert key == _cluster_key(jres) and key["shed"]
    assert res.per_tenant_attainment() == jres.per_tenant_attainment()


def test_fleet_scaled_to_zero_recovers_bitwise():
    auto = dict(min_replicas=0, max_replicas=2, provision_delay=1.0,
                cooldown=5.0, window=10.0)

    def trace(mod):
        late = mod.make_workload(5, 2.0, seed=2)
        for r in late:
            r.rid += 100
            r.arrival += 500.0
        return mod.make_workload(20, 2.0, seed=1) + late
    kw = dict(n_replicas=1, router="qoe", kv_capacity_tokens=M)
    jres = JCluster(J_LAT, JClusterConfig(
        **kw, autoscaler=JAutoscaler(**auto))).run(trace(jw))
    res = ClusterSimulator(LAT, ClusterConfig(
        **kw, autoscaler=AutoscalerConfig(**auto))).run(trace(tw))
    assert _cluster_key(res) == _cluster_key(jres)
    assert len(res.admitted) == 25
    assert any(e.action == "reap" for e in res.scale_events)


@pytest.mark.parametrize("case", ["qoe-defer", "qoe-autoscale-shed",
                                  "rr-mixed"])
def test_client_trace_events_bitwise(case):
    """The events each side's TraceRecorder sees through ServingClient
    (fleet route / admission / scale decisions and replica-scoped
    lifecycle events) are equal as JSONL, and the client's streams equal
    driving the cluster directly."""
    jcfg, cfg = _configs(CASES[case])
    jrec, rec = JTraceRecorder(), TraceRecorder()
    jcluster, cluster = JCluster(J_LAT, jcfg), ClusterSimulator(LAT, cfg)
    jcluster.attach_observer(jrec)
    cluster.attach_observer(rec)
    jclient, client = JClient(jcluster), ServingClient(cluster)
    jh = [jclient.submit_request(r) for r in _trace(jw, n=60)]
    th = [client.submit_request(r) for r in _trace(tw, n=60)]
    jclient.drain()
    client.drain()
    assert rec.to_jsonl() == jrec.to_jsonl()
    kinds = {e.kind for e in rec.events}
    assert {"route", "admission", "emit", "finish"} <= kinds
    direct = ClusterSimulator(LAT, _configs(CASES[case])[1]).run(
        _trace(tw, n=60))
    d = {r.rid: r for r in direct.admitted + direct.shed}
    for a, b in zip(th, jh):
        assert a.rid == b.rid and a.shed == b.shed
        assert a.request.emit_times == b.request.emit_times \
            == d[a.rid].emit_times
        assert a.qoe() == b.qoe()
    assert client.avg_qoe() == jclient.avg_qoe()


# ---------------------------------------------------------------------------
# the reference's invariants, within the port
# ---------------------------------------------------------------------------

def make_replica(rid, lat=LAT, kv=M, scheduler="andes"):
    sched = make_scheduler(scheduler, kv, lat, SchedulerConfig())
    sim = ServingSimulator(sched, lat, SimConfig(kv_capacity_tokens=kv))
    return Replica(rid, sim, lat)


def req(rid, arrival=0.0, prompt=200, out=200, tds=4.8, ttft=1.0, tenant=0):
    return Request(rid=rid, arrival=arrival, prompt_len=prompt,
                   output_len=out, spec=QoESpec(ttft=ttft, tds=tds),
                   tenant=tenant)


def test_simulator_is_a_steppable_backend():
    assert isinstance(make_replica(0).backend, SteppableBackend)
    assert sorted(ROUTERS) == ["jsq", "qoe", "round_robin"]


@pytest.mark.parametrize("scheduler", ["andes", "fcfs"])
@pytest.mark.parametrize("router", ["round_robin", "qoe"])
def test_one_replica_cluster_matches_single_node(scheduler, router):
    wl = tw.make_workload(120, 3.0, seed=7, arrival="gamma")
    single = ServingSimulator(
        make_scheduler(scheduler, M, LAT, SchedulerConfig()), LAT,
        SimConfig(kv_capacity_tokens=M)).run(copy.deepcopy(wl))
    cluster = ClusterSimulator(LAT, ClusterConfig(
        n_replicas=1, router=router, scheduler=scheduler,
        kv_capacity_tokens=M)).run(copy.deepcopy(wl))
    assert len(cluster.shed) == 0
    s = {r.rid: r for r in single.requests}
    c = {r.rid: r for r in cluster.admitted}
    assert set(s) == set(c)
    for rid in s:
        assert s[rid].emit_times == c[rid].emit_times
        assert s[rid].preemptions == c[rid].preemptions


def test_routers_units():
    reps = [make_replica(i) for i in range(3)]
    rr = RoundRobinRouter()
    assert [rr.route(req(i), reps, 0.0).replica.id
            for i in range(6)] == [0, 1, 2, 0, 1, 2]
    assert JSQRouter().route(req(0), reps, 0.0).replica.id == 0
    assert QoEAwareRouter().route(req(0), reps, 0.0).replica.id == 0
    reps[0].submit(req(0))
    assert JSQRouter().route(req(1), reps[:2], 0.0).replica.id == 1


def test_qoe_router_memory_and_capability_aware():
    reps = [make_replica(0, kv=8_000), make_replica(1, kv=8_000)]
    for i in range(40):
        reps[0].submit(req(i, prompt=800))
    decision = QoEAwareRouter().route(req(99), reps, 0.0)
    assert decision.replica.id == 1
    assert decision.scores[0] < decision.scores[1]
    fast, slow = make_replica(0, lat=LAT), make_replica(1, lat=LAT_SLOW)
    assert capability(fast) > capability(slow)
    for i in range(6):
        fast.submit(req(i))
        slow.submit(req(10 + i))
    assert normalized_queue(slow) > normalized_queue(fast)
    assert QoEAwareRouter().route(req(99), [fast, slow], 0.0).replica.id == 0


def test_marginal_gain_and_shared_rate():
    idle, full = make_replica(0, kv=8_000), make_replica(1, kv=8_000)
    for i in range(60):
        full.submit(req(i, prompt=800))
    cfg = RouterConfig()
    g_idle = marginal_qoe_gain(idle, req(99), 0.0, cfg)
    assert g_idle == pytest.approx(1.0, abs=0.05)
    assert marginal_qoe_gain(full, req(99), 0.0, cfg) < g_idle - 0.5
    aged = marginal_qoe_gain(idle, req(1, arrival=0.0), 10.0, cfg)
    assert aged < g_idle - 0.1
    assert shared_token_rate(LAT, 100, 100 * 400, kv_capacity=10_000) < \
        shared_token_rate(LAT, 10, 10 * 400, kv_capacity=100_000)
    assert shared_token_rate(LAT, 0, 0, 10_000) == 0.0


def test_router_does_not_mutate_replica_fluid_state():
    rep = make_replica(0)
    rep.submit(req(0))
    for _ in range(5):
        rep.step()
    before = {f: getattr(rep.fluid, f).copy() for f in rep.fluid.FIELDS}
    QoEAwareRouter().route(req(1, arrival=rep.clock), [rep], rep.clock)
    for f, arr in before.items():
        np.testing.assert_array_equal(arr, getattr(rep.fluid, f))


def test_admission_none_admits_and_underload_sheds_nothing():
    res = ClusterSimulator(LAT, ClusterConfig(
        n_replicas=2, router="qoe", kv_capacity_tokens=10_000)).run(
        tw.make_workload(120, 18.0, seed=2, arrival="gamma", cv=3.0))
    assert len(res.shed) == 0 and res.n_defer_events == 0
    assert len(res.admitted) == 120
    res = ClusterSimulator(LAT, ClusterConfig(
        n_replicas=2, router="qoe", kv_capacity_tokens=M,
        admission=AdmissionConfig(policy="shed"))).run(
        tw.make_workload(60, 0.5, seed=1, arrival="gamma", cv=3.0))
    assert len(res.shed) == 0 and res.avg_qoe() > 0.97


def test_autoscaler_scales_up_and_loses_nothing():
    res = ClusterSimulator(LAT, ClusterConfig(
        n_replicas=1, router="qoe", kv_capacity_tokens=15_000,
        autoscaler=AutoscalerConfig(**SCALE))).run(
        tw.make_workload(120, 8.0, seed=2, arrival="gamma", cv=3.0))
    assert res.peak_replicas > 1
    assert any(e.action == "scale_up" for e in res.scale_events)
    assert all(r.generated >= r.output_len for r in res.admitted)
    assert sum(len(rr.requests) for rr in res.replica_results.values()) \
        == len(res.admitted)


def test_autoscaler_bounds_and_fixed_fleet():
    res = ClusterSimulator(LAT, ClusterConfig(
        n_replicas=1, router="qoe", kv_capacity_tokens=8_000,
        autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=2,
                                    provision_delay=1.0, cooldown=2.0,
                                    window=10.0))).run(
        tw.make_workload(100, 12.0, seed=3, arrival="gamma", cv=3.0))
    assert res.peak_replicas <= 2
    res = ClusterSimulator(LAT, ClusterConfig(
        n_replicas=1, router="qoe", kv_capacity_tokens=15_000,
        autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=8,
                                    provision_delay=10_000.0, cooldown=5.0,
                                    window=10.0))).run(
        tw.make_workload(80, 8.0, seed=2, arrival="gamma", cv=3.0))
    assert res.peak_replicas == 1
    res = ClusterSimulator(LAT, ClusterConfig(
        n_replicas=2, router="jsq", kv_capacity_tokens=M)).run(
        tw.make_workload(50, 2.0, seed=1))
    assert res.scale_events == [] and res.peak_replicas == 2


@pytest.mark.parametrize("charge_overhead", [False, True])
def test_unschedulable_request_halts_instead_of_hanging(charge_overhead):
    kv = 1_000
    sim = ServingSimulator(make_scheduler("andes", kv, LAT, SchedulerConfig()),
                           LAT, SimConfig(kv_capacity_tokens=kv,
                                          charge_scheduler_overhead=
                                          charge_overhead))
    rep = Replica(0, sim, LAT)
    rep.submit(req(0, prompt=2_000, out=50))
    rep.submit(req(1, arrival=0.1, prompt=200, out=20))
    steps = 0
    while rep.step():
        steps += 1
        assert steps < 10_000, "simulator failed to terminate"
    by_rid = {r.rid: r for r in rep.result().requests}
    assert by_rid[1].generated >= 20
    assert by_rid[0].generated == 0 and by_rid[0].final_qoe() == 0.0
    # a deadlock is transient: a later schedulable submit resumes service
    rep2 = make_replica(0, kv=1_000)
    rep2.submit(req(0, prompt=2_000, out=50))
    while rep2.step():
        pass
    assert rep2.backend.stuck
    rep2.submit(req(1, arrival=rep2.clock + 1.0, prompt=200, out=20))
    while rep2.step():
        pass
    assert {r.rid: r for r in rep2.result().requests}[1].generated >= 20


def test_config_and_draining_errors():
    with pytest.raises(ValueError):
        ClusterSimulator(LAT, ClusterConfig(n_replicas=0))
    with pytest.raises(ValueError):
        ClusterSimulator([], ClusterConfig(n_replicas=1))
    with pytest.raises(ValueError):
        mixed_backends([])
    rep = make_replica(0)
    rep.drain()
    with pytest.raises(RuntimeError):
        rep.submit(req(0))
    assert rep.drained
