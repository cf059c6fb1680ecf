"""Engine-backed cluster replicas in the port, against the reference (CPU).

``repro_torch.cluster.engine_backend`` builds the port's ``ServingEngine``
per replica over one shared ``(model, params)``. On smoke ``granite-3-2b``
(the reference's own choice for this check) and smoke ``llama3-8b``, f32,
weights bridged from the reference's (``bridge.from_numpy``), the
``TPU_V5E`` virtual clock:

1. a 1-replica engine-backed cluster equals the bare port engine bit for
   bit — tokens and ``timing_fingerprint`` — the cluster adds decisions
   around the engine, never inside it;
2. a 2-replica engine-backed cluster in the port gives, per replica, the
   reference engine-backed cluster's ``timing_fingerprint`` identically,
   with tokens identical except for flips that ``audit_flips`` (the JAX
   model as referee) classes as documented near-ties — also on
   token-less requests, whose prompts each engine synthesizes from the
   rid, and under a capacity that makes the replicas preempt;
3. sim-vs-engine agreement per replica inside a fleet (the reference's
   ``tests/test_sim_vs_engine.py`` tolerances), within the port;
4. a mixed fleet (an engine replica 0, simulator replicas after it)
   serves a shared trace to the end.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.cluster import ClusterConfig as JClusterConfig
from repro.cluster import ClusterSimulator as JCluster
from repro.cluster import engine_backend as j_engine_backend
from repro.configs import get_smoke_config as j_smoke
from repro.core import LatencyModel as JLat
from repro.core import QoESpec as JSpec
from repro.core import SchedulerConfig as JSchedCfg
from repro.core import TPU_V5E as J_TPU_V5E
from repro.models import Model as JModel
from repro.serving import Request as JRequest
from repro.serving import all_flips_documented, audit_flips
from repro.serving import timing_fingerprint as j_timing
from repro_torch.bridge import from_numpy
from repro_torch.cluster import (ClusterConfig, ClusterSimulator,
                                 SteppableBackend, engine_backend,
                                 mixed_backends, simulator_backend)
from repro_torch.configs import get_smoke_config
from repro_torch.core import (TPU_V5E, LatencyModel, QoESpec,
                              SchedulerConfig, make_scheduler)
from repro_torch.models import Model
from repro_torch.serving import (Request, ServingEngine, ServingSimulator,
                                 timing_fingerprint)

torch.set_num_threads(1)
NUM_SLOTS = 8
MAX_SEQ = 64
CAP = NUM_SLOTS * MAX_SEQ
TIGHT = 60           # tokens per replica: the 2-replica fleet preempts
_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        cfg = j_smoke(arch)
        jm = JModel(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = Model(get_smoke_config(arch), device="cpu")
        tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[arch] = (cfg, jm, jp, tm, tp)
    return _MODELS[arch]


def _trace(make, spec, vocab, seed=0, n=10, out_len=10, stagger=0.2,
           tokens=True, plen_range=(8, 24)):
    rng = np.random.default_rng(seed)
    wl = []
    for i in range(n):
        plen = int(rng.integers(*plen_range))
        toks = rng.integers(0, vocab, plen)
        wl.append(make(rid=i, arrival=i * stagger, prompt_len=plen,
                       output_len=out_len, spec=spec(ttft=1.0, tds=4.8),
                       prompt_tokens=toks if tokens else None))
    return wl


def _port_cluster(arch, *, n_replicas=1, router="round_robin",
                  scheduler="andes", cap=CAP, delta_t=None):
    _, _, _, tm, tp = _models(arch)
    lat = LatencyModel(tm.cfg, TPU_V5E)
    return ClusterSimulator(lat, ClusterConfig(
        n_replicas=n_replicas, router=router, scheduler=scheduler,
        kv_capacity_tokens=cap,
        sched_cfg=SchedulerConfig(delta_t=delta_t) if delta_t else None,
        backend_factory=engine_backend(tm, tp, num_slots=NUM_SLOTS,
                                       max_seq=MAX_SEQ, capacity_tokens=cap,
                                       device="cpu", reference_decode=True)))


def _ref_cluster(arch, *, n_replicas=1, router="round_robin",
                 scheduler="andes", cap=CAP, delta_t=None):
    cfg, jm, jp, _, _ = _models(arch)
    lat = JLat(cfg, J_TPU_V5E)
    return JCluster(lat, JClusterConfig(
        n_replicas=n_replicas, router=router, scheduler=scheduler,
        kv_capacity_tokens=cap,
        sched_cfg=JSchedCfg(delta_t=delta_t) if delta_t else None,
        backend_factory=j_engine_backend(jm, jp, num_slots=NUM_SLOTS,
                                         max_seq=MAX_SEQ,
                                         capacity_tokens=cap)))


# ---------------------------------------------------------------------------
# 1. 1-replica invariance: routed port engine ≡ bare port engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-3-2b", "llama3-8b"])
def test_one_replica_engine_cluster_matches_bare_engine(arch):
    cfg, _, _, tm, tp = _models(arch)
    lat = LatencyModel(tm.cfg, TPU_V5E)
    wl = _trace(Request, QoESpec, cfg.vocab_size)
    bare = ServingEngine(tm, tp, make_scheduler("andes", CAP, lat,
                                                SchedulerConfig()),
                         lat, num_slots=NUM_SLOTS, max_seq=MAX_SEQ,
                         capacity_tokens=CAP, device="cpu",
                         reference_decode=True)
    out_bare = bare.run([r.clone() for r in wl], max_iterations=2000)
    cs = _port_cluster(arch)
    assert isinstance(cs.replicas[0].backend, ServingEngine)
    assert isinstance(cs.replicas[0].backend, SteppableBackend)
    res = cs.run([r.clone() for r in wl])
    assert len(res.shed) == 0 and len(res.admitted) == len(wl)
    routed = sorted(res.admitted, key=lambda r: r.rid)
    assert [r.output_tokens for r in routed] == \
        [r.output_tokens for r in out_bare]
    assert timing_fingerprint(routed) == timing_fingerprint(out_bare)
    assert all(r.generated == r.output_len for r in routed)


# ---------------------------------------------------------------------------
# 2. the port's engine-backed fleet against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,router,tight,tokens", [
    ("granite-3-2b", "round_robin", False, True),
    ("llama3-8b", "qoe", True, True),
    ("llama3-8b", "round_robin", False, False),
], ids=["granite-rr", "llama3-qoe-tight", "llama3-rr-tokenless"])
def test_two_replica_engine_cluster_matches_reference(arch, router, tight,
                                                      tokens):
    cfg, jm, jp, _, _ = _models(arch)
    kw = dict(n=12, out_len=12, stagger=0.1, tokens=tokens)
    fleet = dict(n_replicas=2, router=router)
    if tight:    # the engine tests' preempting trace over a small capacity
        kw.update(out_len=14, stagger=0.01, plen_range=(5, 30))
        fleet.update(cap=TIGHT, delta_t=2.0)
    jwl = _trace(JRequest, JSpec, cfg.vocab_size, seed=1, **kw)
    twl = _trace(Request, QoESpec, cfg.vocab_size, seed=1, **kw)
    jres = _ref_cluster(arch, **fleet).run(jwl)
    res = _port_cluster(arch, **fleet).run(twl)
    assert res.replica_results.keys() == jres.replica_results.keys() \
        == {0, 1}
    for rid, rr in res.replica_results.items():
        jr = jres.replica_results[rid].requests
        assert rr.requests, rid
        assert timing_fingerprint(rr.requests) == j_timing(jr), rid
        assert (rr.iterations, rr.batch_sizes, rr.preemptions) == \
            (jres.replica_results[rid].iterations,
             jres.replica_results[rid].batch_sizes,
             jres.replica_results[rid].preemptions), rid
        for a, b in zip(rr.requests, jr):
            np.testing.assert_array_equal(a.prompt_tokens, b.prompt_tokens)
        flips = audit_flips(jm, jp, jr, rr.requests)
        assert all_flips_documented(flips), (rid, flips)
    if tight:
        assert all(rr.preemptions for rr in res.replica_results.values()), \
            "every replica of the tight fleet must preempt"
    assert all(r.generated == r.output_len for r in res.admitted)


# ---------------------------------------------------------------------------
# 3. sim-vs-engine per replica inside a fleet, within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_sim_vs_engine_per_replica(seed):
    cfg, _, _, tm, _ = _models("llama3-8b")
    lat = LatencyModel(tm.cfg, TPU_V5E)
    wl = _trace(Request, QoESpec, cfg.vocab_size, seed=seed, n=12,
                out_len=12)
    common = dict(n_replicas=2, router="round_robin", scheduler="andes",
                  kv_capacity_tokens=CAP)
    res_sim = ClusterSimulator(lat, ClusterConfig(**common)).run(
        [r.clone() for r in wl])
    res_eng = _port_cluster("llama3-8b", n_replicas=2).run(
        [r.clone() for r in wl])
    assert res_sim.replica_results.keys() == res_eng.replica_results.keys()
    for rid in res_sim.replica_results:
        per_sim = res_sim.replica_results[rid].requests
        per_eng = res_eng.replica_results[rid].requests
        assert [r.rid for r in per_sim] == [r.rid for r in per_eng], rid
        assert per_sim, rid
        for re_, rs in zip(per_eng, per_sim):
            assert re_.generated == rs.generated, (rid, re_.rid)
            te, ts = re_.final_ttft(), rs.final_ttft()
            assert abs(te - ts) < max(0.05, 0.2 * ts), (rid, re_.rid, te, ts)
            qe, qs = re_.final_qoe(), rs.final_qoe()
            assert abs(qe - qs) < 0.1, (rid, re_.rid, qe, qs)


# ---------------------------------------------------------------------------
# 4. mixed fleets, capacity alignment, load views, device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("router", ["round_robin", "qoe"])
def test_mixed_sim_engine_fleet_serves_to_completion(router):
    cfg, _, _, tm, tp = _models("granite-3-2b")
    lat = LatencyModel(tm.cfg, TPU_V5E)
    wl = _trace(Request, QoESpec, cfg.vocab_size, seed=1, n=14, out_len=8,
                stagger=0.1)
    cs = ClusterSimulator(lat, ClusterConfig(
        n_replicas=3, router=router, kv_capacity_tokens=CAP,
        backend_factory=mixed_backends([
            engine_backend(tm, tp, num_slots=NUM_SLOTS, max_seq=MAX_SEQ,
                           capacity_tokens=CAP, device="cpu"),
            simulator_backend, simulator_backend])))
    kinds = [type(rep.backend) for rep in cs.replicas]
    assert kinds == [ServingEngine, ServingSimulator, ServingSimulator]
    res = cs.run([r.clone() for r in wl])
    assert len(res.shed) == 0
    assert all(r.generated >= r.output_len for r in res.admitted)
    served = {rid: len(r.requests) for rid, r in res.replica_results.items()}
    if router == "round_robin":
        assert all(n > 0 for n in served.values()), served
    assert sum(served.values()) == len(wl)
    q = res.qoes()
    assert q.size == len(wl) and (q >= 0).all() and (q <= 1).all()
    # the engine replica emits real tokens; the simulator replicas do not
    assert all(len(r.output_tokens) == r.generated
               for r in res.replica_results[0].requests)


def test_engine_backend_aligns_capacity_and_load_views():
    cfg, _, _, tm, tp = _models("granite-3-2b")
    lat = LatencyModel(tm.cfg, TPU_V5E)
    cs = ClusterSimulator(lat, ClusterConfig(
        n_replicas=1, router="round_robin", kv_capacity_tokens=65_000,
        backend_factory=engine_backend(tm, tp, num_slots=4, max_seq=64,
                                       device="cpu")))
    rep = cs.replicas[0]
    assert rep.backend.kv.capacity_tokens == 4 * 64
    assert rep.kv_capacity == 4 * 64
    assert rep.clock == 0.0
    assert rep.backend.cache["k"].dtype == torch.float32
    for r in _trace(Request, QoESpec, cfg.vocab_size, seed=2, n=4,
                    out_len=6, stagger=0.0):
        rep.submit(r)
    assert len(rep.committed()) == 4 and rep.kv_demand() > 0
    rep.advance_to(0.5)
    assert rep.clock >= 0.5 or not rep.has_work
    while rep.step():
        pass
    assert not rep.has_work
    res = rep.result()
    assert res.total_tokens == sum(r.generated for r in res.requests)


def test_engine_backend_cache_dtype_and_device():
    _, _, _, tm, tp = _models("granite-3-2b")
    lat = LatencyModel(tm.cfg, TPU_V5E)
    factory = engine_backend(tm, tp, num_slots=2, max_seq=32,
                             cache_dtype=torch.bfloat16, device="cpu")
    eng = factory(0, make_scheduler("andes", 64, lat), lat,
                  dataclasses.replace(ClusterConfig(), kv_capacity_tokens=64))
    assert eng.cache["k"].dtype == torch.bfloat16
    assert eng.model.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine_backend(tm, tp)            # the default device is a card
