"""Speculative engines in other settings against the JAX reference
(CPU, f32; ``test_torch_speculative``'s target, drafts and trace).

- recompute preemption (k = 2, perturbed draft): a recompute resume
  re-prefills the target with the whole committed context and the draft
  with all of it but the last token;
- the eager hot path (``HotpathConfig.baseline()``: exact-length batch-1
  prefills for both models, the unfused propose / verify round with its
  two syncs, one round per dispatch);
- ``repro_torch.cluster.speculative_backend``: a 2-replica fleet of
  speculative engines, and a mixed fleet (a speculative replica 0 beside
  an ``engine_backend`` replica 1), against the reference's fleets
  replica by replica — the same rids, timing fingerprint and tokens — and
  every request's tokens equal the bare non-speculative engine's.

Identical timing, preemptions, tokens and acceptance counters; any flip
classified as a documented near-tie by ``audit_flips``.
"""
import pytest

from test_torch_speculative import (CAP, assert_matches_reference,
                                    jax_spec_engine, run_jax, run_torch,
                                    setup, torch_base_engine,
                                    torch_spec_engine, trace)
from repro.cluster import ClusterConfig as JClusterConfig
from repro.cluster import ClusterSimulator as JCluster
from repro.cluster import engine_backend as j_engine_backend
from repro.cluster import mixed_backends as j_mixed_backends
from repro.cluster import speculative_backend as j_speculative_backend
from repro.core import LatencyModel as JLat
from repro.core import QoESpec as JSpec
from repro.core import TPU_V5E as J_TPU_V5E
from repro.serving import HotpathConfig as JHotpath
from repro.serving import Request as JRequest
from repro.serving import all_flips_documented, audit_flips
from repro.serving import timing_fingerprint as j_timing
from repro_torch.cluster import (ClusterConfig, ClusterSimulator,
                                 engine_backend, mixed_backends,
                                 speculative_backend)
from repro_torch.core import TPU_V5E, LatencyModel, QoESpec, make_scheduler
from repro_torch.serving import (HotpathConfig, Request, ServingEngine,
                                 timing_fingerprint)

FLEET_CAP = 200


@pytest.mark.parametrize("case", ["recompute", "baseline-hotpath"])
def test_spec_engine_matches_reference(case):
    if case == "recompute":
        jkw = tkw = dict(preemption_mode="recompute")
    else:
        jkw, tkw = (dict(hotpath=JHotpath.baseline()),
                    dict(hotpath=HotpathConfig.baseline()))
    jeng = jax_spec_engine("perturbed", 2, **jkw)
    jout = run_jax(jeng)
    teng = torch_spec_engine("perturbed", 2, **tkw)
    tout = run_torch(teng)
    assert teng.preemptions > 0, "the trace must preempt"
    assert_matches_reference(jout, jeng, tout, teng)
    if case == "baseline-hotpath":
        assert teng.multi_step_blocks == 0
        assert all(rows == 1 for rows, _ in
                   teng.hotpath_stats()["prefill_shapes"])


def _fleets(kind):
    s = setup()
    dm, dp = s["drafts"]["perturbed"][1]
    jdm, jdp = s["drafts"]["perturbed"][0]
    common = dict(num_slots=4, max_seq=64, capacity_tokens=FLEET_CAP)
    tspec = speculative_backend(s["tm"], s["tp"], dm, dp, spec_k=2,
                                device="cpu", reference_decode=True,
                                **common)
    jspec = j_speculative_backend(s["jm"], s["jp"], jdm, jdp, spec_k=2,
                                  **common)
    if kind == "mixed":
        tspec = mixed_backends([tspec, engine_backend(
            s["tm"], s["tp"], device="cpu", reference_decode=True,
            **common)])
        jspec = j_mixed_backends([jspec, j_engine_backend(
            s["jm"], s["jp"], **common)])
    port = ClusterSimulator(LatencyModel(s["tm"].cfg, TPU_V5E), ClusterConfig(
        n_replicas=2, router="round_robin", kv_capacity_tokens=FLEET_CAP,
        backend_factory=tspec))
    ref = JCluster(JLat(s["cfg"], J_TPU_V5E), JClusterConfig(
        n_replicas=2, router="round_robin", kv_capacity_tokens=FLEET_CAP,
        backend_factory=jspec))
    return port, ref


@pytest.mark.parametrize("kind", ["speculative", "mixed"])
def test_speculative_fleet_matches_reference(kind):
    s = setup()
    vocab = s["cfg"].vocab_size
    tr = dict(n=8, out_len=8, stagger=0.1, seed=6)
    port, ref = _fleets(kind)
    spec_ids = [0, 1] if kind == "speculative" else [0]
    for rid in spec_ids:
        assert port.replicas[rid].backend.spec_k == 2
    if kind == "mixed":
        assert port.replicas[1].backend.spec_k == 0
    tres = port.run(trace(Request, QoESpec, vocab, **tr))
    jres = ref.run(trace(JRequest, JSpec, vocab, **tr))
    assert len(tres.admitted) == len(jres.admitted) == 8
    assert tres.replica_results.keys() == jres.replica_results.keys()
    for rid in sorted(jres.replica_results):
        tq = tres.replica_results[rid].requests
        jq = jres.replica_results[rid].requests
        assert [r.rid for r in tq] == [r.rid for r in jq]
        flips = audit_flips(s["jm"], s["jp"], jq, tq)
        assert all_flips_documented(flips), flips
        if not flips:
            assert timing_fingerprint(tq) == j_timing(jq), rid
    # placement cannot change tokens: every stream is the bare engine's
    bare = torch_base_engine(sched="fcfs", cap=10_000, num_slots=8)
    want = {r.rid: r.output_tokens for r in run_torch(bare, **tr)}
    for r in tres.admitted:
        assert r.generated == r.output_len
        assert r.output_tokens == want[r.rid], r.rid


def test_speculative_backend_needs_the_models_device():
    s = setup()
    dm, dp = s["drafts"]["exact"][1]
    with pytest.raises((ValueError, RuntimeError)):
        speculative_backend(s["tm"], s["tp"], dm, dp)   # default "cuda"
    lat = LatencyModel(s["tm"].cfg, TPU_V5E)
    factory = speculative_backend(s["tm"], s["tp"], dm, dp, spec_k=3,
                                  num_slots=4, max_seq=64, device="cpu")
    eng = factory(0, make_scheduler("andes", 10_000, lat), lat,
                  ClusterConfig(n_replicas=1, kv_capacity_tokens=CAP))
    assert isinstance(eng, ServingEngine) and eng.spec_k == 3
    assert eng.sched.lat is eng.lat and eng.lat.k == 3
    assert eng.sched.M == CAP and eng.kv.burst_reserve == 4
