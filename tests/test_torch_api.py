"""The port's serving API and the engine's cancel surface against the
reference (CPU, f32).

``repro_torch.api.ServingClient`` must be a pure surface over the port's
engine: submitting the engine tests' trace (12 staggered requests, EOS
off, 4 slots, a KV capacity of 100 tokens so that requests preempt)
through the client and draining it gives, bit for bit, the emit times,
preemptions, QoE and tokens of driving the same engine directly, and
the client's timing fingerprint equals the reference client's over the
reference engine (bridged weights, one LatencyModel, virtual clock).

The same holds over the port's discrete-event simulator and over a port
``ClusterSimulator`` (1 replica, and 2 replicas with admission that
sheds): the client's streams equal driving the backend directly bit for
bit, and equal the reference client's over the reference backend on the
same workload (``repro_torch.workload`` gives it bitwise). A shed stream
ends empty with QoE 0, and pulling streams lazily one token at a time
gives the timeline of draining wholesale.

``ServingEngine.cancel`` is held against the reference engine's: both
engines step in lockstep over the trace until the chosen request is
pending, running or swapped out to host memory, it is cancelled on both,
and the two runs must agree on its finish time, on the slot it frees
(``slots_in_use``, the parked host slices), and on every request's
timing to the end. The swapped case runs over the llama3, falcon-mamba
(a whole Mamba-1 state slot) and zamba2 (a hybrid slot) smoke models.
"""
import jax
import numpy as np
import pytest
import torch

from repro.api import ServingClient as JClient
from repro.cluster import AdmissionConfig as JAdmission
from repro.cluster import ClusterConfig as JClusterConfig
from repro.cluster import ClusterSimulator as JCluster
from repro.configs import get_config as j_get_config
from repro.core import A100_4X as J_A100_4X
from repro.configs import get_smoke_config as j_smoke
from repro.core import LatencyModel as JLat
from repro.core import QoESpec as JSpec
from repro.core import SchedulerConfig as JSchedCfg
from repro.core import TPU_V5E as J_TPU_V5E
from repro.core import make_scheduler as j_make_scheduler
from repro.models import Model as JModel
from repro.serving import ReqState as JReqState
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import timing_fingerprint as j_timing
from repro.serving.simulator import ServingSimulator as JSim
from repro.serving.simulator import SimConfig as JSimConfig
import repro.workload as jw
from repro_torch.api import ServingClient, SubmitOptions
from repro_torch.bridge import from_numpy
from repro_torch.cluster import (AdmissionConfig, ClusterConfig,
                                 ClusterSimulator)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import (A100_4X, TPU_V5E, LatencyModel, QoESpec,
                              SchedulerConfig, make_scheduler)
from repro_torch.core.qoe import pace_delivery
from repro_torch.models import Model
from repro_torch.serving import (Request, ReqState, ServingEngine,
                                 ServingSimulator, SimConfig,
                                 timing_fingerprint)
import repro_torch.workload as tw

torch.set_num_threads(1)
CAP = 100
DELTA_T = 2.0
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


def _trace(make, spec, vocab):
    rng = np.random.default_rng(0)
    out = []
    for i in range(12):
        plen = int(rng.integers(5, 30))
        out.append(make(rid=i, arrival=i * 0.01, prompt_len=plen,
                        output_len=14, spec=spec(ttft=1.0, tds=4.8),
                        prompt_tokens=rng.integers(0, vocab, plen)))
    return out


def _jax_engine(arch):
    cfg, jm, jp, _, _ = _models(arch)
    lat = JLat(cfg, J_TPU_V5E)
    sched = j_make_scheduler("andes", CAP, lat, JSchedCfg(delta_t=DELTA_T))
    return JEngine(jm, jp, sched, lat, num_slots=4, max_seq=64,
                   capacity_tokens=CAP)


def _torch_engine(arch):
    _, _, _, tm, tp = _models(arch)
    lat = LatencyModel(tm.cfg, TPU_V5E)
    sched = make_scheduler("andes", CAP, lat, SchedulerConfig(delta_t=DELTA_T))
    return ServingEngine(tm, tp, sched, lat, num_slots=4, max_seq=64,
                         capacity_tokens=CAP, device="cpu",
                         reference_decode=True)


# ---------------------------------------------------------------------------
# ServingClient: a pure surface over the port's engine
# ---------------------------------------------------------------------------

def test_client_over_engine_bit_identical_and_matches_reference():
    cfg = _models("llama3-8b")[0]
    direct = _torch_engine("llama3-8b").run(
        _trace(Request, QoESpec, cfg.vocab_size), max_iterations=4000)
    assert sum(r.preemptions for r in direct) > 0

    client = ServingClient(_torch_engine("llama3-8b"))
    handles = [client.submit_request(r)
               for r in _trace(Request, QoESpec, cfg.vocab_size)]
    client.drain()
    d = {r.rid: r for r in direct}
    assert len(handles) == len(d)
    for h in handles:
        r = d[h.rid]
        assert h.request.emit_times == r.emit_times
        assert h.request.preemptions == r.preemptions
        assert h.qoe() == r.final_qoe()
        assert h.tokens() == r.output_tokens
        evs = list(h.read())
        assert [e.token for e in evs] == r.output_tokens
        np.testing.assert_array_equal(
            [e.visible_time for e in evs],
            pace_delivery(np.array(r.emit_times), r.spec.tds))

    jclient = JClient(_jax_engine("llama3-8b"))
    jhandles = [jclient.submit_request(r)
                for r in _trace(JRequest, JSpec, cfg.vocab_size)]
    jclient.drain()
    assert timing_fingerprint([h.request for h in handles]) == \
        j_timing([h.request for h in jhandles])
    assert client.avg_qoe() == jclient.avg_qoe()


def _spec_trace(make, spec, vocab):
    """The reference's speculative client trace (tests/test_api.py)."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(8):
        plen = int(rng.integers(8, 24))
        out.append(make(rid=i, arrival=i * 0.02, prompt_len=plen,
                        output_len=int(rng.integers(8, 16)),
                        spec=spec(ttft=1.0, tds=4.8),
                        prompt_tokens=rng.integers(0, vocab, plen)))
    return out


def _spec_engines(k=2):
    """A speculative engine in each package (the draft is the target
    itself, as the reference's spec_k case), 3 slots, capacity 160."""
    from repro.core import SpeculativeLatencyModel as JSpecLat
    from repro_torch.core import SpeculativeLatencyModel
    cfg, jm, jp, tm, tp = _models("llama3-8b")

    def port():
        lat = SpeculativeLatencyModel(tm.cfg, TPU_V5E, tm.cfg, k=k)
        return ServingEngine(tm, tp, make_scheduler("andes", 160, lat), lat,
                             num_slots=3, max_seq=64, capacity_tokens=160,
                             draft_model=tm, draft_params=tp, spec_k=k,
                             device="cpu", reference_decode=True)

    def ref():
        lat = JSpecLat(cfg, J_TPU_V5E, cfg, k=k)
        return JEngine(jm, jp, j_make_scheduler("andes", 160, lat), lat,
                       num_slots=3, max_seq=64, capacity_tokens=160,
                       draft_model=jm, draft_params=jp, spec_k=k)
    return port, ref


def test_client_over_spec_engine_bit_identical_and_matches_reference():
    """The client over a speculative engine (spec_k=2): bit for bit the
    engine driven by run(), and the reference client's timing over the
    reference's speculative engine."""
    cfg = _models("llama3-8b")[0]
    port, ref = _spec_engines()
    eng = port()
    direct = eng.run(_spec_trace(Request, QoESpec, cfg.vocab_size))
    assert eng.spec_stats()["accepted"] > 0
    client = ServingClient(port())
    handles = [client.submit_request(r)
               for r in _spec_trace(Request, QoESpec, cfg.vocab_size)]
    client.drain()
    d = {r.rid: r for r in direct}
    for h in handles:
        r = d[h.rid]
        assert h.request.emit_times == r.emit_times
        assert h.tokens() == r.output_tokens
        assert h.qoe() == r.final_qoe()
    jclient = JClient(ref())
    jhandles = [jclient.submit_request(r)
                for r in _spec_trace(JRequest, JSpec, cfg.vocab_size)]
    jclient.drain()
    assert timing_fingerprint([h.request for h in handles]) == \
        j_timing([h.request for h in jhandles])
    assert [h.tokens() for h in handles] == \
        [[int(t) for t in h.tokens()] for h in jhandles]
    assert client.avg_qoe() == jclient.avg_qoe()


def test_client_submit_prompt_and_callbacks():
    """submit() with a token prompt and options, lifecycle callbacks fired
    once per event, and a client cancel of a live stream."""
    cfg = _models("llama3-8b")[0]
    client = ServingClient(_torch_engine("llama3-8b"))
    rng = np.random.default_rng(3)
    counts = {"first": 0, "emit": 0, "finish": 0}

    def track(kind):
        def cb(h, t, k=1):
            counts[kind] += k if kind == "emit" else 1
        return cb

    hs = [client.submit(rng.integers(0, cfg.vocab_size, 9),
                        SubmitOptions(max_tokens=6, tenant=i),
                        on_first_token=track("first"), on_emit=track("emit"),
                        on_finish=track("finish"))
          for i in range(3)]
    victim = client.submit(12, SubmitOptions(max_tokens=40))
    while victim.request.generated < 2:
        client.step()
    assert client.cancel(victim)
    assert victim.cancelled and victim.request.state == ReqState.FINISHED
    assert not client.cancel(victim)
    client.drain()
    assert all(h.finished and h.request.generated == 6 for h in hs)
    assert counts == {"first": 3, "emit": 18, "finish": 3}
    assert client.backend.kv.slots_in_use == 0


# ---------------------------------------------------------------------------
# ServingClient over the simulator and over a cluster
# ---------------------------------------------------------------------------

SIM_M = 65_000


def _sim(mod, scheduler="andes", kv=SIM_M):
    if mod is tw:
        lat = LatencyModel(get_config("opt-66b"), A100_4X)
        return ServingSimulator(
            make_scheduler(scheduler, kv, lat, SchedulerConfig()), lat,
            SimConfig(kv_capacity_tokens=kv))
    lat = JLat(j_get_config("opt-66b"), J_A100_4X)
    return JSim(j_make_scheduler(scheduler, kv, lat, JSchedCfg()), lat,
                JSimConfig(kv_capacity_tokens=kv))


def _cluster(mod, n_replicas=1, kv=SIM_M, shed=False):
    if mod is tw:
        lat = LatencyModel(get_config("opt-66b"), A100_4X)
        return ClusterSimulator(lat, ClusterConfig(
            n_replicas=n_replicas, kv_capacity_tokens=kv,
            admission=AdmissionConfig(policy="shed") if shed else None))
    lat = JLat(j_get_config("opt-66b"), J_A100_4X)
    return JCluster(lat, JClusterConfig(
        n_replicas=n_replicas, kv_capacity_tokens=kv,
        admission=JAdmission(policy="shed") if shed else None))


def _gamma(mod, n, rate, seed):
    return mod.make_workload(n, rate, seed=seed, arrival="gamma", cv=3.0)


def _streams(handles):
    return [(h.rid, h.shed, tuple(h.request.emit_times),
             h.request.preemptions, h.qoe()) for h in handles]


def _direct(reqs):
    return [(r.rid, tuple(r.emit_times), r.preemptions, r.final_qoe())
            for r in sorted(reqs, key=lambda r: r.rid)]


@pytest.mark.parametrize("scheduler", ["andes", "fcfs"])
def test_client_over_simulator_bit_identical_and_matches_reference(
        scheduler):
    direct = _sim(tw, scheduler).run(_gamma(tw, 100, 4.0, 11))
    client = ServingClient(_sim(tw, scheduler))
    res = client.serve(_gamma(tw, 100, 4.0, 11))
    hs = sorted(client.handles(), key=lambda h: h.rid)
    assert [s[:1] + s[2:] for s in _streams(hs)] == _direct(direct.requests)
    assert (res.total_tokens, res.makespan) == \
        (direct.total_tokens, direct.makespan)
    jclient = JClient(_sim(jw, scheduler))
    jclient.serve(_gamma(jw, 100, 4.0, 11))
    assert _streams(hs) == _streams(sorted(jclient.handles(),
                                           key=lambda h: h.rid))
    assert client.avg_qoe() == jclient.avg_qoe()


@pytest.mark.parametrize("n_replicas,kv,shed", [(1, SIM_M, False),
                                               (2, 6_000, True)],
                         ids=["one-replica", "two-replica-shed"])
def test_client_over_cluster_bit_identical_and_matches_reference(
        n_replicas, kv, shed):
    """Client -> cluster ≡ direct cluster (≡ the bare simulator for one
    replica) ≡ the reference client over the reference cluster."""
    wl = (100, 4.0, 13) if not shed else (100, 12.0, 2)
    direct = _cluster(tw, n_replicas, kv, shed).run(_gamma(tw, *wl))
    client = ServingClient(_cluster(tw, n_replicas, kv, shed))
    handles = [client.submit_request(r) for r in _gamma(tw, *wl)]
    client.drain()
    got = [s[:1] + s[2:] for s in _streams(handles)]
    assert got == _direct(direct.admitted + direct.shed)
    if n_replicas == 1:
        assert got == _direct(_sim(tw).run(_gamma(tw, *wl)).requests)
    jclient = JClient(_cluster(jw, n_replicas, kv, shed))
    jhandles = [jclient.submit_request(r) for r in _gamma(jw, *wl)]
    jclient.drain()
    assert _streams(handles) == _streams(jhandles)
    assert client.avg_qoe() == jclient.avg_qoe()
    shed_h = [h for h in handles if h.shed]
    assert bool(shed_h) == shed
    for h in shed_h:
        assert list(h) == [] and h.done and not h.finished
        assert h.qoe() == 0.0


def test_client_lazy_stream_iteration_matches_drain():
    direct = _sim(tw).run(_gamma(tw, 60, 4.0, 17))
    client = ServingClient(_sim(tw))
    handles = [client.submit_request(r) for r in _gamma(tw, 60, 4.0, 17)]
    events = {h.rid: list(h) for h in handles}      # lazy, interleaved
    d = {r.rid: r for r in direct.requests}
    for rid, evs in events.items():
        assert [e.emit_time for e in evs] == d[rid].emit_times
        np.testing.assert_array_equal(
            [e.visible_time for e in evs],
            pace_delivery(np.array(d[rid].emit_times), d[rid].spec.tds))


# ---------------------------------------------------------------------------
# cancel: pending, running, swapped — against the reference engine
# ---------------------------------------------------------------------------

def _state(r):
    return r.state.name


def _pick(eng, state):
    """The lowest rid in `state` on the reference engine, or None."""
    if state == "pending":
        return eng.pending[-1].rid if eng.pending else None
    want = {"running": JReqState.RUNNING, "swapped": JReqState.SWAPPED}[state]
    rids = [r.rid for r in eng.live if r.state == want
            and (state != "running" or r.generated >= 2)]
    return min(rids) if rids else None


@pytest.mark.parametrize("arch,state", [
    ("llama3-8b", "pending"), ("llama3-8b", "running"),
    ("llama3-8b", "swapped"), ("falcon-mamba-7b", "swapped"),
    ("zamba2-2.7b", "swapped"),
])
def test_cancel_matches_reference(arch, state):
    cfg = _models(arch)[0]
    jeng, teng = _jax_engine(arch), _torch_engine(arch)
    jwl = _trace(JRequest, JSpec, cfg.vocab_size)
    twl = _trace(Request, QoESpec, cfg.vocab_size)
    for r in jwl:
        jeng.submit(r)
    for r in twl:
        teng.submit(r)
    rid = _pick(jeng, state)
    while rid is None:
        assert jeng.step() and teng.step()
        assert [(r.rid, _state(r), r.generated) for r in teng.seen] == \
            [(r.rid, _state(r), r.generated) for r in jeng.seen]
        rid = _pick(jeng, state)
    tr = next(r for r in teng.seen if r.rid == rid)
    if state == "pending":
        assert tr in teng.pending and tr not in teng.live
    else:
        assert _state(tr) == state.upper()
    if state == "swapped":
        assert rid in teng.kv.host_store
    slots = (teng.kv.slots_in_use, jeng.kv.slots_in_use)
    assert slots[0] == slots[1]

    assert teng.cancel(rid) and jeng.cancel(rid)
    jr = next(r for r in jeng.seen if r.rid == rid)
    assert tr.cancelled and jr.cancelled
    assert tr.state == ReqState.FINISHED
    assert tr.finish_time == jr.finish_time == teng.now
    assert rid not in teng.kv.host_store and rid not in teng.kv.slot_of
    freed = 1 if state == "running" else 0
    assert teng.kv.slots_in_use == jeng.kv.slots_in_use == slots[0] - freed
    assert tr not in teng.live and tr not in teng.pending
    assert not teng.cancel(rid) and not teng.cancel(999)

    while jeng.step():
        pass
    while teng.step():
        pass
    assert timing_fingerprint(twl) == j_timing(jwl)
    for a, b in zip(twl, jwl):
        assert (a.rid, a.cancelled, a.generated, a.finish_time) == \
            (b.rid, b.cancelled, b.generated, b.finish_time)
        assert a.generated == a.output_len or a.rid == rid
    assert teng.kv.slots_in_use == 0 and not teng.kv.host_store
    assert teng.kv.tokens_used == 0
