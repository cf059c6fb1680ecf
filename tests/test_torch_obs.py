"""The port's observability layer against the reference's (CPU, f32).

The engine tests' trace (12 staggered requests, EOS off, 4 slots, a KV
capacity of 100 tokens so that requests preempt) runs through the
reference engine with the reference's observer stack and through the
port's engine with the port's (``repro_torch.obs``), weights bridged,
one LatencyModel (TPU_V5E) on the virtual clock. With EOS off the
clock depends only on lengths and batch composition, so the two traces
must hold the same events — kind, rid, time, payload, in order — and
the two registries the same samples. Each trace recomputes its own
run's QoE exactly (``qoe_from_trace``), and a trace survives its JSONL
round trip.

The port's registry also holds its span-log counters, which the
reference lacks: they are checked against the engine's log and then left
out of the comparison.

Also the port's own contract: attaching observers changes nothing the
engine computes, the legacy ``event_sink`` composes with an installed
observer through ``_rewire_obs`` (which keeps the scheduler on the same
stream), and the KV gauges read the live manager.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import LatencyModel as JLat
from repro.core import QoESpec as JSpec
from repro.core import SchedulerConfig as JSchedCfg
from repro.core import TPU_V5E as J_TPU_V5E
from repro.core import make_scheduler as j_make_scheduler
from repro.models import Model as JModel
from repro.obs import MetricsObserver as JMetricsObserver
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import ProfilingObserver as JProfilingObserver
from repro.obs import TraceRecorder as JTraceRecorder
from repro.obs import compose as j_compose
from repro.obs import register_backend_gauges as j_register_gauges
from repro.obs.metrics import registry_samples_dict as j_samples
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.bridge import from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core import (TPU_V5E, LatencyModel, QoESpec,
                              SchedulerConfig, make_scheduler)
from repro_torch.models import Model
from repro_torch.obs import (MetricsObserver, MetricsRegistry,
                             ProfilingObserver, TraceRecorder, compose,
                             parse_prometheus, qoe_from_trace,
                             register_backend_gauges)
from repro_torch.obs.metrics import (SPAN_COUNTER_GAUGES,
                                     registry_samples_dict)
from repro_torch.serving import Request, ServingEngine

torch.set_num_threads(1)
CAP = 100
DELTA_T = 2.0


@pytest.fixture(scope="module")
def models():
    cfg = j_smoke("llama3-8b")
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config("llama3-8b"), device="cpu")
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _trace(make, spec, vocab):
    rng = np.random.default_rng(0)
    out = []
    for i in range(12):
        plen = int(rng.integers(5, 30))
        out.append(make(rid=i, arrival=i * 0.01, prompt_len=plen,
                        output_len=14, spec=spec(ttft=1.0, tds=4.8),
                        prompt_tokens=rng.integers(0, vocab, plen)))
    return out


def _jax_engine(jm, jp, cfg, **kw):
    lat = JLat(cfg, J_TPU_V5E)
    sched = j_make_scheduler("andes", CAP, lat, JSchedCfg(delta_t=DELTA_T))
    return JEngine(jm, jp, sched, lat, num_slots=4, max_seq=64,
                   capacity_tokens=CAP, **kw)


def _torch_engine(tm, tp, **kw):
    lat = LatencyModel(tm.cfg, TPU_V5E)
    sched = make_scheduler("andes", CAP, lat, SchedulerConfig(delta_t=DELTA_T))
    return ServingEngine(tm, tp, sched, lat, num_slots=4, max_seq=64,
                         capacity_tokens=CAP, device="cpu", **kw)


def _fingerprint(reqs):
    return [(r.rid, tuple(r.output_tokens), tuple(r.emit_times),
             r.preemptions, r.final_qoe())
            for r in sorted(reqs, key=lambda r: r.rid)]


def _events(trace):
    return [(e.kind, e.t, e.rid, e.replica, e.data) for e in trace.events]


@pytest.fixture(scope="module", params=["swap", "recompute"])
def observed(request, models):
    """Both engines over the trace, each under its own package's full
    observer stack (trace + metrics + profiling + KV gauges)."""
    cfg, jm, jp, tm, tp = models
    mode = request.param

    jeng = _jax_engine(jm, jp, cfg, preemption_mode=mode)
    jtr, jreg = JTraceRecorder(), JMetricsRegistry()
    jeng.observer = j_compose(jtr, JMetricsObserver(jreg),
                              JProfilingObserver(jreg))
    j_register_gauges(jreg, jeng)
    jout = jeng.run(_trace(JRequest, JSpec, cfg.vocab_size),
                    max_iterations=4000)

    teng = _torch_engine(tm, tp, preemption_mode=mode)
    ttr, treg = TraceRecorder(), MetricsRegistry()
    teng.observer = compose(ttr, MetricsObserver(treg),
                            ProfilingObserver(treg))
    register_backend_gauges(treg, teng)
    tout = teng.run(_trace(Request, QoESpec, cfg.vocab_size),
                    max_iterations=4000)
    return dict(jeng=jeng, jtr=jtr, jreg=jreg, jout=jout,
                teng=teng, ttr=ttr, treg=treg, tout=tout)


def test_trace_events_match_reference(observed):
    o = observed
    assert o["teng"].preemptions > 0
    tev, jev = _events(o["ttr"]), _events(o["jtr"])
    kinds = {k for k, *_ in tev}
    assert {"arrival", "admit", "prefill", "first_token", "emit",
            "preempt", "finish", "schedule", "sync", "dispatch"} <= kinds
    assert len(tev) == len(jev)
    for i, (a, b) in enumerate(zip(tev, jev)):
        assert a == b, (i, a, b)


def _port_only(tsam, eng):
    """The samples of the port's span-log counters, which the reference
    lacks, taken out of `tsam` after checking them against the engine's
    log."""
    for counter, gauge, _help in SPAN_COUNTER_GAUGES:
        assert tsam.pop((gauge, ())) == eng.spans.counters[counter], gauge
    return tsam


def test_metrics_samples_match_reference(observed):
    o = observed
    tsam = _port_only(registry_samples_dict(o["treg"]), o["teng"])
    jsam = j_samples(o["jreg"])
    assert tsam.keys() == jsam.keys()
    for k, v in jsam.items():
        assert tsam[k] == v, k
    hs = o["teng"].hotpath_stats()
    assert o["treg"].value("engine_host_syncs_total") == hs["host_syncs"]
    assert o["treg"].value("engine_jit_compiles_total") == \
        hs["prefill_compiles"]
    assert o["treg"].value("requests_finished_total") == len(o["tout"])
    assert o["treg"].value("tokens_emitted_total") == sum(
        r.generated for r in o["tout"])
    assert o["treg"].value("kv_tokens_peak") == \
        o["teng"].kv.peak_tokens_used > 0


def test_qoe_from_trace_reconciles_each_run(observed):
    o = observed
    for tr, out in ((o["ttr"], o["tout"]), (o["jtr"], o["jout"])):
        traced = qoe_from_trace(tr.events)
        for r in out:
            assert traced.get(r.rid, 0.0) == r.final_qoe(), r.rid
    res = o["teng"].result()
    traced = qoe_from_trace(o["ttr"].events)
    assert np.mean([traced[r.rid] for r in res.requests]) == res.avg_qoe()


def test_jsonl_round_trip(observed, tmp_path):
    tr = observed["ttr"]
    path = tmp_path / "trace.jsonl"
    tr.save_jsonl(str(path))
    back = TraceRecorder.load_jsonl(str(path))
    assert len(back) == len(tr.events)
    for a, b in zip(back, tr.events):
        assert (a.kind, a.t, a.rid, a.replica) == \
            (b.kind, b.t, b.rid, b.replica)
        assert a.to_json() == b.to_json()
    assert qoe_from_trace(back) == qoe_from_trace(tr.events)
    # the two packages write the same file for the same run
    assert tr.to_jsonl() == observed["jtr"].to_jsonl()


def test_prometheus_round_trip(observed):
    reg = observed["treg"]
    parsed = parse_prometheus(reg.to_prometheus())
    live = registry_samples_dict(reg)
    assert parsed.keys() == live.keys()
    for k, v in live.items():
        assert parsed[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k


def test_observers_leave_the_run_unchanged(models, observed):
    cfg, _, _, tm, tp = models
    base = _torch_engine(tm, tp, preemption_mode="swap").run(
        _trace(Request, QoESpec, cfg.vocab_size), max_iterations=4000)
    eng = _torch_engine(tm, tp, preemption_mode="swap")
    eng.observer = TraceRecorder()
    eng.attach_observer(compose(MetricsObserver(MetricsRegistry()),
                                ProfilingObserver()))
    inst = eng.run(_trace(Request, QoESpec, cfg.vocab_size),
                   max_iterations=4000)
    assert _fingerprint(base) == _fingerprint(inst)


def test_spec_engine_observed_matches_reference(models):
    """An instrumented speculative engine (spec_k=2, the target as its
    own draft; the reference's tests/test_obs.py case) against the
    reference's: the observers change nothing, the two traces hold the
    same events and the two registries the same samples, the registry's
    counters equal the engine's hot-path counters, and the speculative
    counters are live."""
    from repro.core import SpeculativeLatencyModel as JSpecLat
    from repro_torch.core import SpeculativeLatencyModel
    cfg, jm, jp, tm, tp = models

    def build(port):
        if port:
            lat = SpeculativeLatencyModel(tm.cfg, TPU_V5E, tm.cfg, k=2)
            return ServingEngine(
                tm, tp, make_scheduler("andes", 160, lat), lat,
                num_slots=3, max_seq=64, capacity_tokens=160,
                draft_model=tm, draft_params=tp, spec_k=2, device="cpu")
        lat = JSpecLat(cfg, J_TPU_V5E, cfg, k=2)
        return JEngine(jm, jp, j_make_scheduler("andes", 160, lat), lat,
                       num_slots=3, max_seq=64, capacity_tokens=160,
                       draft_model=jm, draft_params=jp, spec_k=2)

    base = build(True).run(_trace(Request, QoESpec, cfg.vocab_size))
    teng = build(True)
    ttr, treg = TraceRecorder(), MetricsRegistry()
    teng.observer = compose(ttr, MetricsObserver(treg),
                            ProfilingObserver(treg))
    register_backend_gauges(treg, teng)
    tout = teng.run(_trace(Request, QoESpec, cfg.vocab_size))
    assert _fingerprint(base) == _fingerprint(tout)

    jeng = build(False)
    jtr, jreg = JTraceRecorder(), JMetricsRegistry()
    jeng.observer = j_compose(jtr, JMetricsObserver(jreg),
                              JProfilingObserver(jreg))
    j_register_gauges(jreg, jeng)
    jeng.run(_trace(JRequest, JSpec, cfg.vocab_size))
    tev, jev = _events(ttr), _events(jtr)
    assert "spec" in {k for k, *_ in tev}
    assert len(tev) == len(jev)
    for i, (a, b) in enumerate(zip(tev, jev)):
        assert a == b, (i, a, b)
    tsam, jsam = _port_only(registry_samples_dict(treg), teng), \
        j_samples(jreg)
    assert tsam.keys() == jsam.keys()
    for k, v in jsam.items():
        assert tsam[k] == v, k

    hs = teng.hotpath_stats()
    assert treg.value("engine_host_syncs_total") == hs["host_syncs"]
    assert sum(v for _, _, v in treg.get(
        "engine_dispatches_total").samples()) == hs["dispatches"]
    # one compile event per bucket shape and cache (target and draft)
    assert treg.value("engine_jit_compiles_total") == \
        2 * hs["prefill_compiles"]
    proposed = treg.value("engine_spec_proposed_total")
    accepted = treg.value("engine_spec_accepted_total")
    assert proposed > 0 and 0 < accepted <= proposed
    assert treg.value("spec_acceptance_rate") == accepted / proposed


def test_event_sink_composes_and_rewires_scheduler(models):
    """The legacy sink and an installed observer see one stream; the
    scheduler's obs is always the engine's composed obs."""
    cfg, _, _, tm, tp = models
    eng = _torch_engine(tm, tp)
    assert eng.obs is None and eng.sched.obs is None
    seen = []
    eng.event_sink = lambda kind, req, t, k: seen.append((kind, req.rid))
    assert eng.sched.obs is eng.obs is not None
    tr = TraceRecorder(lifecycle_only=True)
    eng.attach_observer(tr)
    assert eng.observer is tr and eng.sched.obs is eng.obs
    out = eng.run(_trace(Request, QoESpec, cfg.vocab_size),
                  max_iterations=4000)
    emits = sum(1 for kind, _ in seen if kind == "emit")
    assert emits == sum(r.generated for r in out)
    assert sum(1 for kind, _ in seen if kind == "finish") == len(out)
    assert sum(1 for e in tr.events if e.kind == "emit") == emits
    eng.event_sink = None
    eng.observer = None
    assert eng.obs is None and eng.sched.obs is None
    assert eng._prefill.on_compile is None
