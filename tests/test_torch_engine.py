"""The port's serving engine against the JAX reference engine (CPU, f32).

One trace — 12 requests with staggered arrivals, EOS off, 4 slots,
max_seq 64, Andes with a small delta_t and a KV capacity of 100 tokens so
that preemptions happen — runs through ``repro.serving.ServingEngine``
and ``repro_torch.serving.ServingEngine`` with bridged weights and the
same LatencyModel (TPU_V5E, the virtual clock's hardware model), in both
preemption modes over the contiguous cache and the physical page pool
(page 16), plus once with chunked prefill, once with the eager baseline
hot path (exact-length batch-1 prefill, host argmax, one step per
dispatch) over the page pool, and once with power-of-two multi-step
blocks instead of the persistent ones.

With EOS off the virtual clock depends only on lengths and batch
composition, so ``timing_fingerprint`` must be identical. Token ids must
be identical except for flips that the reference's ``audit_flips`` (the
JAX model as referee) classifies as documented near-ties.

With EOS on (``eos_id`` set to the trace's most common early token)
requests finish early, and the timing then depends on the tokens, so
tokens and emit times must be identical per request.
"""
import collections

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
from repro.serving import HotpathConfig as JHotpath
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import all_flips_documented, audit_flips
from repro.serving import timing_fingerprint as j_timing
from repro_torch.bridge import from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core import (TPU_V5E, LatencyModel, QoESpec,
                              SchedulerConfig, make_scheduler)
from repro_torch.models import Model
from repro_torch.serving import (HotpathConfig, Request, ServingEngine,
                                 timing_fingerprint)

torch.set_num_threads(1)
CAP = 100           # KV capacity (tokens): tight enough to preempt
DELTA_T = 2.0       # Andes look-ahead (s)
KW_EOS = [dict(preemption_mode="swap"),
          dict(preemption_mode="recompute", page_size=16)]
IDS_EOS = ["swap", "recompute-paged16"]


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


def _hotpath(cls, name):
    return {None: None, "baseline": cls.baseline(),
            "pow2-blocks": cls(persistent=False)}[name]


def _run_jax(jm, jp, cfg, kw, hot):
    lat = JLat(cfg, J_TPU_V5E)
    sched = j_make_scheduler("andes", CAP, lat, JSchedCfg(delta_t=DELTA_T))
    eng = JEngine(jm, jp, sched, lat, num_slots=4, max_seq=64,
                  capacity_tokens=CAP, hotpath=_hotpath(JHotpath, hot), **kw)
    return eng.run(_trace(JRequest, JSpec, cfg.vocab_size),
                   max_iterations=4000), eng


def _run_torch(tm, tp, kw, hot):
    cfg = tm.cfg
    lat = LatencyModel(cfg, TPU_V5E)
    sched = make_scheduler("andes", CAP, lat, SchedulerConfig(delta_t=DELTA_T))
    eng = ServingEngine(tm, tp, sched, lat, num_slots=4, max_seq=64,
                        capacity_tokens=CAP,
                        hotpath=_hotpath(HotpathConfig, hot), device="cpu",
                        reference_decode=True, **kw)
    return eng.run(_trace(Request, QoESpec, cfg.vocab_size),
                   max_iterations=4000), eng


@pytest.mark.parametrize("kw,hot", [
    (dict(preemption_mode="swap"), None),
    (dict(preemption_mode="recompute"), None),
    (dict(preemption_mode="swap", page_size=16), None),
    (dict(preemption_mode="recompute", page_size=16), None),
    (dict(preemption_mode="swap", prefill_chunk=8), None),
    (dict(preemption_mode="swap", page_size=16), "baseline"),
    (dict(preemption_mode="recompute"), "pow2-blocks"),
], ids=["swap", "recompute", "swap-paged16", "recompute-paged16",
        "chunked", "baseline-paged16", "pow2-blocks"])
def test_engine_matches_reference(models, kw, hot):
    cfg, jm, jp, tm, tp = models
    jout, jeng = _run_jax(jm, jp, cfg, kw, hot)
    tout, teng = _run_torch(tm, tp, kw, hot)
    assert teng.preemptions > 0, "the trace must preempt"
    assert teng.physical_pages == jeng.physical_pages
    assert timing_fingerprint(tout) == j_timing(jout)
    assert all(r.generated == r.output_len for r in tout)
    flips = audit_flips(jm, jp, jout, tout)
    assert all_flips_documented(flips), flips
    if teng.physical_pages:
        assert teng.page_scatters > 0
        assert teng.kv.pages_used == 0          # the pool drains
    stats, jstats = teng.hotpath_stats(), jeng.hotpath_stats()
    for key in ("host_syncs", "multi_step_blocks", "persistent_blocks",
                "prefill_shapes", "page_gathers", "page_scatters"):
        assert stats[key] == jstats[key], key


def _early_token(outs):
    """The most common token among the first four each request emits
    (ties to the smallest id)."""
    counts = collections.Counter(t for r in outs for t in r.output_tokens[:4])
    return max(sorted(counts), key=counts.get)


@pytest.mark.parametrize("kw", KW_EOS, ids=IDS_EOS)
def test_engine_with_eos_matches_reference(models, kw):
    """EOS on: `eos_id` set to the trace's most common early token, so
    requests finish early (the engine's early-finish paths and, where the
    cache cannot roll back, the gate that keeps multi-step decode off).
    Tokens and emit times must be identical per request."""
    cfg, jm, jp, tm, tp = models
    off, _ = _run_torch(tm, tp, kw, None)
    eos = _early_token(off)
    kw = dict(kw, eos_id=eos)
    jout, jeng = _run_jax(jm, jp, cfg, kw, None)
    tout, teng = _run_torch(tm, tp, kw, None)
    assert any(r.generated < r.output_len for r in tout), \
        "the EOS token must end some request early"
    for a, b in zip(tout, jout):
        assert a.rid == b.rid
        assert a.output_tokens == [int(t) for t in b.output_tokens], a.rid
        assert a.emit_times == b.emit_times, a.rid
        assert a.generated == a.output_len or a.output_tokens[-1] == eos
    assert teng.preemptions == jeng.preemptions
    stats, jstats = teng.hotpath_stats(), jeng.hotpath_stats()
    for key in ("host_syncs", "multi_step_blocks", "persistent_blocks",
                "prefill_shapes", "page_gathers", "page_scatters"):
        assert stats[key] == jstats[key], key


def test_engine_device_must_match_the_model(models):
    _, _, _, tm, tp = models
    lat = LatencyModel(tm.cfg, TPU_V5E)
    with pytest.raises((ValueError, RuntimeError)):
        ServingEngine(tm, tp, make_scheduler("andes", CAP, lat), lat,
                      num_slots=4, max_seq=64)      # default "cuda"


def test_wall_clock_emits_the_virtual_tokens(models):
    """clock="wall" paces the engine in real time: timestamps carry host
    jitter, but the emitted tokens are the virtual-clock run's."""
    _, _, _, tm, tp = models
    runs = []
    for clock in ("virtual", "wall"):
        lat = LatencyModel(tm.cfg, TPU_V5E)
        eng = ServingEngine(tm, tp, make_scheduler("andes", 256, lat), lat,
                            num_slots=4, max_seq=64, clock=clock,
                            device="cpu")
        trace = _trace(Request, QoESpec, tm.cfg.vocab_size)[:3]
        for r in trace:
            r.output_len = 5
        runs.append(eng.run(trace, max_iterations=1000))
    assert [r.output_tokens for r in runs[0]] == \
        [r.output_tokens for r in runs[1]]
    assert all(len(r.emit_times) == 5 for r in runs[1])
