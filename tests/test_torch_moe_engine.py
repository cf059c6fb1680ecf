"""The port's serving engine over a MoE model against the JAX reference
engine (CPU, f32).

The engine tests' trace — 12 requests with staggered arrivals, EOS off,
4 slots, max_seq 64, Andes with a small delta_t and a KV capacity of 100
tokens so that requests preempt — runs through
``repro.serving.ServingEngine`` and ``repro_torch.serving.ServingEngine``
over the ``qwen2-moe-a2.7b`` smoke model (4 routed experts, 1 shared,
top-2) with bridged weights and one LatencyModel (TPU_V5E, virtual
clock): swap and recompute over the contiguous cache, swap over the
physical page pool (page 16), and swap with page accounting over the
contiguous cache (``physical_pages=False``).

A MoE engine keeps the eager exact-length prefill (capacity depends on
the padded token count), so every prefill is one request at its own
length. Timing fingerprints and the hot-path counters must be identical;
tokens identical except for flips the reference's ``audit_flips`` (the
JAX model as referee) classifies as documented near-ties. With EOS on
(``eos_id`` the trace's most common early token) tokens and emit times
must be identical per request. A MoE engine refuses chunked prefill.
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
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import all_flips_documented, audit_flips
from repro.serving import timing_fingerprint as j_timing
from repro_torch.bridge import from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core import (TPU_V5E, LatencyModel, QoESpec,
                              SchedulerConfig, make_scheduler)
from repro_torch.models import Model
from repro_torch.serving import Request, ServingEngine, timing_fingerprint

torch.set_num_threads(1)
ARCH = "qwen2-moe-a2.7b"
CAP = 100           # KV capacity (tokens): tight enough to preempt
DELTA_T = 2.0       # Andes look-ahead (s)
STATS = ("host_syncs", "dispatches", "multi_step_blocks",
         "persistent_blocks", "prefill_shapes", "page_gathers",
         "page_scatters", "page_gather_bytes")


@pytest.fixture(scope="module")
def models():
    cfg = j_smoke(ARCH)
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config(ARCH), device="cpu")
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


def _run_jax(jm, jp, cfg, kw):
    lat = JLat(cfg, J_TPU_V5E)
    sched = j_make_scheduler("andes", CAP, lat, JSchedCfg(delta_t=DELTA_T))
    eng = JEngine(jm, jp, sched, lat, num_slots=4, max_seq=64,
                  capacity_tokens=CAP, **kw)
    return eng.run(_trace(JRequest, JSpec, cfg.vocab_size),
                   max_iterations=4000), eng


def _run_torch(tm, tp, kw):
    lat = LatencyModel(tm.cfg, TPU_V5E)
    sched = make_scheduler("andes", CAP, lat, SchedulerConfig(delta_t=DELTA_T))
    eng = ServingEngine(tm, tp, sched, lat, num_slots=4, max_seq=64,
                        capacity_tokens=CAP, device="cpu",
                        reference_decode=True, **kw)
    return eng.run(_trace(Request, QoESpec, tm.cfg.vocab_size),
                   max_iterations=4000), eng


@pytest.mark.parametrize("kw", [
    dict(preemption_mode="swap"),
    dict(preemption_mode="recompute"),
    dict(preemption_mode="swap", page_size=16),
    dict(preemption_mode="swap", page_size=16, physical_pages=False),
], ids=["swap", "recompute", "swap-paged16", "swap-paged16-contiguous"])
def test_moe_engine_matches_reference(models, kw):
    cfg, jm, jp, tm, tp = models
    jout, jeng = _run_jax(jm, jp, cfg, kw)
    tout, teng = _run_torch(tm, tp, kw)
    assert teng.preemptions > 0, "the trace must preempt"
    assert teng.preemptions == jeng.preemptions
    assert teng.physical_pages == jeng.physical_pages == \
        (kw.get("page_size") is not None and kw.get("physical_pages", True))
    assert timing_fingerprint(tout) == j_timing(jout)
    assert all(r.generated == r.output_len for r in tout)
    flips = audit_flips(jm, jp, jout, tout)
    assert all_flips_documented(flips), flips
    stats, jstats = teng.hotpath_stats(), jeng.hotpath_stats()
    for key in STATS:
        assert stats[key] == jstats[key], key
    # the eager exact-length path: one row per prefill, at its own length
    assert stats["prefill_shapes"] and \
        all(rows == 1 for rows, _ in stats["prefill_shapes"])
    if teng.physical_pages:
        assert teng.page_scatters > 0
        assert teng.kv.pages_used == 0          # the pool drains


def _early_token(outs):
    counts = collections.Counter(t for r in outs for t in r.output_tokens[:4])
    return max(sorted(counts), key=counts.get)


def test_moe_engine_with_eos_matches_reference(models):
    cfg, jm, jp, tm, tp = models
    off, _ = _run_torch(tm, tp, dict(preemption_mode="swap"))
    kw = dict(preemption_mode="swap", eos_id=_early_token(off))
    jout, jeng = _run_jax(jm, jp, cfg, kw)
    tout, teng = _run_torch(tm, tp, kw)
    assert any(r.generated < r.output_len for r in tout), \
        "the EOS token must end some request early"
    for a, b in zip(tout, jout):
        assert a.rid == b.rid
        assert a.output_tokens == [int(t) for t in b.output_tokens], a.rid
        assert a.emit_times == b.emit_times, a.rid
    assert teng.preemptions == jeng.preemptions
    stats, jstats = teng.hotpath_stats(), jeng.hotpath_stats()
    for key in ("host_syncs", "multi_step_blocks", "prefill_shapes"):
        assert stats[key] == jstats[key], key


def test_moe_engine_refuses_chunked_prefill(models):
    _, _, _, tm, tp = models
    lat = LatencyModel(tm.cfg, TPU_V5E)
    with pytest.raises(ValueError, match="non-MoE"):
        ServingEngine(tm, tp, make_scheduler("andes", CAP, lat), lat,
                      num_slots=4, max_seq=64, prefill_chunk=8,
                      device="cpu")
