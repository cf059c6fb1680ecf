"""The port's serving engine over the encoder-decoder and vision-language
models against the JAX reference engine (CPU, f32).

The engine tests' trace — 12 requests with staggered arrivals, 4 slots,
max_seq 64 (so an encoder-decoder reserves enc_seq = 16 frames), Andes
with a small delta_t and a KV capacity of 100 tokens so that requests
preempt — runs through ``repro.serving.ServingEngine`` and
``repro_torch.serving.ServingEngine`` with bridged weights and one
LatencyModel (TPU_V5E, virtual clock). Each request carries frames made
from its rid by each package's ``synthetic_frames`` (equal to 1e-6,
``tests/test_torch_modality.py``). ``seamless-m4t-medium`` (smoke):
bucketed prefill in swap and in recompute mode, the eager baseline (hot
path off), and EOS on; ``pixtral-12b`` (smoke, no patches, as the
reference engine): over the page pool (page 16) and over the contiguous
cache.

Timing fingerprints and the hot-path counters must be identical; tokens
identical except for flips the port's ``audit_flips`` (the port's model
as referee, with each request's frames) classifies as documented
near-ties. With EOS on, tokens and emit times must be identical per
request.

Also the engine's slot helpers over an encoder-decoder cache, whose
``enc_length`` (B,) is a second rank-1 leaf beside ``length``: the port
picks each leaf's slot axis by its rank, as the reference, and its
scatter, read and single-slot write equal the reference's on the same
numpy leaves.
"""
import collections

import jax
import jax.numpy as jnp
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
from repro.serving import engine as jengine
from repro.serving import timing_fingerprint as j_timing
from repro.serving.modality import synthetic_frames as j_frames
from repro_torch.bridge import from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core import (TPU_V5E, LatencyModel, QoESpec,
                              SchedulerConfig, make_scheduler)
from repro_torch.models import Model
from repro_torch.serving import (HotpathConfig, Request, ServingEngine,
                                 all_flips_documented, audit_flips,
                                 synthetic_frames, timing_fingerprint)
from repro_torch.serving import engine as tengine

torch.set_num_threads(1)
CAP = 100           # KV capacity (tokens): tight enough to preempt
DELTA_T = 2.0       # Andes look-ahead (s)
MAX_SEQ = 64
STATS = ("host_syncs", "dispatches", "multi_step_blocks",
         "persistent_blocks", "prefill_shapes", "page_gathers",
         "page_scatters", "page_gather_bytes")
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


def _trace(make, spec, cfg, frames_of):
    rng = np.random.default_rng(0)
    out = []
    for i in range(12):
        plen = int(rng.integers(5, 30))
        r = make(rid=i, arrival=i * 0.01, prompt_len=plen, output_len=14,
                 spec=spec(ttft=1.0, tds=4.8),
                 prompt_tokens=rng.integers(0, cfg.vocab_size, plen))
        if cfg.kind == "audio":
            r.frames = frames_of(cfg, [i], MAX_SEQ // 4)[0]
        out.append(r)
    return out


def _run_jax(arch, kw):
    cfg, jm, jp, _, _ = _models(arch)
    lat = JLat(cfg, J_TPU_V5E)
    sched = j_make_scheduler("andes", CAP, lat, JSchedCfg(delta_t=DELTA_T))
    eng = JEngine(jm, jp, sched, lat, num_slots=4, max_seq=MAX_SEQ,
                  capacity_tokens=CAP, **kw)
    frames = lambda c, ids, n: j_frames(c, jnp.asarray(ids), n)  # noqa: E731
    return eng.run(_trace(JRequest, JSpec, cfg, frames),
                   max_iterations=4000), eng


def _run_torch(arch, kw):
    _, _, _, tm, tp = _models(arch)
    lat = LatencyModel(tm.cfg, TPU_V5E)
    sched = make_scheduler("andes", CAP, lat, SchedulerConfig(delta_t=DELTA_T))
    eng = ServingEngine(tm, tp, sched, lat, num_slots=4, max_seq=MAX_SEQ,
                        capacity_tokens=CAP, device="cpu",
                        reference_decode=True, **kw)
    return eng.run(_trace(Request, QoESpec, tm.cfg, synthetic_frames),
                   max_iterations=4000), eng


CASES = [
    ("seamless-m4t-medium", dict(preemption_mode="swap")),
    ("seamless-m4t-medium", dict(preemption_mode="recompute")),
    ("seamless-m4t-medium", dict(hotpath=HotpathConfig.baseline())),
    ("pixtral-12b", dict(preemption_mode="swap", page_size=16)),
    ("pixtral-12b", dict(preemption_mode="swap")),
]


@pytest.mark.parametrize("arch,kw", CASES, ids=[
    "seamless-swap", "seamless-recompute", "seamless-eager-baseline",
    "pixtral-paged16", "pixtral-contiguous"])
def test_engine_matches_reference(arch, kw):
    jout, jeng = _run_jax(arch, kw)
    tout, teng = _run_torch(arch, kw)
    assert teng.preemptions > 0, "the trace must preempt"
    assert teng.preemptions == jeng.preemptions
    assert teng.physical_pages == jeng.physical_pages == ("page_size" in kw)
    assert timing_fingerprint(tout) == j_timing(jout)
    assert all(r.generated == r.output_len for r in tout)
    _, _, _, tm, tp = _models(arch)
    flips = audit_flips(tm, tp, tout, jout)
    assert all_flips_documented(flips), flips
    stats, jstats = teng.hotpath_stats(), jeng.hotpath_stats()
    for key in STATS:
        assert stats[key] == jstats[key], key
    if tm.cfg.kind == "audio":
        assert teng._prefill.enc_seq == MAX_SEQ // 4
        assert tuple(teng.cache["cross_k"].shape[1:3]) == (4, MAX_SEQ // 4)
        assert (teng.cache["enc_length"] == MAX_SEQ // 4).all()


def _early_token(outs):
    counts = collections.Counter(t for r in outs for t in r.output_tokens[:4])
    return max(sorted(counts), key=counts.get)


def test_engine_with_eos_matches_reference():
    arch = "seamless-m4t-medium"
    off, _ = _run_torch(arch, dict(preemption_mode="swap"))
    kw = dict(preemption_mode="swap", eos_id=_early_token(off))
    jout, jeng = _run_jax(arch, kw)
    tout, teng = _run_torch(arch, kw)
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


def test_frames_condition_the_engine():
    """Zero frames in place of each request's own change some tokens: the
    encoder memory reaches the decoder through the engine."""
    arch = "seamless-m4t-medium"
    out, _ = _run_torch(arch, dict(preemption_mode="swap"))
    _, _, _, tm, tp = _models(arch)
    lat = LatencyModel(tm.cfg, TPU_V5E)
    eng = ServingEngine(tm, tp, make_scheduler(
        "andes", CAP, lat, SchedulerConfig(delta_t=DELTA_T)), lat,
        num_slots=4, max_seq=MAX_SEQ, capacity_tokens=CAP, device="cpu")
    bare = [r.clone() for r in _trace(Request, QoESpec, tm.cfg,
                                      synthetic_frames)]
    zero = eng.run(bare, max_iterations=4000)
    assert timing_fingerprint(zero) == timing_fingerprint(out)
    assert any(a.output_tokens != b.output_tokens for a, b in zip(out, zero))


def _encdec_leaves(rng, slots, s=8, se=4, kv=4, hd=64):
    """Numpy leaves of an encoder-decoder cache with `slots` rows."""
    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"length": rng.integers(0, s, slots).astype(np.int32),
            "enc_length": rng.integers(1, se + 1, slots).astype(np.int32),
            "k": rnd(2, slots, s, kv, hd), "v": rnd(2, slots, s, kv, hd),
            "cross_k": rnd(2, slots, se, kv, hd),
            "cross_v": rnd(2, slots, se, kv, hd)}


def _equal(tcache, jcache):
    assert set(tcache) == set(jcache)
    for key in tcache:
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jcache[key]), err_msg=key)


def test_slot_helpers_take_the_axis_by_rank():
    rng = np.random.default_rng(0)
    cache = _encdec_leaves(rng, 4)
    src = _encdec_leaves(rng, 2)
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    # row 0 -> slot 2; row 1 is row-bucket padding (sentinel slot 4)
    slots = np.array([2, 4], np.int32)
    tc = tengine._write_slots(tc, {k: torch.from_numpy(v)
                                   for k, v in src.items()}, slots)
    jc = jengine._write_slots(jc, {k: jnp.asarray(v) for k, v in src.items()},
                              jnp.asarray(slots))
    _equal(tc, jc)
    assert int(tc["enc_length"][2]) == int(src["enc_length"][0])
    # swap-out of slot 2, then back in at slot 1
    row, jrow = tengine._read_slot(tc, 2), jengine._read_slot(jc, 2)
    _equal(row, jrow)
    assert tuple(row["enc_length"].shape) == (1,)
    assert tuple(row["cross_k"].shape) == (2, 1, 4, 4, 64)
    tc = tengine._write_slot(tc, row, 1)
    jc = jengine._write_slot(jc, jrow, 1)
    _equal(tc, jc)
    assert tengine._slot_axis(tc["enc_length"]) == 0
    assert tengine._slot_axis(tc["cross_v"]) == 1
