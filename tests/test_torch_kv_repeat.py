"""``Model(kv_repeat=)`` against the JAX reference (CPU, f32).

KV-head replication repeats each k/v head r times after the projections
(``src/repro/models/attention.py:_qkv``), so the caches hold KV * r heads
and query head h still meets the values of KV head h // (H / KV). Bridged
weights of two smoke configs with H / KV = 4 — llama3-8b (dense) and
phi3.5-moe (moe) — go through ``repro.models.Model(kv_repeat=r)`` and
``repro_torch.models.Model(kv_repeat=r)`` at every r up to H / KV (1, 2
and 4): prefill logits and caches over right-padded rows with ragged
``lengths``, ``decode_step`` over the contiguous cache and over a page
pool (page 8), ``verify_step`` over a 3-token window and
``propose_step`` (k = 2). Tolerance: 2e-5 absolute on f32 logits and
caches (the attention tolerance of ``tests/test_kernels.py``): two f32
layers whose matmuls and softmaxes reduce in another order in each
framework. At every r the port's logits also stay within that of its
own r = 1 logits, since replication changes no value a query meets.

Also: the abstract caches (contiguous and paged) of all 11 full configs
at r = 2 against ``jax.eval_shape``, leaf for leaf, and the port's
serving engine on ``Model(kv_repeat=2)`` against the reference's engine
on the same trace and ``LatencyModel``: identical ``timing_fingerprint``,
tokens identical except flips the reference's ``audit_flips`` classifies
as documented near-ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
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
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import (TPU_V5E, LatencyModel, QoESpec,
                              SchedulerConfig, make_scheduler)
from repro_torch.models import Model
from repro_torch.serving import Request, ServingEngine, timing_fingerprint
from test_torch_abstract import _port, _ref

torch.set_num_threads(1)
TOL = 2e-5
ARCHS = ["llama3-8b", "phi3.5-moe-42b-a6.6b"]
REPEATS = [1, 2, 4]
S = 32                                     # cache depth
LENS = np.array([13, 20, 5, 0], np.int32)  # ragged rows + an empty row
SEQ = 24                                   # padded prompt bucket
PAGE = 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=0)


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    arch = request.param
    cfg = j_smoke(arch)
    jp = JModel(cfg).init(jax.random.PRNGKey(0))
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    tokens = np.zeros((len(LENS), SEQ), np.int32)
    for i, n in enumerate(LENS):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)
    nxt = rng.integers(0, cfg.vocab_size, (len(LENS), 3)).astype(np.int32)
    return dict(arch=arch, cfg=cfg, jp=jp, tp=tp, tokens=tokens, nxt=nxt)


def _models(w, r):
    return (JModel(w["cfg"], impl="ref", kv_repeat=r),
            Model(get_smoke_config(w["arch"]), kv_repeat=r, device="cpu"))


def _prefill(w, r):
    jm, tm = _models(w, r)
    batch_j = {"tokens": jnp.asarray(w["tokens"]),
               "lengths": jnp.asarray(LENS)}
    jlog, jc = jax.jit(jm.prefill)(w["jp"], batch_j,
                                   jm.init_cache(len(LENS), S))
    tlog, tc = tm.prefill(w["tp"], {"tokens": _t(w["tokens"]),
                                    "lengths": _t(LENS)},
                          tm.init_cache(len(LENS), S))
    return jm, tm, jlog, jc, tlog, tc


@pytest.mark.parametrize("r", REPEATS)
def test_prefill_matches_reference(weights, r):
    _, tm, jlog, jc, tlog, tc = _prefill(weights, r)
    cfg = weights["cfg"]
    assert tc["k"].shape[3] == cfg.num_kv_heads * r
    _close(tlog, jlog)
    for key in ("k", "v", "length"):
        _close(tc[key], jc[key])


@pytest.mark.parametrize("r", REPEATS)
def test_decode_step_matches_reference(weights, r):
    jm, tm, _, jc, _, tc = _prefill(weights, r)
    tok = weights["nxt"][:, 0]
    jlog, jc2 = jax.jit(jm.decode_step)(weights["jp"], jnp.asarray(tok), jc)
    tlog, tc2 = tm.decode_step(weights["tp"], _t(tok), tc)
    _close(tlog, jlog)
    for key in ("k", "v", "length"):
        _close(tc2[key], jc2[key])


def _paged(model, cache, lib_np, lib):
    """The contiguous prefill cache copied into a page pool: row b's
    pages are b * max_pages + i, with a spare page left unused."""
    b = len(LENS)
    max_pages = S // PAGE
    pc = model.init_paged_cache(b, b * max_pages + 1, PAGE, S)
    tables = np.arange(b * max_pages, dtype=np.int32).reshape(b, max_pages)
    k = lib_np(cache["k"])
    v = lib_np(cache["v"])
    l_, _, _, kv, hd = k.shape
    pool_k = np.zeros(tuple(pc["k"].shape), k.dtype)
    pool_v = np.zeros(tuple(pc["v"].shape), v.dtype)
    pool_k[:, :b * max_pages] = k.reshape(l_, b * max_pages, PAGE, kv, hd)
    pool_v[:, :b * max_pages] = v.reshape(l_, b * max_pages, PAGE, kv, hd)
    return {"length": lib(lib_np(cache["length"])), "k": lib(pool_k),
            "v": lib(pool_v), "block_tables": lib(tables)}


@pytest.mark.parametrize("r", REPEATS)
def test_paged_decode_step_matches_reference(weights, r):
    jm, tm, _, jc, _, tc = _prefill(weights, r)
    jpc = _paged(jm, jc, np.asarray, jnp.asarray)
    tpc = _paged(tm, tc, _np, _t)
    tok = weights["nxt"][:, 0]
    jlog, jpc2 = jax.jit(jm.decode_step)(weights["jp"], jnp.asarray(tok),
                                         jpc)
    tlog, tpc2 = tm.decode_step(weights["tp"], _t(tok), tpc)
    _close(tlog, jlog)
    for key in ("k", "v"):
        _close(tpc2[key], jpc2[key])
    # the paged step equals the contiguous one
    clog, _ = tm.decode_step(weights["tp"], _t(tok),
                             {k: v.clone() for k, v in tc.items()})
    _close(tlog, clog)


@pytest.mark.parametrize("r", REPEATS)
def test_verify_and_propose_match_reference(weights, r):
    jm, tm, _, jc, _, tc = _prefill(weights, r)
    win = weights["nxt"]
    jlog, _ = jax.jit(jm.verify_step)(weights["jp"], jnp.asarray(win), jc)
    tlog, tc_v = tm.verify_step(weights["tp"], _t(win),
                                {k: v.clone() for k, v in tc.items()})
    _close(tlog, jlog)
    assert _np(tc_v["length"]).tolist() == (LENS + 3).tolist()
    jprop, _ = jax.jit(jm.propose_step, static_argnums=3)(
        weights["jp"], jnp.asarray(win[:, 0]), jc, 2)
    tprop, _ = tm.propose_step(weights["tp"], _t(win[:, 0]), tc, 2)
    np.testing.assert_array_equal(_np(tprop), np.asarray(jprop))


@pytest.mark.parametrize("r", REPEATS[1:])
def test_repeat_matches_no_repeat(weights, r):
    """Replication changes no value a query meets: the port's logits at
    r stay within TOL of its own at r = 1, prefill and one decode step."""
    outs = []
    for rr in (1, r):
        _, tm, _, _, tlog, tc = _prefill(weights, rr)
        dlog, _ = tm.decode_step(weights["tp"], _t(weights["nxt"][:, 0]),
                                 tc)
        outs.append((tlog, dlog))
    _close(outs[1][0], outs[0][0])
    _close(outs[1][1], outs[0][1])


# ---------------------------------------------------------------------------
# Abstract caches of the full configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_caches_at_repeat_2_equal_reference(arch):
    tm = Model(get_config(arch), kv_repeat=2, device="cpu")
    jm = JModel(j_config(arch), kv_repeat=2)
    enc = tm.enc_seq(1024)
    got = _port(tm.init_cache(8, 1024, enc_seq=enc, dtype=torch.bfloat16,
                              abstract=True))
    want = _ref(jm.init_cache(8, 1024, enc_seq=enc, dtype=jnp.bfloat16,
                              abstract=True))
    assert got == want
    if tm.supports_physical_paging():
        got = _port(tm.init_paged_cache(8, 128, 16, 1024, abstract=True))
        want = _ref(jm.init_paged_cache(8, 128, 16, 1024, abstract=True))
        assert got == want


# ---------------------------------------------------------------------------
# The serving engine
# ---------------------------------------------------------------------------

CAP = 100           # KV capacity (tokens): tight enough to preempt


def _trace(make, spec, vocab):
    rng = np.random.default_rng(1)
    out = []
    for i in range(10):
        plen = int(rng.integers(5, 30))
        out.append(make(rid=i, arrival=i * 0.01, prompt_len=plen,
                        output_len=12, spec=spec(ttft=1.0, tds=4.8),
                        prompt_tokens=rng.integers(0, vocab, plen)))
    return out


@pytest.mark.parametrize("kw", [dict(preemption_mode="swap"),
                                dict(preemption_mode="recompute",
                                     page_size=16)],
                         ids=["swap", "recompute-paged16"])
def test_engine_at_repeat_2_matches_reference(kw):
    cfg = j_smoke("llama3-8b")
    jm = JModel(cfg, kv_repeat=2)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config("llama3-8b"), kv_repeat=2, device="cpu")
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jlat = JLat(cfg, J_TPU_V5E)
    jeng = JEngine(jm, jp, j_make_scheduler("andes", CAP, jlat,
                                            JSchedCfg(delta_t=2.0)),
                   jlat, num_slots=4, max_seq=64, capacity_tokens=CAP, **kw)
    jout = jeng.run(_trace(JRequest, JSpec, cfg.vocab_size),
                    max_iterations=4000)
    lat = LatencyModel(tm.cfg, TPU_V5E)
    teng = ServingEngine(tm, tp, make_scheduler("andes", CAP, lat,
                                                SchedulerConfig(delta_t=2.0)),
                         lat, num_slots=4, max_seq=64, capacity_tokens=CAP,
                         device="cpu", **kw)
    tout = teng.run(_trace(Request, QoESpec, cfg.vocab_size),
                    max_iterations=4000)
    assert teng.preemptions > 0, "the trace must preempt"
    assert teng.cache["k"].shape[-2] == cfg.num_kv_heads * 2
    assert timing_fingerprint(tout) == j_timing(jout)
    assert all(r.generated == r.output_len for r in tout)
    flips = audit_flips(jm, jp, jout, tout)
    assert all_flips_documented(flips), flips


# ---------------------------------------------------------------------------
# The decode kernels' launch plan at the replicated head counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", [8, 16, 32])
@pytest.mark.parametrize("b", [1, 4, 8, 128])
@pytest.mark.parametrize("cap", [64, 1024, 1028, 32768])
def test_decode_plan_covers_the_cache(cap, b, kv):
    """``cuda.decode_plan`` at llama3-8b's KV 8 and at kv_repeat 2 and 4
    (KV 16 and 32, hd 128, bf16): the splits cover [0, cap) once, none is
    empty, chunks are multiples of 16 within the shared-memory budget."""
    from repro_torch.kernels import cuda as kc
    chunk, splits = kc.decode_plan(cap, b, kv, 128, 2)
    assert chunk % 16 == 0 and chunk >= 16
    assert (splits - 1) * chunk < cap <= splits * chunk
    assert 2 * chunk * (128 * 2 + 16) <= kc.DECODE_KV_SMEM
