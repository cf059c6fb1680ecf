"""The port's dense model against the JAX reference model (CPU, f32).

Bridged weights of the ``llama3-8b`` smoke config (2 layers) go through
``repro.models.Model(cfg, impl="ref")`` and ``repro_torch.models.Model``:
prefill logits and caches (right-padded rows with ``lengths``, one empty
row), decode logits over the contiguous cache and over page pools (page
sizes 1, 16 and one page spanning the whole context), and a multi-step
block. Tolerance: 1e-4 absolute on logits and caches — two f32 layers
whose matmuls and softmaxes reduce in another order in each framework.

Also pinned, one by one, the out-of-range rules of JAX that the port
spells out: the clamped contiguous write, dropped sentinel scatters and
the clamped page index in paged decode, dropped positions in
``paged_write_tokens``, clamped gathers, dropped sentinel rows in the
engine's slot scatter, and first-max argmax ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models import cache as jcache
from repro.serving import engine as jengine
from repro_torch.bridge import from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.models import attention as tattn
from repro_torch.models import cache as tcache
from repro_torch.models.model import _argmax_ids
from repro_torch.models.transformer import layer_params
from repro_torch.serving import engine as tengine

torch.set_num_threads(1)
TOL = 1e-4
S = 48                                    # cache depth
LENS = np.array([20, 33, 7, 0], np.int32)  # right-padded rows + empty row
SEQ = 40                                  # padded prompt bucket


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=0)


@pytest.fixture(scope="module")
def setup():
    cfg = j_smoke("llama3-8b")
    jm = JModel(cfg, impl="ref")
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config("llama3-8b"), device="cpu")
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    tokens = np.zeros((len(LENS), SEQ), np.int32)
    for i, n in enumerate(LENS):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)
    jlog, jc = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(tokens), "lengths": jnp.asarray(LENS)},
        jm.init_cache(len(LENS), S))
    tlog, tc = tm.prefill(tp, {"tokens": _t(tokens), "lengths": _t(LENS)},
                          tm.init_cache(len(LENS), S))
    return dict(cfg=cfg, jm=jm, jp=jp, tm=tm, tp=tp, tokens=tokens,
                jlog=jlog, jc=jc, tlog=tlog, tc=tc, rng=rng)


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def test_prefill_logits_and_cache(setup):
    s = setup
    _close(s["tlog"], s["jlog"])
    for key in ("k", "v"):
        _close(s["tc"][key], s["jc"][key])
    np.testing.assert_array_equal(_np(s["tc"]["length"]), LENS)


def test_prefill_without_lengths_is_full_length(setup):
    s = setup
    toks = s["tokens"][:1, :20]
    jlog, _ = jax.jit(s["jm"].prefill)(s["jp"], {"tokens": jnp.asarray(toks)},
                                       s["jm"].init_cache(1, S))
    tlog, tc = s["tm"].prefill(s["tp"], {"tokens": _t(toks)},
                               s["tm"].init_cache(1, S))
    _close(tlog, jlog)
    assert int(tc["length"][0]) == 20


def test_decode_step_contiguous(setup):
    s = setup
    nxt = np.array([5, 9, 77, 3], np.int32)
    jlog, jc = s["jm"].decode_step(s["jp"], jnp.asarray(nxt), s["jc"])
    tlog, tc = s["tm"].decode_step(s["tp"], _t(nxt), _clone(s["tc"]))
    _close(tlog, jlog)
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    np.testing.assert_array_equal(_np(tc["length"]), _np(jc["length"]))


def _paged_from(cfg, jc, page, seed):
    """Commit the prefilled contiguous rows into a shuffled pool through
    `paged_write_tokens` (counts = length + 1, as the engine commits) and
    return the JAX pool cache plus its tables."""
    b = jc["length"].shape[0]
    max_pages = -(-S // page)
    need = [-(-(int(n) + 2) // page) for n in LENS]     # + this decode
    p_total = sum(need) + 2
    ids = list(np.random.default_rng(seed).permutation(p_total))
    bt = np.full((b, max_pages), p_total, np.int32)
    for i, n in enumerate(need):
        for j in range(min(n, max_pages)):
            bt[i, j] = ids.pop()
    pc = jcache.init_paged_cache(cfg, b, p_total, page, S,
                                 dtype=jnp.float32)
    counts = jnp.asarray(LENS + 1)
    starts = jnp.zeros_like(counts)
    pc = dict(pc,
              k=jcache.paged_write_tokens(pc["k"], jnp.asarray(bt), starts,
                                          jc["k"], counts),
              v=jcache.paged_write_tokens(pc["v"], jnp.asarray(bt), starts,
                                          jc["v"], counts),
              block_tables=jnp.asarray(bt), length=jc["length"])
    return pc, bt, p_total


@pytest.mark.parametrize("page", [1, 16, S])
def test_decode_step_paged(setup, page):
    s = setup
    cfg = s["cfg"]
    pc, bt, p_total = _paged_from(cfg, s["jc"], page, seed=page)
    # the port's own commit of its own prefill rows lands the same bytes
    tpc = tcache.init_paged_cache(get_smoke_config("llama3-8b"), len(LENS),
                                  p_total, page, S, dtype=torch.float32,
                                  device="cpu")
    tpc = tcache.with_block_tables(tpc, bt)
    counts = _t(LENS + 1)
    tcache.paged_write_tokens(tpc["k"], tpc["block_tables"],
                              torch.zeros_like(counts), s["tc"]["k"], counts)
    tcache.paged_write_tokens(tpc["v"], tpc["block_tables"],
                              torch.zeros_like(counts), s["tc"]["v"], counts)
    tpc = tcache.with_lengths(tpc, LENS)
    _close(tpc["k"], pc["k"])
    nxt = np.array([1, 2, 3, 4], np.int32)
    jlog, jpc = jax.jit(s["jm"].decode_step)(s["jp"], jnp.asarray(nxt), pc)
    tlog, tpc2 = s["tm"].decode_step(s["tp"], _t(nxt), tpc)
    _close(tlog, jlog)
    _close(tpc2["k"], jpc["k"])
    _close(tpc2["v"], jpc["v"])
    # and the paged decode is the contiguous decode (rows whose pages
    # cover the context; the empty row attends a clamped page)
    clog, _ = s["tm"].decode_step(s["tp"], _t(nxt), _clone(s["tc"]))
    _close(tlog[:3], clog[:3])


def test_decode_multi_block(setup):
    s = setup
    nxt = np.array([11, 12, 13, 14], np.int32)
    jids, jc = s["jm"].decode_multi(s["jp"], jnp.asarray(nxt), s["jc"], j=4)
    tids, tc = s["tm"].decode_multi(s["tp"], _t(nxt), _clone(s["tc"]), 4)
    np.testing.assert_array_equal(_np(tids), _np(jids))
    _close(tc["k"], jc["k"])
    pids, _, steps = s["tm"].decode_persistent(
        s["tp"], _t(nxt), _clone(s["tc"]), 3, j_cap=8)
    assert steps == 3
    np.testing.assert_array_equal(_np(pids[:3]), _np(jids[:3]))
    assert not pids[3:].any()


# ---------------------------------------------------------------------------
# JAX out-of-range rules the port spells out
# ---------------------------------------------------------------------------

def _layer0(s):
    jl = jax.tree.map(lambda t: t[0], s["jp"]["blocks"]["attn"])
    tl = layer_params(s["tp"]["blocks"]["attn"], 0)
    return jl, tl


def test_contiguous_write_clamps_to_last_position(setup):
    """dynamic_update_slice clamps a write at S to S-1."""
    s = setup
    cfg = s["cfg"]
    jl, tl = _layer0(s)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, cfg.d_model)).astype(np.float32)
    kc = rng.normal(size=(3, S, cfg.num_kv_heads, cfg.head_dim)).astype(
        np.float32)
    vc = rng.normal(size=kc.shape).astype(np.float32)
    lengths = np.array([S, S - 1, 3], np.int32)
    jo, jk, jv = jax.jit(jattn.attn_decode, static_argnums=5)(
        jl, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lengths), cfg)
    to, tk, tv = tattn.attn_decode(tl, _t(x), _t(kc), _t(vc), _t(lengths),
                                   get_smoke_config("llama3-8b"))
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)


def test_paged_write_drops_sentinels_and_clamps_page_index(setup):
    """Row 0 owns no page (all-sentinel table): its write drops. Row 1's
    position lies past the table width: the page index clamps to the
    last entry. Row 2 is an ordinary write."""
    s = setup
    cfg = s["cfg"]
    jl, tl = _layer0(s)
    page, max_pages, p_total = 4, 3, 7
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, cfg.d_model)).astype(np.float32)
    shape = (p_total, page, cfg.num_kv_heads, cfg.head_dim)
    kp = rng.normal(size=shape).astype(np.float32)
    vp = rng.normal(size=shape).astype(np.float32)
    bt = np.array([[7, 7, 7], [0, 4, 2], [5, 1, 7]], np.int32)
    lengths = np.array([0, 13, 6], np.int32)
    jo, jk, jv = jax.jit(jattn.attn_decode_paged, static_argnums=6)(
        jl, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt), jnp.asarray(lengths), cfg)
    tk, tv = _t(kp), _t(vp)
    to, _, _ = tattn.attn_decode_paged(tl, _t(x), tk, tv, _t(bt),
                                       _t(lengths),
                                       get_smoke_config("llama3-8b"))
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)
    # every write dropped: the pool is untouched
    tk0 = _t(kp)
    tattn.attn_decode_paged(tl, _t(x), tk0, _t(vp), _t(np.full_like(bt, 7)),
                            _t(lengths), get_smoke_config("llama3-8b"))
    assert torch.equal(tk0, _t(kp))


def test_paged_write_tokens_and_gather_match_reference():
    rng = np.random.default_rng(3)
    L, p_total, page, kv, hd, n = 2, 6, 4, 2, 8, 10
    pool = rng.normal(size=(L, p_total, page, kv, hd)).astype(np.float32)
    seg = rng.normal(size=(L, 3, n, kv, hd)).astype(np.float32)
    bt = np.array([[3, 1, 6], [6, 6, 6], [0, 2, 5]], np.int32)
    starts = np.array([2, 0, 0], np.int32)
    counts = np.array([9, 5, 12], np.int32)   # row 0 runs past its pages
    jpool = jcache.paged_write_tokens(jnp.asarray(pool), jnp.asarray(bt),
                                      jnp.asarray(starts), jnp.asarray(seg),
                                      jnp.asarray(counts))
    tpool = tcache.paged_write_tokens(_t(pool), _t(bt), _t(starts), _t(seg),
                                      _t(counts))
    np.testing.assert_array_equal(_np(tpool), _np(jpool))
    for max_seq in (12, 9):
        np.testing.assert_array_equal(
            _np(tcache.paged_gather_rows(tpool, _t(bt), max_seq)),
            _np(jcache.paged_gather_rows(jpool, jnp.asarray(bt), max_seq)))


def test_write_slots_drops_sentinel_rows(setup):
    cfg = setup["cfg"]
    jc = jcache.init_cache(cfg, 3, 8, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    src = {"length": np.array([5, 6, 7, 8], np.int32),
           "k": rng.normal(size=(2, 4, 8, 2, 32)).astype(np.float32),
           "v": rng.normal(size=(2, 4, 8, 2, 32)).astype(np.float32)}
    slots = np.array([2, 0, 3, 3], np.int32)       # 3 = sentinel
    jout = jengine._write_slots(jc, jax.tree.map(jnp.asarray, src),
                                jnp.asarray(slots))
    tc = tcache.init_cache(get_smoke_config("llama3-8b"), 3, 8,
                           dtype=torch.float32, device="cpu")
    tout = tengine._write_slots(tc, {k: _t(v) for k, v in src.items()},
                                slots)
    for key in ("length", "k", "v"):
        np.testing.assert_array_equal(_np(tout[key]), _np(jout[key]))


def test_argmax_ties_break_to_first_max():
    logits = np.zeros((3, 16), np.float32)
    logits[0, [3, 9]] = 2.0
    logits[1, [0, 15]] = 1.0
    logits[2, :] = -1.0
    np.testing.assert_array_equal(_np(_argmax_ids(_t(logits))),
                                  np.asarray(jnp.argmax(logits, axis=-1)))
