"""The port's plain attention versions against the JAX reference (CPU).

The same numpy inputs go through the reference's Pallas kernels (in
interpret mode) or its jnp oracle and through the port's plain PyTorch
versions (``repro_torch.kernels.ref``), in f32 at the reference's kernel
tolerance (2e-5, ``tests/test_kernels.py``). The plain backward
(``attention_bwd_ref``, from the output and ``attention_lse_ref``) is held
against torch autograd of ``attention_ref`` and against ``jax.vjp`` of
the reference's ``attention_ref``: the reference trains through XLA's
autodiff of that function, and the backward kernels are held against
this plain version on the card. Also pinned: the paged plain
version is bitwise the contiguous one, and the dispatch sends CPU tensors
to the plain versions (the CUDA wrappers refuse them). The CUDA kernels
themselves are held against these plain versions in
``tests/test_torch_cuda.py``, on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.paged_attention import paged_decode_attention as j_paged
from repro_torch.kernels import cuda as tcuda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)
TOL = 2e-5      # f32, as tests/test_kernels.py


def _rand(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


def _paginate(k, v, lengths, page, seed=0):
    """Scatter contiguous (B, S, KV, hd) caches into a shuffled page pool
    whose unowned rows hold noise; sentinel table entries = P."""
    b, s, kvh, hd = k.shape
    max_pages = -(-s // page)
    pad = max_pages * page - s
    kp = np.pad(k, ((0, 0), (0, pad), (0, 0), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
    needed = [-(-int(n) // page) for n in lengths]
    p_total = sum(needed) + 3
    rng = np.random.default_rng(seed)
    ids = list(rng.permutation(p_total))
    k_pool = rng.normal(size=(p_total, page, kvh, hd)).astype(np.float32)
    v_pool = rng.normal(size=(p_total, page, kvh, hd)).astype(np.float32)
    tables = np.full((b, max_pages), p_total, np.int32)
    for bi in range(b):
        for pi in range(needed[bi]):
            pid = ids.pop()
            tables[bi, pi] = pid
            k_pool[pid] = kp[bi, pi * page:(pi + 1) * page]
            v_pool[pid] = vp[bi, pi * page:(pi + 1) * page]
    return k_pool, v_pool, tables


# hd 80: the shared attention of zamba2-2.7b (2560 / 32); ids of the hd-32
# cases stay as they were
HD_CASES = [pytest.param(None, 32, id="None"), pytest.param(8, 32, id="8"),
            pytest.param(None, 80, id="None-hd80"),
            pytest.param(8, 80, id="8-hd80")]


@pytest.mark.parametrize("window,hd", HD_CASES)
def test_decode_plain_matches_pallas(window, hd):
    b, s, h, kv = 3, 64, 8, 2
    q, k, v = _rand(0, (b, h, hd)), _rand(1, (b, s, kv, hd)), \
        _rand(2, (b, s, kv, hd))
    lengths = np.array([64, 17, 1], np.int32)
    expect = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(lengths), window=window, interpret=True)
    out = tref.decode_attention_ref(_t(q), _t(k), _t(v), _t(lengths),
                                    window=window)
    _close(out, expect)


@pytest.mark.parametrize("window,hd", HD_CASES)
def test_paged_plain_matches_pallas(window, hd):
    b, s, h, kv, page = 3, 64, 8, 2, 16
    q, k, v = _rand(3, (b, h, hd)), _rand(4, (b, s, kv, hd)), \
        _rand(5, (b, s, kv, hd))
    lengths = np.array([64, 30, 5], np.int32)
    kp, vp, bt = _paginate(k, v, lengths, page)
    expect = j_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                     jnp.asarray(bt), jnp.asarray(lengths), window=window,
                     interpret=True)
    out = tref.paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(bt),
                                          _t(lengths), window=window)
    _close(out, expect)


@pytest.mark.parametrize("causal,window,hd", [
    pytest.param(True, None, 32, id="True-None"),
    pytest.param(False, None, 32, id="False-None"),
    pytest.param(True, 24, 32, id="True-24"),
    pytest.param(True, None, 80, id="True-None-hd80"),
    pytest.param(False, None, 80, id="False-None-hd80"),
    pytest.param(True, 24, 80, id="True-24-hd80")])
def test_attention_plain_matches_pallas_flash(causal, window, hd):
    b, s, h, kv = 2, 96, 4, 2
    q, k, v = _rand(6, (b, s, h, hd)), _rand(7, (b, s, kv, hd)), \
        _rand(8, (b, s, kv, hd))
    expect = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window, block_q=32, block_k=32,
                     interpret=True)
    out = tref.attention_ref(_t(q), _t(k), _t(v), causal=causal,
                             window=window)
    _close(out, expect)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_plain_lengths_qoffset_match_reference(causal):
    """The serving path's masks — per-row lengths (right-padded buckets,
    one empty row) and query offsets — against the jnp oracle."""
    b, sq, sk, h, kv, hd = 3, 16, 40, 4, 1, 32
    q, k, v = _rand(9, (b, sq, h, hd)), _rand(10, (b, sk, kv, hd)), \
        _rand(11, (b, sk, kv, hd))
    lengths = np.array([40, 23, 0], np.int32)
    q_offset = np.array([24, 7, 0], np.int32)
    for kw in ({"lengths": lengths}, {"lengths": lengths,
                                      "q_offset": q_offset},
               {"q_offset": q_offset, "window": 5}):
        expect = jref.attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            **{n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
               for n, a in kw.items()})
        out = tref.attention_ref(
            _t(q), _t(k), _t(v), causal=causal,
            **{n: (_t(a) if isinstance(a, np.ndarray) else a)
               for n, a in kw.items()})
        _close(out, expect)


BWD_CASES = [
    # (b, sq, sk, h, kv, causal, window, lengths): GQA G = 1, 4, 8
    pytest.param(2, 24, 24, 4, 4, True, None, None, id="causal-G1"),
    pytest.param(2, 24, 24, 8, 2, True, 7, None, id="window-G4"),
    pytest.param(2, 24, 24, 8, 1, True, None, [24, 9], id="ragged-G8"),
    pytest.param(2, 20, 13, 4, 1, False, None, [13, 5], id="bidir-sq>sk-G4"),
    pytest.param(2, 9, 30, 8, 8, False, None, [30, 17], id="bidir-sq<sk-G1"),
]


@pytest.mark.parametrize("b,sq,sk,h,kv,causal,window,lens", BWD_CASES)
def test_attention_bwd_plain_matches_autograd_and_jax(b, sq, sk, h, kv,
                                                      causal, window, lens):
    import jax
    hd = 32
    q, k, v = _rand(20, (b, sq, h, hd)), _rand(21, (b, sk, kv, hd)), \
        _rand(22, (b, sk, kv, hd))
    dout = _rand(23, (b, sq, h, hd))
    lengths = None if lens is None else np.array(lens, np.int32)
    kw = dict(causal=causal, window=window)
    tkw = dict(kw, lengths=None if lengths is None else _t(lengths))
    jkw = dict(kw, lengths=None if lengths is None else jnp.asarray(lengths))
    out = tref.attention_ref(_t(q), _t(k), _t(v), **tkw)
    lse = tref.attention_lse_ref(_t(q), _t(k), _t(v), **tkw)
    assert torch.isfinite(lse).all()
    got = tref.attention_bwd_ref(_t(q), _t(k), _t(v), out, lse, _t(dout),
                                 **tkw)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(tref.attention_ref(*leaves, **tkw), leaves,
                               _t(dout))
    _, vjp = jax.vjp(lambda a, b_, c: jref.attention_ref(a, b_, c, **jkw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, a, j in zip(got, auto, vjp(jnp.asarray(dout))):
        assert g.shape == a.shape
        _close(g, a.detach())
        _close(g, j)


def test_attention_bwd_plain_empty_row_has_no_gradient():
    """A row with nothing to attend (length 0) has lse = -inf and, as in
    the kernels, zero gradients, where attention_ref would average."""
    q, k, v = _rand(24, (2, 8, 4, 32)), _rand(25, (2, 8, 2, 32)), \
        _rand(26, (2, 8, 2, 32))
    lengths = _t(np.array([8, 0], np.int32))
    lse = tref.attention_lse_ref(_t(q), _t(k), _t(v), lengths=lengths)
    assert torch.isinf(lse[1]).all() and torch.isfinite(lse[0]).all()
    out = tref.attention_ref(_t(q), _t(k), _t(v), lengths=lengths)
    dq, dk, dv = tref.attention_bwd_ref(_t(q), _t(k), _t(v), out, lse,
                                        _t(_rand(27, (2, 8, 4, 32))),
                                        lengths=lengths)
    assert not dq[1].any() and not dk[1].any() and not dv[1].any()
    assert torch.isfinite(dq).all() and dq[0].abs().max() > 0


def test_paged_plain_bitwise_equals_contiguous():
    """With max_pages * page == S the paged gather rebuilds the contiguous
    view exactly, so the two plain versions agree bit for bit — the
    property the engine's physical-vs-contiguous identity rests on."""
    b, s, h, kv, hd = 3, 64, 4, 2, 32
    q, k, v = _rand(12, (b, h, hd)), _rand(13, (b, s, kv, hd)), \
        _rand(14, (b, s, kv, hd))
    lengths = np.array([64, 17, 40], np.int32)
    expect = tref.decode_attention_ref(_t(q), _t(k), _t(v), _t(lengths))
    for page in (1, 8, 16, 64):
        kp, vp, bt = _paginate(k, v, lengths, page, seed=page)
        out = tref.paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(bt),
                                              _t(lengths))
        assert torch.equal(out, expect), page


def test_dispatch_sends_cpu_tensors_to_plain_versions():
    b, s, h, kv, hd, page = 2, 32, 4, 2, 32, 8
    q1, k, v = _rand(15, (b, h, hd)), _rand(16, (b, s, kv, hd)), \
        _rand(17, (b, s, kv, hd))
    qs = _rand(18, (b, s, h, hd))
    lengths = np.array([32, 9], np.int32)
    kp, vp, bt = _paginate(k, v, lengths, page)
    tcuda.reset_launches()
    assert torch.equal(
        tops.decode_attention(_t(q1), _t(k), _t(v), _t(lengths)),
        tref.decode_attention_ref(_t(q1), _t(k), _t(v), _t(lengths)))
    assert torch.equal(
        tops.paged_decode_attention(_t(q1), _t(kp), _t(vp), _t(bt),
                                    _t(lengths)),
        tref.paged_decode_attention_ref(_t(q1), _t(kp), _t(vp), _t(bt),
                                        _t(lengths)))
    assert torch.equal(
        tops.attention(_t(qs), _t(k), _t(v), lengths=_t(lengths)),
        tref.attention_ref(_t(qs), _t(k), _t(v), lengths=_t(lengths)))
    assert all(n == 0 for n in tcuda.launches.values())


def test_cuda_wrappers_refuse_cpu_tensors():
    """No silent fallback: the kernel wrappers take CUDA tensors only."""
    q, k = torch.zeros(1, 4, 32), torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tcuda.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        tcuda.flash_attention(torch.zeros(1, 8, 4, 32), k, k)
    with pytest.raises(ValueError, match="CUDA"):
        tcuda.paged_decode_attention(
            q, torch.zeros(3, 4, 2, 32), torch.zeros(3, 4, 2, 32),
            torch.zeros(1, 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))
    assert all(n == 0 for n in tcuda.launches.values())


def test_cuda_wrappers_refuse_grad_mode_before_anything_else():
    """A kernel without a backward would hand autograd an output with no
    history and drop its inputs' gradients silently; in grad mode with an
    input that requires grad each wrapper raises, naming what is missing,
    before any other check."""
    q = torch.zeros(1, 4, 32, requires_grad=True)
    k = torch.zeros(1, 8, 2, 32)
    lengths = torch.ones(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="decode_attention has no backward"):
        tcuda.decode_attention(q, k, k, lengths)
    with pytest.raises(RuntimeError,
                       match="paged_decode_attention has no backward"):
        tcuda.paged_decode_attention(q, torch.zeros(3, 4, 2, 32),
                                     torch.zeros(3, 4, 2, 32),
                                     torch.zeros(1, 2, dtype=torch.int32),
                                     lengths)
    with pytest.raises(RuntimeError, match="ops.attention"):
        tcuda.flash_attention(torch.zeros(1, 8, 4, 32, requires_grad=True),
                              k, k)
    x = torch.zeros(1, 8, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="ops.selective_scan or ops.ssd"):
        tcuda.selective_scan(x, x.detach(), torch.zeros(32, 16),
                             torch.zeros(1, 8, 16), torch.zeros(1, 8, 16),
                             torch.zeros(32))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        tcuda.decode_attention(q, k, k, lengths)     # no grad mode: no guard
    assert all(n == 0 for n in tcuda.launches.values())


def test_unsupported_head_dim_raises_before_launch():
    q = torch.zeros(1, 4, 48)
    k = torch.zeros(1, 8, 2, 48)
    with pytest.raises(ValueError, match="unsupported"):
        tcuda.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32))


def test_cuda_wrappers_take_hd80_and_refuse_hd48():
    """hd 80 passes the shape checks of both kernels (it reaches the
    device check, which a CPU tensor fails); hd 48 stays refused."""
    for hd, match in ((80, "CUDA"), (48, "unsupported")):
        q, k = torch.zeros(1, 4, hd), torch.zeros(1, 8, 2, hd)
        with pytest.raises(ValueError, match=match):
            tcuda.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32))
        with pytest.raises(ValueError, match=match):
            tcuda.paged_decode_attention(
                q, torch.zeros(3, 4, 2, hd), torch.zeros(3, 4, 2, hd),
                torch.zeros(1, 2, dtype=torch.int32),
                torch.ones(1, dtype=torch.int32))
        with pytest.raises(ValueError, match=match):
            tcuda.flash_attention(torch.zeros(1, 8, 4, hd), k, k)
    assert all(n == 0 for n in tcuda.launches.values())


@pytest.mark.parametrize("cap,b,kv,hd,itemsize", [
    (1024, 8, 8, 128, 2),      # the llama3 main path, contiguous
    (1024, 1, 8, 128, 2),      # one row: more, shorter splits
    (1000, 8, 8, 128, 2),      # not a multiple of the chunk
    (64 * 16, 8, 8, 128, 2),   # paged: max_pages 64 x page 16
    (5 * 100, 4, 2, 64, 4),    # paged: pages deeper than a chunk
    (37 * 1, 2, 4, 80, 4),     # paged: page 1, f32, hd 80
    (1, 1, 1, 32, 4), (0, 3, 2, 32, 2), (70000, 2, 8, 256, 4)])
def test_decode_plan_covers_capacity_once(cap, b, kv, hd, itemsize):
    """Split s covers [s * chunk, min((s + 1) * chunk, cap)): together
    [0, cap) exactly once, no split empty (for cap > 0), chunks a multiple
    of 16 within the shared-memory budget."""
    chunk, splits = tcuda.decode_plan(cap, b, kv, hd, itemsize)
    assert chunk % 16 == 0 and splits >= 1
    assert 2 * chunk * (hd * itemsize + 16) <= max(
        tcuda.DECODE_KV_SMEM, 2 * 16 * (hd * itemsize + 16))
    seen = np.zeros(cap, np.int64)
    for s in range(splits):
        lo, hi = s * chunk, min((s + 1) * chunk, cap)
        assert hi > lo or cap == 0
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert splits * chunk >= cap
    # host-known shapes only: the same plan whatever the lengths are
    assert tcuda.decode_plan(cap, b, kv, hd, itemsize) == (chunk, splits)


def test_flash_plan_takes_tall_tiles_only_on_full_grids():
    """128-row query tiles (8 warps) when the grid keeps about a block per
    SM, 64-row tiles (4 warps) below that; H = 32 as llama3-8b."""
    assert tcuda.flash_plan(4, 512, 32) == 8      # 512 blocks
    assert tcuda.flash_plan(1, 512, 32) == 8      # 128 blocks
    assert tcuda.flash_plan(1, 128, 32) == 4      # 32 blocks
    assert tcuda.flash_plan(2, 40, 4) == 4


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("b,s,d,n", [
    (1, 512, 8192, 16),        # falcon-mamba-7b, the engine's 1 x 512
    (4, 512, 8192, 16),        # falcon-mamba-7b, a 4-row group
    (2, 77, 200, 16),          # ragged S and D
    (1, 45, 36, 16),           # D * 2 bytes not a multiple of 16
    (2, 21, 35, 8),            # odd D
    (3, 40, 96, 4), (1, 20, 48, 32), (2, 19, 40, 64),
    (1, 1, 1, 16), (8, 3000, 5000, 64)])
def test_scan_plan_covers_every_state_once(b, s, d, n, itemsize):
    """Block (i, bb), lane l, warp g own batch row bb, channel 32 i + l
    (when < d) and states [g npl, (g + 1) npl): together every (b, d, n)
    exactly once. npl divides n; the block has 1 to 16 warps; the steps
    per chunk are a count the kernel takes, and an SM holds two blocks."""
    plan = tcuda.scan_plan(b, s, d, n, itemsize)
    assert n % plan.npl == 0 and plan.npl in tcuda.SCAN_NPL
    assert plan.threads == 32 * (n // plan.npl)
    assert 32 <= plan.threads <= 512
    assert plan.steps in tcuda.SCAN_STEPS
    assert tcuda.scan_resident_blocks(plan.steps, n, plan.npl, itemsize) >= 2
    seen = np.zeros((b, d, n), np.int64)
    gx, gy = plan.grid
    assert gy == b
    for i in range(gx):
        for g in range(plan.threads // 32):
            ch = np.arange(32 * i, 32 * i + 32)
            ch = ch[ch < d]
            seen[:, ch, g * plan.npl:(g + 1) * plan.npl] += 1
    assert (seen == 1).all()
    # host-known shapes only: the same plan for the same shapes
    assert tcuda.scan_plan(b, s, d, n, itemsize) == plan


@pytest.mark.parametrize("n", tcuda.SCAN_STATES)
def test_scan_plan_states_per_thread_divide_n(n):
    """Every states-per-thread option divides N with at most 16 warps a
    block, for every d_state the kernel takes."""
    opts = tcuda.scan_npl_options(n)
    assert opts
    assert all(n % p == 0 and n // p <= 16 for p in opts)


def test_scan_plan_gives_one_row_more_threads_per_channel():
    """At B=1 (the engine's 1 x 512, falcon-mamba-7b widths) the plan
    takes fewer states per thread, so more threads per channel, than at
    B=4, where the grid alone fills the card."""
    one = tcuda.scan_plan(1, 512, 8192, 16)
    four = tcuda.scan_plan(4, 512, 8192, 16)
    assert 16 // one.npl > 16 // four.npl
    # warps per SM at B=1: at least SCAN_MIN_WARPS on the busiest SMs
    blocks = one.grid[0] * one.grid[1]
    assert -(-blocks // tcuda.SCAN_SMS) * (one.threads // 32) \
        >= tcuda.SCAN_MIN_WARPS
    # the plans scripts/scan_plan_sweep.py measured fastest on the card
    assert (one.npl, one.steps) == (4, 64)
    assert (four.npl, four.steps) == (8, 32)

