"""The port's plain attention versions against the JAX reference (CPU).

The same numpy inputs go through the reference's Pallas kernels (in
interpret mode) or its jnp oracle and through the port's plain PyTorch
versions (``repro_torch.kernels.ref``), in f32 at the reference's kernel
tolerance (2e-5, ``tests/test_kernels.py``). Also pinned: the paged plain
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


@pytest.mark.parametrize("window", [None, 8])
def test_decode_plain_matches_pallas(window):
    b, s, h, kv, hd = 3, 64, 8, 2, 32
    q, k, v = _rand(0, (b, h, hd)), _rand(1, (b, s, kv, hd)), \
        _rand(2, (b, s, kv, hd))
    lengths = np.array([64, 17, 1], np.int32)
    expect = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(lengths), window=window, interpret=True)
    out = tref.decode_attention_ref(_t(q), _t(k), _t(v), _t(lengths),
                                    window=window)
    _close(out, expect)


@pytest.mark.parametrize("window", [None, 8])
def test_paged_plain_matches_pallas(window):
    b, s, h, kv, hd, page = 3, 64, 8, 2, 32, 16
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


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 24)])
def test_attention_plain_matches_pallas_flash(causal, window):
    b, s, h, kv, hd = 2, 96, 4, 2, 32
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


def test_unsupported_head_dim_raises_before_launch():
    q = torch.zeros(1, 4, 48)
    k = torch.zeros(1, 8, 2, 48)
    with pytest.raises(ValueError, match="unsupported"):
        tcuda.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32))
