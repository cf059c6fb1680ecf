"""The hand-written CUDA kernels against their plain PyTorch versions.

Needs an NVIDIA GPU (marker ``cuda``): a CUDA kernel has no interpret
mode, so without a card every test here skips. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs on a machine that has none. The
kernels build from ``src/repro_torch/kernels/csrc`` on first use.
Tolerances are the reference's kernel tolerances (f32 2e-5, bf16 2e-2,
``tests/test_kernels.py``; the scan relative to max |y|, f32 1e-5). Where nothing is attended (length 0, or a
window that excludes every key) the kernels write zeros — the Pallas
convention — while the plain versions average uniformly; those rows are
checked for zeros and left out of the comparison. The decode kernels'
split-KV edges (lengths at a split boundary and either side of it, a
window that empties whole splits, the in-kernel merge's counters over two
calls in a row, a launch from another thread, as the server's engine
makes) and the tensor-core flash body (bf16; f32 runs the CUDA-core body)
are covered case by case, hd 80 included. Mamba-2 runs on
the scan kernel through ``ops.ssd_scan_args`` and is held against the plain
Mamba-2 recurrence at the scan's tolerances, N 64 and D 5120 included.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cuda as tcuda
from repro_torch.kernels import ref as tref

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(seed, shape, dtype, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=dev, dtype=dtype)


def _close(out, expect, dtype):
    torch.testing.assert_close(out.float(), expect.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _paginate(k, v, lengths, page, seed=0):
    """Shuffled page pool holding the contiguous rows; noise elsewhere."""
    b, s, kvh, hd = k.shape
    max_pages = -(-s // page)
    pad = max_pages * page - s
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    needed = [-(-int(n) // page) for n in lengths.tolist()]
    p_total = sum(needed) + 3
    rng = np.random.default_rng(seed)
    ids = list(rng.permutation(p_total))
    k_pool = torch.randn((p_total, page, kvh, hd), device=k.device).to(k.dtype)
    v_pool = torch.randn((p_total, page, kvh, hd), device=k.device).to(k.dtype)
    tables = torch.full((b, max_pages), p_total, dtype=torch.int32)
    for bi in range(b):
        for pi in range(needed[bi]):
            pid = int(ids.pop())
            tables[bi, pi] = pid
            k_pool[pid] = kp[bi, pi * page:(pi + 1) * page]
            v_pool[pid] = vp[bi, pi * page:(pi + 1) * page]
    return k_pool, v_pool, tables.to(k.device)


DECODE_SHAPES = [(3, 300, 8, 2, 64), (2, 64, 4, 4, 32),
                 (8, 1024, 32, 8, 128), (2, 512, 16, 1, 32),
                 (3, 256, 16, 4, 80), (1, 1024, 32, 8, 128)]


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 32])
def test_decode_kernel(dev, shape, dtype, window):
    b, s, h, kv, hd = shape
    q = _rand(0, (b, h, hd), dtype, dev)
    k = _rand(1, (b, s, kv, hd), dtype, dev)
    v = _rand(2, (b, s, kv, hd), dtype, dev)
    g = torch.Generator().manual_seed(3)
    lengths = torch.randint(1, s + 1, (b,), generator=g).to(torch.int32)
    lengths[0] = s
    lengths = lengths.to(dev)
    n0 = tcuda.launches["decode_attention"]
    out = tcuda.decode_attention(q, k, v, lengths, window=window)
    assert tcuda.launches["decode_attention"] == n0 + 1
    _close(out, tref.decode_attention_ref(q, k, v, lengths, window=window),
           dtype)


def test_decode_kernel_length_conventions(dev):
    b, s, h, kv, hd = 3, 64, 8, 2, 32
    q = _rand(4, (b, h, hd), torch.float32, dev)
    k = _rand(5, (b, s, kv, hd), torch.float32, dev)
    v = _rand(6, (b, s, kv, hd), torch.float32, dev)
    lengths = torch.tensor([0, s + 5, 9], dtype=torch.int32, device=dev)
    out = tcuda.decode_attention(q, k, v, lengths)
    assert torch.equal(out[0], torch.zeros_like(out[0]))   # Pallas: zeros
    # past the cache depth: every position attended, as the plain version
    _close(out[1:], tref.decode_attention_ref(q, k, v, lengths)[1:],
           torch.float32)


@pytest.mark.parametrize("page", [1, 16, 64, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel(dev, page, dtype):
    b, s, h, kv, hd = 4, 64, 8, 2, 64
    q = _rand(7, (b, h, hd), dtype, dev)
    k = _rand(8, (b, s, kv, hd), dtype, dev)
    v = _rand(9, (b, s, kv, hd), dtype, dev)
    lengths = torch.tensor([64, 1, 30, 17], dtype=torch.int32, device=dev)
    kp, vp, bt = _paginate(k, v, lengths, page, seed=page)
    n0 = tcuda.launches["paged_decode_attention"]
    out = tcuda.paged_decode_attention(q, kp, vp, bt, lengths)
    assert tcuda.launches["paged_decode_attention"] == n0 + 1
    _close(out, tref.paged_decode_attention_ref(q, kp, vp, bt, lengths),
           dtype)
    _close(out, tref.decode_attention_ref(q, k, v, lengths), dtype)
    if s % page == 0:
        # same walk, same sums: bitwise the contiguous kernel
        assert torch.equal(out, tcuda.decode_attention(q, k, v, lengths))


@pytest.mark.parametrize("page", [1, 16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_hd80(dev, page, dtype):
    b, s, h, kv, hd = 3, 128, 16, 4, 80
    q = _rand(30, (b, h, hd), dtype, dev)
    k = _rand(31, (b, s, kv, hd), dtype, dev)
    v = _rand(32, (b, s, kv, hd), dtype, dev)
    lengths = torch.tensor([128, 65, 7], dtype=torch.int32, device=dev)
    kp, vp, bt = _paginate(k, v, lengths, page, seed=page)
    out = tcuda.paged_decode_attention(q, kp, vp, bt, lengths)
    _close(out, tref.decode_attention_ref(q, k, v, lengths), dtype)
    assert torch.equal(out, tcuda.decode_attention(q, k, v, lengths))


def _split_lengths(chunk, s):
    """Lengths at a split boundary and one either side, a row of length 0
    among full ones, and the full depth."""
    return [chunk, chunk + 1, chunk - 1, 0, s, 2 * chunk, s - 1]


@pytest.mark.parametrize("page", [1, 16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", ["none", "whole_splits"])
def test_decode_split_boundaries(dev, dtype, window, page):
    """Split-KV edges, contiguous and paged (bitwise equal at pages 1, 16
    and 64), each kernel called twice on the same scratch: the merge
    counters return to zero, so the second call gives the same bits."""
    b, s, h, kv, hd = 7, 1024, 32, 8, 128
    chunk, splits = tcuda.decode_plan(s, b, kv, hd, torch.tensor(
        [], dtype=dtype).element_size())
    assert splits > 1 and chunk < s
    # a window a little over one chunk: whole splits before it are empty
    win = None if window == "none" else chunk + 3
    q = _rand(33, (b, h, hd), dtype, dev)
    k = _rand(34, (b, s, kv, hd), dtype, dev)
    v = _rand(35, (b, s, kv, hd), dtype, dev)
    lengths = torch.tensor(_split_lengths(chunk, s), dtype=torch.int32,
                           device=dev)
    kp, vp, bt = _paginate(k, v, lengths, page, seed=page)
    outs = [tcuda.decode_attention(q, k, v, lengths, window=win)
            for _ in range(2)]
    pouts = [tcuda.paged_decode_attention(q, kp, vp, bt, lengths, window=win)
             for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(pouts[0], pouts[1])
    assert torch.equal(pouts[0], outs[0])
    assert not outs[0][3].any()                     # length 0: zeros
    live = lengths.cpu() > 0
    _close(outs[0][live], tref.decode_attention_ref(
        q, k, v, lengths, window=win)[live], dtype)


def test_decode_one_row_full_depth(dev):
    """B = 1 at depth 1024: the plan's shortest chunks, many splits."""
    s, h, kv, hd = 1024, 32, 8, 128
    chunk, splits = tcuda.decode_plan(s, 1, kv, hd, 2)
    assert splits * kv >= 128        # one block per SM or so for one row
    q = _rand(36, (1, h, hd), torch.bfloat16, dev)
    k = _rand(37, (1, s, kv, hd), torch.bfloat16, dev)
    v = _rand(38, (1, s, kv, hd), torch.bfloat16, dev)
    for n in (s, s - chunk + 1, 1):
        lengths = torch.tensor([n], dtype=torch.int32, device=dev)
        _close(tcuda.decode_attention(q, k, v, lengths),
               tref.decode_attention_ref(q, k, v, lengths), torch.bfloat16)


def test_decode_from_another_thread(dev):
    """The server's engine decodes in its pump thread, not the thread that
    built and first launched the kernels: a launch there on the default
    stream shares that stream's split-KV scratch (keyed by device and
    stream, not by thread) and computes bitwise what the main thread
    computes; a side stream gets a scratch of its own."""
    import threading
    q = _rand(40, (8, 32, 128), torch.bfloat16, dev)
    k = _rand(41, (8, 1024, 8, 128), torch.bfloat16, dev)
    v = _rand(42, (8, 1024, 8, 128), torch.bfloat16, dev)
    lengths = torch.tensor([1024, 700, 5, 64, 1, 333, 512, 900],
                           dtype=torch.int32, device=dev)
    main = tcuda.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    keys = set(tcuda._scratch)
    out = {}

    def run():
        out["default"] = tcuda.decode_attention(q, k, v, lengths)
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            out["side"] = tcuda.decode_attention(q, k, v, lengths)
        side.synchronize()
        out["side_key"] = (q.device.index, side.cuda_stream)

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive()
    torch.cuda.synchronize()
    assert torch.equal(out["default"], main)
    assert torch.equal(out["side"], main)
    assert set(tcuda._scratch) - keys == {out["side_key"]}


def test_paged_kernel_window_and_main_shape(dev):
    b, s, h, kv, hd, page = 8, 1024, 32, 8, 128, 16
    q = _rand(10, (b, h, hd), torch.bfloat16, dev)
    k = _rand(11, (b, s, kv, hd), torch.bfloat16, dev)
    v = _rand(12, (b, s, kv, hd), torch.bfloat16, dev)
    g = torch.Generator().manual_seed(13)
    lengths = torch.randint(1, s + 1, (b,), generator=g).to(torch.int32).to(dev)
    kp, vp, bt = _paginate(k, v, lengths, page)
    for window in (None, 100):
        out = tcuda.paged_decode_attention(q, kp, vp, bt, lengths,
                                           window=window)
        _close(out, tref.decode_attention_ref(q, k, v, lengths,
                                              window=window), torch.bfloat16)


def _attended_rows(b, sq, sk, causal, lengths, q_offset, window, dev):
    """(B, Sq) mask of query rows with at least one unmasked key."""
    kp = torch.arange(sk, device=dev)[None, None, :]
    qp = torch.arange(sq, device=dev)[None, :, None]
    if q_offset is not None:
        qp = qp + q_offset[:, None, None]
    m = torch.ones((b, sq, sk), dtype=torch.bool, device=dev)
    if causal:
        m &= kp <= qp
    if lengths is not None:
        m &= kp < lengths[:, None, None]
    if window is not None:
        m &= kp > qp - window
    return m.any(-1)


FLASH_CASES = [
    # (b, sq, sk, h, kv, hd, causal, lengths, q_offset, window)
    (2, 128, 128, 4, 4, 64, True, None, None, None),
    (2, 200, 200, 8, 2, 32, False, None, None, None),
    (4, 512, 512, 32, 8, 128, True, [512, 300, 77, 0], None, None),
    (3, 96, 96, 8, 2, 64, True, [96, 50, 1], None, 24),
    (2, 40, 100, 4, 1, 32, True, [100, 64], [60, 24], None),
    (2, 70, 70, 4, 2, 128, False, [70, 33], None, None),
    # hd 80 (5 x 16), Sq not a multiple of the 64-row tile
    (2, 77, 77, 8, 2, 80, True, [77, 40], None, None),
    (2, 40, 100, 4, 1, 80, True, [100, 64], [60, 24], None),
    # all-masked rows: length 0, and rows the window leaves nothing
    (3, 64, 64, 4, 2, 64, True, [64, 0, 10], None, 8),
    # several query tiles, offsets and a window over several key tiles
    (2, 130, 300, 8, 4, 128, True, [300, 257], [170, 100], 64),
    # the engine's usual prefill group: one row of a 512 bucket
    (1, 512, 512, 32, 8, 128, True, [389], None, None),
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel(dev, case, dtype):
    b, sq, sk, h, kv, hd, causal, lens, offs, window = case
    q = _rand(14, (b, sq, h, hd), dtype, dev)
    k = _rand(15, (b, sk, kv, hd), dtype, dev)
    v = _rand(16, (b, sk, kv, hd), dtype, dev)
    lengths = (torch.tensor(lens, dtype=torch.int32, device=dev)
               if lens is not None else None)
    q_offset = (torch.tensor(offs, dtype=torch.int32, device=dev)
                if offs is not None else None)
    n0 = tcuda.launches["flash_attention"]
    body = ("flash_attention/tensor_core" if dtype == torch.bfloat16
            else "flash_attention/cuda_core")
    v0 = tcuda.variant_launches[body]
    out = tcuda.flash_attention(q, k, v, causal=causal, window=window,
                                lengths=lengths, q_offset=q_offset)
    assert tcuda.launches["flash_attention"] == n0 + 1
    assert tcuda.variant_launches[body] == v0 + 1
    expect = tref.attention_ref(q, k, v, causal=causal, window=window,
                                lengths=lengths, q_offset=q_offset)
    rows = _attended_rows(b, sq, sk, causal, lengths, q_offset, window, dev)
    _close(out[rows], expect[rows], dtype)
    assert not out[~rows].any()                     # Pallas: zeros


@pytest.mark.parametrize("warps", [4, 8])
@pytest.mark.parametrize("case", [FLASH_CASES[i] for i in (2, 4, 7, 8, 9)])
def test_flash_kernel_tile_heights(dev, case, warps, monkeypatch):
    """The tensor-core body at both query-tile heights (64 and 128 rows),
    whichever the wrapper's plan would pick."""
    b, sq, sk, h, kv, hd, causal, lens, offs, window = case
    dtype = torch.bfloat16
    q = _rand(17, (b, sq, h, hd), dtype, dev)
    k = _rand(18, (b, sk, kv, hd), dtype, dev)
    v = _rand(19, (b, sk, kv, hd), dtype, dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    q_offset = (torch.tensor(offs, dtype=torch.int32, device=dev)
                if offs is not None else None)
    monkeypatch.setattr(tcuda, "flash_plan", lambda *_: warps)
    out = tcuda.flash_attention(q, k, v, causal=causal, window=window,
                                lengths=lengths, q_offset=q_offset)
    expect = tref.attention_ref(q, k, v, causal=causal, window=window,
                                lengths=lengths, q_offset=q_offset)
    rows = _attended_rows(b, sq, sk, causal, lengths, q_offset, window, dev)
    _close(out[rows], expect[rows], dtype)
    assert not out[~rows].any()


SCAN_CASES = [
    # (b, s, d, n): ragged S and D, every d_state the kernel takes, and
    # the main path's width (B=4 and the engine's 1 x 512); D * 2 bytes
    # not a multiple of 16 (4-byte copies of x and dt in bf16) and odd D
    # (element copies in bf16)
    (2, 77, 200, 16), (1, 33, 64, 8), (3, 40, 96, 4), (1, 20, 48, 32),
    (2, 19, 40, 64), (4, 512, 8192, 16), (1, 512, 8192, 16),
    (1, 45, 36, 16), (2, 21, 35, 8),
]


def _scan_args(b, s, d, n, dtype, dev, seed=20):
    """Scan inputs as the model hands them over: B and C are column slices
    of one projection (strided views), dt is zero past each row's length."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, s, d), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((b, s, d), generator=g) - 1)
    lens = torch.randint(1, s + 1, (b,), generator=g)
    lens[0] = s
    dt = dt.masked_fill(torch.arange(s)[None, :, None] >= lens[:, None, None],
                        0.0)
    A = -torch.exp(torch.randn((d, n), generator=g) * 0.5)
    dbc = torch.randn((b, s, 5 + 2 * n), generator=g)
    D = torch.full((d,), 0.3)
    x, dt, dbc = (t.to(device=dev, dtype=dtype) for t in (x, dt, dbc))
    return (x, dt, A.to(dev), dbc[..., 5:5 + n], dbc[..., 5 + n:], D.to(dev))


def _rel(out, expect):
    return float((out.float() - expect.float()).abs().max()
                 / (expect.float().abs().max() + 1e-6))


@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel(dev, case, dtype):
    """Relative to max |y|: f32 1e-5 (the reference's Pallas-vs-ref bound,
    tests/test_kernels.py:120), bf16 2e-2; the f32 state 1e-4."""
    args = _scan_args(*case, dtype, dev)
    assert not args[3].is_contiguous()
    n0 = tcuda.launches["selective_scan"]
    y = tcuda.selective_scan(*args)
    y2, h = tcuda.selective_scan(*args, return_state=True)
    assert tcuda.launches["selective_scan"] == n0 + 2
    torch.cuda.synchronize()
    y_ref, h_ref = tref.selective_scan_with_state_ref(*args)
    assert y.dtype == dtype and h.dtype == torch.float32
    assert torch.equal(y, y2)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert _rel(y, y_ref) <= tol
    assert _rel(h, h_ref) <= 1e-4


@pytest.mark.parametrize("n,npl,steps", [
    (n, npl, 32) for n in tcuda.SCAN_STATES
    for npl in tcuda.scan_npl_options(n)] + [
    (16, npl, 64) for npl in (1, 2, 4, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_every_plan(dev, monkeypatch, n, npl, steps,
                                          dtype):
    """Every (states per thread, steps per chunk) the plan can choose,
    forced through `scan_plan` as scripts/scan_plan_sweep.py forces it, on
    a ragged shape (S not a multiple of the steps, D of the 32 channels
    of a block): the same tolerances as the plan's own launch."""
    b, s, d = 2, 70, 72
    monkeypatch.setattr(tcuda, "scan_plan", lambda *_: tcuda.ScanPlan(
        npl, steps, (-(-d // 32), b), 32 * n // npl))
    args = _scan_args(b, s, d, n, dtype, dev)
    y, h = tcuda.selective_scan(*args, return_state=True)
    torch.cuda.synchronize()
    y_ref, h_ref = tref.selective_scan_with_state_ref(*args)
    assert _rel(y, y_ref) <= (1e-5 if dtype == torch.float32 else 2e-2)
    assert _rel(h, h_ref) <= 1e-4


def test_selective_scan_kernel_refuses_bad_inputs(dev):
    x, dt, A, B, C, D = _scan_args(1, 8, 32, 16, torch.float32, dev)
    with pytest.raises(ValueError, match="d_state"):
        tcuda.selective_scan(x, dt, A[:, :12], B[..., :12], C[..., :12], D)
    with pytest.raises(ValueError, match="contiguous"):
        tcuda.selective_scan(x.transpose(1, 2).contiguous().transpose(1, 2),
                             dt, A, B, C, D)
    with pytest.raises(ValueError, match="dtype"):
        tcuda.selective_scan(x, dt, A, B.to(torch.bfloat16), C, D)


def _ssd_args(b, s, nh, hd, n, dtype, dev, seed=21):
    """Mamba-2 inputs as the hybrid prefill hands them over: x, B and C
    column slices of one conv output (x as a head view), dt per head and
    zero past each row's length."""
    g = torch.Generator().manual_seed(seed)
    di = nh * hd
    xbc = torch.randn((b, s, di + 2 * n), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((b, s, nh), generator=g)
                                      - 1)
    lens = torch.randint(1, s + 1, (b,), generator=g)
    lens[0] = s
    dt = dt.masked_fill(torch.arange(s)[None, :, None] >= lens[:, None, None],
                        0.0)
    A = -torch.exp(torch.randn((nh,), generator=g) * 0.5)
    xbc, dt = xbc.to(device=dev, dtype=dtype), dt.to(device=dev, dtype=dtype)
    return (xbc[..., :di].reshape(b, s, nh, hd), dt, A.to(dev),
            xbc[..., di:di + n], xbc[..., di + n:],
            torch.full((nh,), 0.3, device=dev))


SSD_CASES = [
    # (b, s, nh, hd, n): zamba2's state size and head width, its full
    # d_inner (80 x 64 = 5120) at a short S, a ragged S and heads that
    # leave a block's 32 channels part-filled
    (2, 40, 4, 64, 64), (1, 24, 80, 64, 64), (3, 77, 3, 48, 64),
    (2, 33, 8, 64, 16),
]


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_through_scan_kernel(dev, case, dtype):
    """Mamba-2's recurrence on the scan kernel (`ops.ssd_with_state`)
    against the plain Mamba-2 recurrence: the scan's tolerances relative
    to max |y| (f32 1e-5, bf16 2e-2; the f32 state 1e-4), one launch per
    call, and y the same with and without the state."""
    from repro_torch.kernels import ops
    args = _ssd_args(*case, dtype, dev)
    n0 = tcuda.launches["selective_scan"]
    y, h = ops.ssd_with_state(*args)
    y2 = ops.ssd(*args)
    assert tcuda.launches["selective_scan"] == n0 + 2
    torch.cuda.synchronize()
    y_ref, h_ref = tref.ssd_with_state_ref(*args)
    b, s, nh, hd, n = case
    assert y.shape == (b, s, nh, hd) and y.dtype == dtype
    assert h.shape == (b, nh, hd, n) and h.dtype == torch.float32
    assert torch.equal(y, y2)
    assert _rel(y, y_ref) <= (1e-5 if dtype == torch.float32 else 2e-2)
    assert _rel(h, h_ref) <= 1e-4


@pytest.mark.parametrize("npl,steps", [(4, 32), (4, 64), (8, 32), (8, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_every_plan_at_state_64(dev, monkeypatch, npl, steps, dtype):
    """The plans the scan can take at N = 64 (4 or 8 states per thread,
    32 or 64 steps per chunk), forced, through Mamba-2's mapping."""
    b, s, nh, hd, n = 2, 70, 3, 32, 64
    d = nh * hd
    assert npl in tcuda.scan_npl_options(n)
    monkeypatch.setattr(tcuda, "scan_plan", lambda *_: tcuda.ScanPlan(
        npl, steps, (-(-d // 32), b), 32 * n // npl))
    from repro_torch.kernels import ops
    args = _ssd_args(b, s, nh, hd, n, dtype, dev)
    y, h = ops.ssd_with_state(*args)
    torch.cuda.synchronize()
    y_ref, h_ref = tref.ssd_with_state_ref(*args)
    assert _rel(y, y_ref) <= (1e-5 if dtype == torch.float32 else 2e-2)
    assert _rel(h, h_ref) <= 1e-4


def test_ssd_refuses_what_the_kernel_cannot_take(dev):
    """A Mamba-2 prefill on CUDA tensors the kernel has no instantiation
    for raises; it never drops to the plain version."""
    from repro_torch.kernels import ops
    args = _ssd_args(1, 8, 2, 32, 12, torch.float32, dev)
    n0 = tcuda.launches["selective_scan"]
    with pytest.raises(ValueError, match="d_state"):
        ops.ssd_with_state(*args)
    with pytest.raises(ValueError, match="d_state"):
        ops.ssd(*args)
    assert tcuda.launches["selective_scan"] == n0


def test_hybrid_model_on_card_matches_plain_path(dev):
    """The zamba2 smoke Model on the card (scan, flash and decode kernels)
    against the same Model on the CPU (plain versions), f32: prefill
    logits and every cache leaf with ragged rows, then decode steps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    cfg = get_smoke_config("zamba2-2.7b")
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=dev)
    gparams = _to(params, dev)
    g = torch.Generator().manual_seed(1)
    lens = torch.tensor([24, 13, 2, 1], dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (4, 24), generator=g,
                           dtype=torch.int32)
    outs = []
    tcuda.reset_launches()
    for m, p in ((cpu, params), (gpu, gparams)):
        batch = {"tokens": tokens.to(m.device), "lengths": lens.to(m.device)}
        logits, cache = m.prefill(p, batch, m.init_cache(4, 40))
        steps = [logits]
        for nxt in ([5, 9, 77, 3], [1, 2, 3, 4]):
            logits, cache = m.decode_step(
                p, torch.tensor(nxt, dtype=torch.int32, device=m.device),
                cache)
            steps.append(logits)
        outs.append((steps, cache))
    n_rounds = cfg.num_layers // cfg.hybrid_attn_every
    assert tcuda.launches["selective_scan"] == len(cfg.ssm_layer_ids())
    assert tcuda.launches["flash_attention"] == n_rounds
    assert tcuda.launches["decode_attention"] == 2 * n_rounds
    for a, b in zip(outs[0][0], outs[1][0]):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=0)
    for key in ("k", "v", "ssm_h", "ssm_conv"):
        torch.testing.assert_close(outs[1][1][key].cpu(), outs[0][1][key],
                                   atol=1e-4, rtol=0)


def test_engine_on_card_matches_plain_path(dev):
    """The smoke engine on the card (CUDA kernels) against the same engine
    on the CPU (plain versions), f32: identical virtual timing, tokens
    identical up to near-ties the port's exact-length path documents."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import (TPU_V5E, LatencyModel, QoESpec,
                                  SchedulerConfig, make_scheduler)
    from repro_torch.models import Model
    from repro_torch.serving import (Request, ServingEngine,
                                     all_flips_documented, audit_flips,
                                     timing_fingerprint)
    cfg = get_smoke_config("llama3-8b")
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=dev)
    gparams = _to(params, dev)

    def trace():    # the trace of tests/test_torch_engine.py
        rng = np.random.default_rng(0)
        out = []
        for i in range(12):
            n = int(rng.integers(5, 30))
            out.append(Request(
                rid=i, arrival=i * 0.01, prompt_len=n, output_len=14,
                spec=QoESpec(ttft=1.0, tds=4.8),
                prompt_tokens=rng.integers(0, cfg.vocab_size, n)))
        return out

    for kw in (dict(), dict(page_size=16)):
        outs = []
        for m, p in ((cpu, params), (gpu, gparams)):
            lat = LatencyModel(cfg, TPU_V5E)
            sched = make_scheduler("andes", 100, lat,
                                   SchedulerConfig(delta_t=2.0))
            eng = ServingEngine(m, p, sched, lat, num_slots=4, max_seq=64,
                                capacity_tokens=100, device=m.device, **kw)
            outs.append(eng.run(trace(), max_iterations=4000))
        assert timing_fingerprint(outs[0]) == timing_fingerprint(outs[1])
        flips = audit_flips(cpu, params, outs[0], outs[1])
        assert all_flips_documented(flips), flips


def test_ssm_engine_on_card_matches_plain_path(dev):
    """The falcon-mamba smoke engine on the card (scan kernel) against the
    same engine on the CPU (plain versions), f32, in both preemption
    modes: identical virtual timing, tokens identical up to near-ties."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import (TPU_V5E, LatencyModel, QoESpec,
                                  SchedulerConfig, make_scheduler)
    from repro_torch.models import Model
    from repro_torch.serving import (Request, ServingEngine,
                                     all_flips_documented, audit_flips,
                                     timing_fingerprint)
    cfg = get_smoke_config("falcon-mamba-7b")
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=dev)
    gparams = _to(params, dev)

    def trace():
        rng = np.random.default_rng(0)
        out = []
        for i in range(12):
            n = int(rng.integers(5, 30))
            out.append(Request(
                rid=i, arrival=i * 0.01, prompt_len=n, output_len=14,
                spec=QoESpec(ttft=1.0, tds=4.8),
                prompt_tokens=rng.integers(0, cfg.vocab_size, n)))
        return out

    for mode in ("swap", "recompute"):
        outs, engs = [], []
        n0 = tcuda.launches["selective_scan"]
        for m, p in ((cpu, params), (gpu, gparams)):
            lat = LatencyModel(cfg, TPU_V5E)
            sched = make_scheduler("andes", 100, lat,
                                   SchedulerConfig(delta_t=2.0))
            eng = ServingEngine(m, p, sched, lat, num_slots=4, max_seq=64,
                                capacity_tokens=100, preemption_mode=mode,
                                device=m.device)
            outs.append(eng.run(trace(), max_iterations=4000))
            engs.append(eng)
        assert engs[1].preemptions > 0
        assert tcuda.launches["selective_scan"] > n0
        assert timing_fingerprint(outs[0]) == timing_fingerprint(outs[1])
        flips = audit_flips(cpu, params, outs[0], outs[1])
        assert all_flips_documented(flips), flips


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
