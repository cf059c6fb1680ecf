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
are covered case by case, hd 80 included, and so are bidirectional flash
with Sq != Sk and with Sq = 1 (an encoder-decoder's cross-attention at
prefill and at decode). Mamba-2 runs on
the scan kernel through ``ops.ssd_channel_args`` and is held against the plain
Mamba-2 recurrence at the scan's tolerances, N 64 and D 5120 included.
The flash kernel's `lse` output is held against ``attention_lse_ref``
and the backward kernels against ``attention_bwd_ref`` (f32 1e-4, bf16
2e-2, relative to the largest |gradient|: the gradients sum over a whole
row or column, so their scale is not the inputs'), at their tiles' ragged
edges too, bitwise equal over two launches, on the body their dtype
selects (bf16 tensor cores, f32 CUDA cores); the autograd Function
through ``torch.utils.checkpoint`` against torch autograd of the plain
attention on the CPU, and every kernel without a backward must raise in
grad mode rather than drop gradients. The scan's backward kernel is held
against ``selective_scan_bwd_ref`` at the same tolerances, in both its
bodies (Mamba-1: A (D, N); Mamba-2: A one scalar per channel, (D,)), for
every launch plan the forward can take at N 16 and 64, at odd D, S past a
chunk, strided B and C and zeroed dt, bitwise equal over two launches and
counted by body; the Mamba-2 body equals the Mamba-1 body on the same A
expanded; the wrapper refuses mismatched states and an A of the wrong
form before any launch; the forward's y is bitwise the same with and
without its chunk states, and the last chunk state is its final state.
``ops.SelectiveScan`` (through ``ops.selective_scan`` and ``ops.ssd``)
under ``torch.utils.checkpoint`` is held against torch autograd of the
plain scans on the CPU, each scan's backward on its own body.
The prefill forward captured as a CUDA graph (``Model.prefill`` into a
held cache) is held bitwise against the eager call at every length
bucket of one row, its replayed kernels are counted and seen by the
profiler, and an engine serves the same tokens with graphs as without.
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
                 (3, 256, 16, 4, 80), (1, 1024, 32, 8, 128),
                 # qwen2-moe-a2.7b: H = KV = 16 (G = 1) at hd 128
                 (8, 1024, 16, 16, 128),
                 # a speculative engine's caches, max_seq + k + 1 deep: the
                 # llama3-8b target and the 4/2-head hd-32 foreign draft
                 (8, 1028, 32, 8, 128), (8, 1028, 4, 2, 32),
                 # seamless-m4t-medium's decoder self-attention: G = 1, hd 64
                 (8, 1024, 16, 16, 64)]


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


@pytest.mark.parametrize("h,kv", [(32, 8), (16, 16)])
def test_paged_kernel_window_and_main_shape(dev, h, kv):
    """The main paths' paged shapes: llama3-8b (32/8 heads) and
    qwen2-moe-a2.7b (16/16), page 16 over a 1024-deep pool."""
    b, s, hd, page = 8, 1024, 128, 16
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
    # qwen2-moe-a2.7b's eager exact-length prefill: G = 1, no padding
    (1, 389, 389, 16, 16, 128, True, None, None, None),
    (1, 64, 64, 16, 16, 128, True, None, None, None),
    # the foreign draft's bucketed prefill: 4/2 heads of hd 32
    (1, 512, 512, 4, 2, 32, True, [389], None, None),
    # seamless-m4t-medium (H = KV = 16, hd 64): the encoder's
    # bidirectional self-attention, cross-attention at prefill (a 512
    # bucket of queries over 256 encoder keys) and at decode (Sq = 1)
    (4, 256, 256, 16, 16, 64, False, None, None, None),
    (2, 512, 256, 16, 16, 64, False, [256, 256], None, None),
    (8, 1, 256, 16, 16, 64, False, [256] * 8, None, None),
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


SCAN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _check_scan_bwd(args, plan_states, dtype, seed=22):
    """The backward kernel on `args` with the forward's (states, plan)
    against selective_scan_bwd_ref, each gradient relative to its max
    magnitude; two launches bitwise equal, on the body A's form selects.
    Returns the launch's grads."""
    states, plan = plan_states
    g = torch.Generator().manual_seed(seed)
    dy = torch.randn(args[0].shape, generator=g).to(args[0])
    body = "selective_scan_bwd/" + ("mamba2" if args[2].dim() == 1
                                    else "mamba1")
    n0 = tcuda.launches["selective_scan_bwd"]
    v0 = tcuda.variant_launches[body]
    got = tcuda.selective_scan_bwd(*args, states, dy, plan)
    again = tcuda.selective_scan_bwd(*args, states, dy, plan)
    assert tcuda.launches["selective_scan_bwd"] == n0 + 2
    assert tcuda.variant_launches[body] == v0 + 2
    torch.cuda.synchronize()
    want = tref.selective_scan_bwd_ref(*args, dy)
    for name, a, b_, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got,
                              again, want):
        assert torch.equal(a, b_), f"{name}: two launches differ"
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.isfinite(a).all(), name
        scale = max(w.float().abs().max().item(), 1e-6)
        err = (a.float() - w.float()).abs().max().item()
        assert err <= SCAN_BWD_TOL[dtype] * scale, (name, err, scale)
    assert got[3].is_contiguous() and got[4].is_contiguous()
    return got


def _forward_with_states(args):
    """The forward with its chunk states (A per channel or per (channel,
    state), as ops.SelectiveScan hands it over): y bitwise the serving
    launch's, the last chunk state bitwise its h_last. Returns (states,
    plan)."""
    y0, h = tcuda.selective_scan(*args, return_state=True)
    y, states, plan = tcuda.selective_scan(*args, save_states=True)
    b, s, d = args[0].shape
    assert states.shape == (b, -(-s // plan.steps), d, args[3].shape[-1])
    assert torch.equal(y, y0)
    assert torch.equal(states[:, -1], h)
    return states, plan


def _body_args(args, body):
    """Scan args for a backward body: Mamba-1 takes them as they are;
    Mamba-2 takes A as one scalar per channel (the first state's)."""
    if body == "mamba1":
        return args
    x, dt, A, B, C, D = args
    return x, dt, A[:, 0].contiguous(), B, C, D


@pytest.mark.parametrize("n,npl,steps", [
    (n, npl, steps) for n in (16, 64) for npl in tcuda.scan_npl_options(n)
    for steps in tcuda.SCAN_STEPS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("body", ["mamba1", "mamba2"])
def test_selective_scan_bwd_every_plan(dev, monkeypatch, n, npl, steps,
                                       dtype, body):
    """Every (states per thread, steps per chunk) plan at N 16 and 64,
    forced through `scan_plan` as for the forward, on a ragged shape, in
    both bodies: the backward reads the forward's chunk states at the
    forward's steps per chunk (its states per thread are its own)."""
    b, s, d = 2, 70, 72
    monkeypatch.setattr(tcuda, "scan_plan", lambda *_: tcuda.ScanPlan(
        npl, steps, (-(-d // 32), b), 32 * n // npl))
    args = _body_args(_scan_args(b, s, d, n, dtype, dev), body)
    _check_scan_bwd(args, _forward_with_states(args), dtype)


@pytest.mark.parametrize("steps", sorted(tcuda.SCAN_STEPS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("body", ["mamba1", "mamba2"])
def test_selective_scan_bwd_long_plan(dev, monkeypatch, steps, dtype, body):
    """zamba2's width (D 5120, N 64) over 512 steps, many chunks, at each
    steps per chunk forced through `scan_plan` (bf16 zamba2 trains at 64),
    in both bodies: every chunk's start state read from the forward's
    states at the forward's steps."""
    b, s, d, n = 2, 512, 5120, 64
    monkeypatch.setattr(tcuda, "scan_plan", lambda *_: tcuda.ScanPlan(
        8, steps, (d // 32, b), 32 * n // 8))
    args = _body_args(_scan_args(b, s, d, n, dtype, dev), body)
    _check_scan_bwd(args, _forward_with_states(args), dtype)


SCAN_BWD_CASES = [
    # (b, s, d, n): odd D (a part-filled last block), S past a chunk and
    # short of one, every N the kernel takes; falcon-mamba's d_inner
    (2, 77, 45, 16), (1, 33, 35, 8), (3, 40, 96, 4), (2, 19, 40, 64),
    (1, 20, 48, 32), (2, 130, 8192, 16),
]


@pytest.mark.parametrize("case", SCAN_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("body", ["mamba1", "mamba2"])
def test_selective_scan_bwd_kernel(dev, case, dtype, body):
    """The plan's own launch, in both bodies: strided B and C (gradients
    contiguous), ragged zeroed dt, y unchanged by the chunk states, two
    backward launches bitwise equal."""
    args = _body_args(_scan_args(*case, dtype, dev), body)
    assert not args[3].is_contiguous()
    _check_scan_bwd(args, _forward_with_states(args), dtype)


@pytest.mark.parametrize("case", [(2, 77, 45, 16), (2, 19, 40, 64),
                                  (1, 40, 5120, 64), (2, 130, 8192, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_bwd_bodies_agree(dev, case, dtype):
    """The Mamba-2 body (A per channel) against the Mamba-1 body on the
    same A expanded over the states (dA summed over them), within the
    backward's tolerances relative to each gradient's max magnitude."""
    args = _body_args(_scan_args(*case, dtype, dev), "mamba2")
    states, plan = _forward_with_states(args)
    g = torch.Generator().manual_seed(23)
    dy = torch.randn(args[0].shape, generator=g).to(args[0])
    two = tcuda.selective_scan_bwd(*args, states, dy, plan)
    x, dt, A, B, C, D = args
    one = list(tcuda.selective_scan_bwd(
        x, dt, A[:, None].expand(-1, B.shape[-1]), B, C, D, states, dy, plan))
    one[2] = one[2].sum(1)
    for name, a, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), two, one):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        scale = max(w.float().abs().max().item(), 1e-6)
        err = (a.float() - w.float()).abs().max().item()
        assert err <= SCAN_BWD_TOL[dtype] * scale, (name, err, scale)


def test_selective_scan_bwd_refuses_mismatched_states(dev):
    """Mismatched chunk states, an A of neither form, a plan whose steps
    the kernel lacks: each raises before any launch."""
    args = _scan_args(1, 40, 32, 16, torch.float32, dev)
    y, states, plan = tcuda.selective_scan(*args, save_states=True)
    x, dt, A, B, C, D = args
    n0 = tcuda.launches["selective_scan_bwd"]
    v0 = dict(tcuda.variant_launches)
    with pytest.raises(ValueError, match="states"):
        tcuda.selective_scan_bwd(*args, torch.cat([states, states], 1),
                                 torch.ones_like(y), plan)
    for bad in (A[:, :8], A[:1, 0], A[:, 0, None].contiguous(), A[None]):
        with pytest.raises(ValueError, match="shape mismatch"):
            tcuda.selective_scan_bwd(x, dt, bad, B, C, D, states,
                                     torch.ones_like(y), plan)
    with pytest.raises(ValueError, match="steps per chunk"):
        tcuda.selective_scan_bwd(*args, states, torch.ones_like(y),
                                 plan._replace(steps=16))
    with pytest.raises(ValueError, match="not both"):
        tcuda.selective_scan(*args, return_state=True, save_states=True)
    assert tcuda.launches["selective_scan_bwd"] == n0
    assert tcuda.variant_launches == v0


def test_scan_autograd_under_checkpoint(dev):
    """A Mamba-1 scan (ops.selective_scan) and a Mamba-2 one (ops.ssd)
    between projections, under non-reentrant torch.utils.checkpoint, on
    the card (SelectiveScan) against torch autograd of the plain scans on
    the CPU: forward, recomputed forward and backward launches counted,
    the backward's by body."""
    from repro_torch.kernels import ops
    b, s, dm, di, n, nh = 2, 70, 32, 64, 16, 4
    g = torch.Generator().manual_seed(5)
    x0 = torch.randn((b, s, dm), generator=g)
    w = torch.randn((dm, 2 * di + 2 * n + nh), generator=g) * dm ** -0.5
    a_log = torch.randn((di, n), generator=g) * 0.5
    a_h = torch.randn((nh,), generator=g) * 0.5
    d_skip = torch.randn((di,), generator=g)

    def run(device):
        leaves = [t.to(device).requires_grad_()
                  for t in (x0, w, a_log, a_h, d_skip)]

        def block(xx, ww, al, ah, dd):
            p = xx @ ww
            xs, dt = p[..., :di].contiguous(), p[..., di:2 * di]
            bm, cm = p[..., 2 * di:2 * di + n], p[..., 2 * di + n:-nh]
            dt = torch.nn.functional.softplus(dt).contiguous()
            y1 = ops.selective_scan(xs, dt, -torch.exp(al), bm, cm, dd)
            y2 = ops.ssd(y1.view(b, s, nh, di // nh),
                         torch.nn.functional.softplus(p[..., -nh:]),
                         -torch.exp(ah), bm, cm, dd[:nh])
            return (y2.float() ** 2).mean()

        loss = torch.utils.checkpoint.checkpoint(block, *leaves,
                                                 use_reentrant=False)
        return torch.autograd.grad(loss, leaves)

    tcuda.reset_launches()
    got = run(dev)
    assert tcuda.launches["selective_scan"] == 4      # 2 + 2 recomputed
    assert tcuda.launches["selective_scan_bwd"] == 2
    # each scan's backward on its own body
    assert tcuda.variant_launches["selective_scan_bwd/mamba1"] == 1
    assert tcuda.variant_launches["selective_scan_bwd/mamba2"] == 1
    for a, e in zip(got, run("cpu")):
        scale = max(e.abs().max().item(), 1e-6)
        assert (a.cpu() - e).abs().max().item() <= 1e-4 * scale


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


def _smoke_trace(cfg):
    """The trace of tests/test_torch_engine.py."""
    from repro_torch.core import QoESpec
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    out = []
    for i in range(12):
        n = int(rng.integers(5, 30))
        out.append(Request(
            rid=i, arrival=i * 0.01, prompt_len=n, output_len=14,
            spec=QoESpec(ttft=1.0, tds=4.8),
            prompt_tokens=rng.integers(0, cfg.vocab_size, n)))
    return out


def _perturbed(params, seed=9):
    """params + 1e-3 * randn from a seeded generator, leaf by leaf."""
    gen = torch.Generator().manual_seed(seed)
    if isinstance(params, dict):
        return {k: _perturbed(v, seed) if isinstance(v, dict) else
                v + 1e-3 * torch.randn(v.shape, generator=gen)
                for k, v in params.items()}
    return params


def test_spec_engine_on_card_matches_plain_path(dev):
    """The llama3 smoke speculative engine (k = 2, swap preemption) on
    the card against the same engine on the CPU, f32, with the exact and
    a perturbed draft: identical virtual timing and acceptance, tokens
    identical up to documented near-ties; the exact draft accepts as much
    on both devices."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import (TPU_V5E, SchedulerConfig,
                                  SpeculativeLatencyModel, make_scheduler)
    from repro_torch.models import Model
    from repro_torch.serving import (ServingEngine, all_flips_documented,
                                     audit_flips, timing_fingerprint)
    cfg = get_smoke_config("llama3-8b")
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=dev)
    for draft in ("exact", "perturbed"):
        dparams = params if draft == "exact" else _perturbed(params)
        outs, engs = [], []
        n0 = tcuda.launches["decode_attention"]
        for m, p, dp in ((cpu, params, dparams),
                         (gpu, _to(params, dev), _to(dparams, dev))):
            lat = SpeculativeLatencyModel(cfg, TPU_V5E, cfg, k=2)
            sched = make_scheduler("andes", 100, lat,
                                   SchedulerConfig(delta_t=2.0))
            eng = ServingEngine(m, p, sched, lat, num_slots=4, max_seq=64,
                                capacity_tokens=100, draft_model=m,
                                draft_params=dp, spec_k=2, device=m.device)
            outs.append(eng.run(_smoke_trace(cfg), max_iterations=4000))
            engs.append(eng)
        assert engs[1].preemptions > 0
        assert tcuda.launches["decode_attention"] > n0
        flips = audit_flips(cpu, params, outs[0], outs[1])
        assert all_flips_documented(flips), flips
        if not flips:
            assert timing_fingerprint(outs[0]) == \
                timing_fingerprint(outs[1])
            assert engs[0].spec_stats() == engs[1].spec_stats()


def test_moe_engine_on_card_matches_plain_path(dev):
    """The qwen2-moe smoke engine on the card (flash in its eager
    prefill, decode or paged decode per step) against the same engine on
    the CPU, f32: swap, recompute, and swap over the page pool."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import (TPU_V5E, LatencyModel, SchedulerConfig,
                                  make_scheduler)
    from repro_torch.models import Model
    from repro_torch.serving import (ServingEngine, all_flips_documented,
                                     audit_flips, timing_fingerprint)
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=dev)
    gparams = _to(params, dev)
    for kw in (dict(preemption_mode="swap"),
               dict(preemption_mode="recompute"),
               dict(preemption_mode="swap", page_size=16)):
        outs, engs = [], []
        n0 = tcuda.launches["flash_attention"]
        for m, p in ((cpu, params), (gpu, gparams)):
            lat = LatencyModel(cfg, TPU_V5E)
            sched = make_scheduler("andes", 100, lat,
                                   SchedulerConfig(delta_t=2.0))
            eng = ServingEngine(m, p, sched, lat, num_slots=4, max_seq=64,
                                capacity_tokens=100, device=m.device, **kw)
            outs.append(eng.run(_smoke_trace(cfg), max_iterations=4000))
            engs.append(eng)
        assert engs[1].preemptions > 0
        assert engs[1].physical_pages == ("page_size" in kw)
        assert tcuda.launches["flash_attention"] > n0
        assert timing_fingerprint(outs[0]) == timing_fingerprint(outs[1])
        flips = audit_flips(cpu, params, outs[0], outs[1])
        assert all_flips_documented(flips), flips


def test_encdec_and_vlm_engines_on_card_match_plain_path(dev):
    """The seamless-m4t-medium smoke engine (frames from each rid; flash
    in the encoder, the decoder and the cross-attention, decode per step)
    and the pixtral-12b smoke engine (paged and contiguous) on the card
    against the same engines on the CPU, f32."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import (TPU_V5E, LatencyModel, SchedulerConfig,
                                  make_scheduler)
    from repro_torch.models import Model
    from repro_torch.serving import (ServingEngine, all_flips_documented,
                                     audit_flips, synthetic_frames,
                                     timing_fingerprint)
    for arch, kw in (("seamless-m4t-medium", dict(preemption_mode="swap")),
                     ("seamless-m4t-medium",
                      dict(preemption_mode="recompute")),
                     ("pixtral-12b", dict(page_size=16)),
                     ("pixtral-12b", dict())):
        cfg = get_smoke_config(arch)
        cpu = Model(cfg, device="cpu")
        params = cpu.init(torch.Generator().manual_seed(0))
        gpu = Model(cfg, device=dev)
        gparams = _to(params, dev)
        outs, engs = [], []
        n0 = dict(tcuda.launches)
        for m, p in ((cpu, params), (gpu, gparams)):
            trace = _smoke_trace(cfg)
            if cfg.kind == "audio":
                for r in trace:
                    r.frames = synthetic_frames(cfg, [r.rid], 16)[0]
            lat = LatencyModel(cfg, TPU_V5E)
            sched = make_scheduler("andes", 100, lat,
                                   SchedulerConfig(delta_t=2.0))
            eng = ServingEngine(m, p, sched, lat, num_slots=4, max_seq=64,
                                capacity_tokens=100, device=m.device, **kw)
            outs.append(eng.run(trace, max_iterations=4000))
            engs.append(eng)
        assert engs[1].preemptions > 0
        assert engs[1].physical_pages == ("page_size" in kw)
        ran = {k: tcuda.launches[k] - n0[k] for k in n0}
        assert ran["flash_attention"] > 0
        assert ran["paged_decode_attention" if "page_size" in kw
                   else "decode_attention"] > 0
        assert timing_fingerprint(outs[0]) == timing_fingerprint(outs[1])
        flips = audit_flips(cpu, params, outs[0], outs[1])
        assert all_flips_documented(flips), flips


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---- the backward: lse, the two backward kernels, autograd --------------

BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_CASES = [
    # (b, sq, sk, h, kv, hd, causal, lengths, window)
    (2, 128, 128, 8, 2, 64, True, None, None),
    (2, 200, 200, 4, 4, 128, True, [200, 77], None),
    (1, 96, 96, 4, 1, 80, True, None, None),
    (2, 100, 70, 4, 4, 64, False, [70, 33], None),
    (2, 150, 150, 8, 1, 32, True, None, 40),
    # an empty row (length 0) and rows the window leaves nothing: -inf lse,
    # zero gradients
    (3, 64, 64, 4, 2, 64, True, [64, 0, 10], 8),
    (2, 512, 256, 16, 16, 64, False, [256, 131], None),
    (1, 130, 130, 32, 8, 128, True, None, 33),
    # the tiles' edges: Sk not a multiple of the 64-key tile, hd 80 past
    # the bf16 body's register-held fragments, hd 128 with G = 8 (the f32
    # body's 32-query dK/dV tiles), Sq != Sk bidirectional with a row of
    # length 1, and fewer queries than one tile over a ragged window
    (2, 100, 100, 4, 2, 64, True, None, None),
    (1, 77, 77, 8, 8, 80, True, [77], None),
    (1, 130, 130, 16, 2, 128, True, None, None),
    (2, 96, 50, 4, 4, 64, False, [1, 50], None),
    (1, 33, 190, 8, 2, 32, False, [190], 20),
]


def _bwd_inputs(case, dtype, dev, seed=30):
    b, sq, sk, h, kv, hd, causal, lens, window = case
    q = _rand(seed, (b, sq, h, hd), dtype, dev)
    k = _rand(seed + 1, (b, sk, kv, hd), dtype, dev)
    v = _rand(seed + 2, (b, sk, kv, hd), dtype, dev)
    dout = _rand(seed + 3, (b, sq, h, hd), dtype, dev)
    lengths = (torch.tensor(lens, dtype=torch.int32, device=dev)
               if lens is not None else None)
    return q, k, v, dout, dict(causal=causal, window=window, lengths=lengths)


def _rel_close(out, expect, dtype):
    scale = max(expect.float().abs().max().item(), 1e-6)
    err = (out.float() - expect.float()).abs().max().item()
    assert err <= BWD_TOL[dtype] * scale, (err, scale)


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_lse_and_backward_kernels(dev, case, dtype):
    q, k, v, dout, kw = _bwd_inputs(case, dtype, dev)
    out, lse = tcuda.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, tcuda.flash_attention(q, k, v, **kw))
    expect_lse = tref.attention_lse_ref(q, k, v, **kw)
    empty = torch.isinf(expect_lse)
    assert torch.equal(torch.isinf(lse), empty)
    assert (lse[empty] < 0).all()
    torch.testing.assert_close(lse[~empty], expect_lse[~empty],
                               atol=BWD_TOL[dtype], rtol=BWD_TOL[dtype])
    n = dict(tcuda.launches)
    grads = tcuda.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    for key in ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
        assert tcuda.launches[key] == n[key] + 1
    expect = tref.attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    for g, e, t in zip(grads, expect, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert torch.isfinite(g).all()
        _rel_close(g, e, dtype)
    # rows that attend nothing get no gradient
    rows = empty.transpose(1, 2)                        # (B, Sq, H)
    assert not grads[0][rows].any()


@pytest.mark.parametrize("case", [BWD_CASES[i] for i in (0, 1, 5, 10, 11)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_deterministic(dev, case, dtype):
    """Two launches of the backward give bitwise-equal gradients: each
    element is summed by one thread in a fixed order, with no atomics."""
    q, k, v, dout, kw = _bwd_inputs(case, dtype, dev)
    out, lse = tcuda.flash_attention(q, k, v, return_lse=True, **kw)
    first = tcuda.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    second = tcuda.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_body_follows_dtype(dev, dtype):
    """bf16 runs the tensor-core body and f32 the CUDA-core one, both
    kernels of each backward, and nothing else moves."""
    q, k, v, dout, kw = _bwd_inputs(BWD_CASES[0], dtype, dev)
    out, lse = tcuda.flash_attention(q, k, v, return_lse=True, **kw)
    body = ("flash_attention_bwd/tensor_core" if dtype == torch.bfloat16
            else "flash_attention_bwd/cuda_core")
    before = dict(tcuda.variant_launches)
    tcuda.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    moved = {key: n - before[key]
             for key, n in tcuda.variant_launches.items() if n != before[key]}
    assert moved == {body: 2}


def test_flash_backward_refuses_q_offset(dev):
    q, k, v, dout, kw = _bwd_inputs(BWD_CASES[0], torch.float32, dev)
    out, lse = tcuda.flash_attention(q, k, v, return_lse=True, **kw)
    with pytest.raises(ValueError, match="q_offset"):
        tcuda.flash_attention_bwd(q, k, v, out, lse, dout, q_offset=torch.zeros(
            2, dtype=torch.int32, device=dev), **kw)


def test_flash_autograd_under_checkpoint(dev):
    """Attention between two projections, under non-reentrant
    torch.utils.checkpoint, through ops.attention on the card (the
    Function) against torch autograd of the plain version on the CPU."""
    from repro_torch.kernels import ops
    b, s, h, kv, hd, d = 2, 96, 8, 2, 64, 128
    g = torch.Generator().manual_seed(3)
    x = torch.randn((b, s, d), generator=g)
    wq = torch.randn((d, h * hd), generator=g) * d ** -0.5
    wkv = torch.randn((d, 2 * kv * hd), generator=g) * d ** -0.5
    lengths = torch.tensor([96, 50], dtype=torch.int32)

    def run(device):
        xs, wqs, wkvs = (t.to(device).requires_grad_() for t in (x, wq, wkv))
        lens = lengths.to(device)

        def block(xx):
            q = (xx @ wqs).view(b, s, h, hd)
            k, v = (xx @ wkvs).view(b, s, 2, kv, hd).unbind(2)
            o = ops.attention(q, k.contiguous(), v.contiguous(),
                              lengths=lens, window=48)
            return (o.float() ** 2).sum()

        loss = torch.utils.checkpoint.checkpoint(block, xs,
                                                 use_reentrant=False)
        return torch.autograd.grad(loss, (xs, wqs, wkvs))

    tcuda.reset_launches()
    got = run(dev)
    assert tcuda.launches["flash_attention"] == 2       # forward + recompute
    assert tcuda.launches["flash_attention_bwd_dq"] == 1
    assert tcuda.launches["flash_attention_bwd_dkdv"] == 1
    for a, e in zip(got, run("cpu")):
        _rel_close(a.cpu(), e, torch.float32)


def test_kernels_without_backward_refuse_grad_mode(dev):
    from repro_torch.kernels import ops
    q = _rand(40, (2, 4, 64), torch.float32, dev).requires_grad_()
    k = _rand(41, (2, 32, 2, 64), torch.float32, dev)
    lengths = torch.tensor([32, 7], dtype=torch.int32, device=dev)
    tcuda.reset_launches()
    with pytest.raises(RuntimeError, match="decode_attention has no backward"):
        ops.decode_attention(q, k, k, lengths)
    with pytest.raises(RuntimeError,
                       match="paged_decode_attention has no backward"):
        ops.paged_decode_attention(q, k.view(16, 4, 2, 64),
                                   k.view(16, 4, 2, 64),
                                   torch.arange(16, dtype=torch.int32,
                                                device=dev).view(2, 8),
                                   lengths)
    x, dt, A, B, C, D = _scan_args(1, 32, 64, 16, torch.float32, dev)
    x.requires_grad_()
    # the prefill's entry points serve only; training takes ops.selective_scan
    with pytest.raises(RuntimeError, match="ops.selective_scan or ops.ssd"):
        ops.selective_scan_with_state(x, dt, A, B, C, D)
    with pytest.raises(RuntimeError, match="ops.selective_scan or ops.ssd"):
        ops.ssd_with_state(x.view(1, 32, 2, 32), dt[..., :2], A[::32, 0],
                           B, C, D[:2])
    with pytest.raises(RuntimeError, match="ops.attention"):
        tcuda.flash_attention(_rand(42, (1, 8, 4, 64), torch.float32,
                                    dev).requires_grad_(),
                              k[:1, :8].contiguous(), k[:1, :8].contiguous())
    assert all(n == 0 for n in tcuda.launches.values())
    with torch.no_grad():                        # serving: no grad mode
        ops.decode_attention(q, k, k, lengths)
        ops.selective_scan(x, dt, A, B, C, D)


GRAPH_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)
GRAPH_DEPTH = 2048


def _graph_model():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    m = Model(get_smoke_config("granite-3-2b"), device="cuda")
    return m, m.init(torch.Generator("cuda").manual_seed(0), torch.bfloat16)


def _graph_batch(m, bucket, n, seed, dev):
    g = torch.Generator().manual_seed(seed)
    toks = torch.zeros((1, bucket), dtype=torch.int32)
    toks[0, :n] = torch.randint(0, m.cfg.vocab_size, (n,), generator=g,
                                dtype=torch.int32)
    return {"tokens": toks.to(dev),
            "lengths": torch.tensor([n], dtype=torch.int32, device=dev)}


@pytest.mark.parametrize("bucket", GRAPH_BUCKETS)
def test_prefill_graph_replay_bitwise_eager(dev, bucket):
    """A held cache's first call captures, the next two replay with other
    tokens and lengths (stale static inputs would show); each is bitwise
    the eager call into a fresh cache in logits, k/v planes and length,
    and each runs the flash kernel once a layer."""
    from repro_torch.obs.spans import SpanLog
    m, p = _graph_model()
    held = m.hold_cache(1, GRAPH_DEPTH, dtype=torch.bfloat16)
    log = SpanLog()
    call = log.begin("engine.prefill_call")
    for i, n in enumerate((bucket, bucket // 2 + 1, bucket - 3)):
        batch = _graph_batch(m, bucket, n, 1000 * bucket + i, dev)
        for leaf in held.values():
            leaf.zero_()
        before = tcuda.launches["flash_attention"]
        logits, out = m.prefill(p, batch, held)
        flash = tcuda.launches["flash_attention"] - before
        fresh = m.init_cache(1, GRAPH_DEPTH, dtype=torch.bfloat16)
        want_logits, want = m.prefill(p, dict(batch), fresh)
        torch.cuda.synchronize()
        assert flash == m.cfg.num_layers, (i, flash)
        assert torch.equal(logits, want_logits), i
        for key in ("k", "v", "length"):
            assert torch.equal(out[key], want[key]), (i, key)
    log.end(call)
    assert log.counters == {"prefill.graph_captures": 1,
                            "prefill.graph_replays": 2}
    flags = [s.payload["graph"] for s in log.spans()
             if s.name == "model.prefill"]
    assert flags == [0, 0, 1, 0, 1, 0]


def test_prefill_graph_kernels_reach_the_profiler(dev):
    """A replay's kernels appear in ``torch.profiler``'s device events
    under their own names: the flash kernel once a layer."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    m, p = _graph_model()
    held = m.hold_cache(1, GRAPH_DEPTH, dtype=torch.bfloat16)
    batch = _graph_batch(m, 64, 50, 7, dev)
    m.prefill(p, batch, held)                    # the capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        m.prefill(p, batch, held)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert sum("flash_mma_kernel" in n for n in names) == m.cfg.num_layers
    assert len(names) > 10 * m.cfg.num_layers


def test_prefill_graph_captures_with_the_collector_off(dev, monkeypatch):
    """A collection inside a capture could free an older graph (an
    engine's reference cycles hold them), which invalidates the capture:
    the collector is off while the forward is captured, and on again
    after."""
    import gc
    from repro_torch.models.model import Model
    seen = []
    inner = Model._prefill

    def body(self, *a):
        seen.append((torch.cuda.is_current_stream_capturing(),
                     gc.isenabled()))
        return inner(self, *a)

    monkeypatch.setattr(Model, "_prefill", body)
    m, p = _graph_model()
    held = m.hold_cache(1, GRAPH_DEPTH, dtype=torch.bfloat16)
    batch = _graph_batch(m, 32, 20, 2, dev)
    m.prefill(p, batch, held)
    assert seen == [(False, True), (True, False)]   # warm-up, capture
    assert gc.isenabled()
    m.prefill(p, batch, held)
    assert len(seen) == 2                           # a replay


@pytest.mark.parametrize("output_len", [1, 6])
def test_engine_serves_the_same_tokens_with_graphs(dev, monkeypatch,
                                                   output_len):
    """The bucketed engine replays its prefills from graphs and serves
    the tokens it serves with every prefill eager (no kind graphed)."""
    import numpy as np
    from repro_torch.core import (TPU_V5E, LatencyModel, QoESpec,
                                  SchedulerConfig, make_scheduler)
    from repro_torch.models import model as model_mod
    from repro_torch.serving import Request, ServingEngine
    m, p = _graph_model()

    def serve():
        lat = LatencyModel(m.cfg, TPU_V5E)
        sched = make_scheduler("andes", 4096, lat,
                               SchedulerConfig(delta_t=2.0))
        eng = ServingEngine(m, p, sched, lat, num_slots=8, max_seq=256,
                            capacity_tokens=4096, page_size=16,
                            cache_dtype=torch.bfloat16, device="cuda")
        rng = np.random.default_rng(3)
        reqs = []
        for i in range(24):
            n = int(rng.integers(3, 200))
            reqs.append(Request(
                rid=i, arrival=0.01 * (i % 6), prompt_len=n,
                output_len=output_len, spec=QoESpec(ttft=1.0, tds=4.8),
                prompt_tokens=rng.integers(0, m.cfg.vocab_size, n)))
        eng.run(reqs, max_iterations=4000)
        return [r.output_tokens for r in reqs], eng.spans.counters

    graphed, counts = serve()
    assert counts["prefill.graph_replays"] > 0
    monkeypatch.setattr(model_mod, "GRAPH_KINDS", ())
    eager, counts = serve()
    assert "prefill.graph_captures" not in counts
    assert graphed == eager
