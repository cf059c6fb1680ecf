"""Python wrappers of the hand-written CUDA kernels.

Each wrapper checks device, dtype, shape, contiguity and alignment,
allocates the output with ``torch.empty``, launches on PyTorch's current
stream, raises if the launch returned a CUDA error, and adds one to its
entry in ``launches`` — there and nowhere else, so a run can show that it
went through the kernel. A launch recorded into a CUDA graph runs
nothing until the graph replays: ``recorded_launches`` takes it back out
and ``add_launches`` counts it on each replay. ``variant_launches``
counts the flash launches, forward and backward, by the body they ran
(tensor-core for bf16, CUDA-core for f32), and the scan backward's by
its body (Mamba-1's for an A per (channel, state), Mamba-2's for an A
per channel); ``flash_plan`` picks the tensor-core body's query-tile
height from the grid's size.

The decode wrappers plan their split-KV launch on the host with
``decode_plan`` (from the cache's capacity, never from ``lengths``, which
lives on the device) and keep, per device and stream, a scratch buffer
for the splits' partial results and a buffer of merge counters that the
kernel leaves at zero after every launch. The scan wrapper plans its
launch the same way with ``scan_plan``: states per thread and time steps
staged per chunk, from the shapes alone. The kernels' sources and design
notes are in ``csrc/``.

``flash_attention(..., return_lse=True)`` also returns each row's
log-sum-exp, from which ``flash_attention_bwd`` (two launches: dQ, which
also writes each row's Delta = rowsum(dO o O) to a buffer, then dK/dV,
which reads it) computes the gradients; ``kernels/ops.py:FlashAttention``
ties the two together for autograd. Likewise ``selective_scan(...,
save_states=True)`` also returns the state after each of its chunks and
its launch plan, from which ``selective_scan_bwd`` (one call: the scan in
reverse, then a small kernel that sums its per-cluster partials) computes
the gradients; ``kernels/ops.py:SelectiveScan`` ties those two together.
The forward wrappers have no backward of their own, so every one refuses,
in grad mode, inputs that require grad (``_no_grad``): a launch would hand
autograd an output with no history and the inputs' gradients would be
lost without an error. Training goes through ``kernels/ops.py``.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build

#: launches per kernel since the last `reset_launches()`
launches = {
    "flash_attention": 0,
    "flash_attention_bwd_dq": 0,
    "flash_attention_bwd_dkdv": 0,
    "decode_attention": 0,
    "paged_decode_attention": 0,
    "selective_scan": 0,
    "selective_scan_bwd": 0,
}

#: flash launches (forward, and each of the two backward kernels) by the
#: body they ran, which follows from the dtype
variant_launches = {
    "flash_attention/tensor_core": 0,     # bf16: mma.sync
    "flash_attention/cuda_core": 0,       # f32: FMA
    "flash_attention_bwd/tensor_core": 0,
    "flash_attention_bwd/cuda_core": 0,
    "selective_scan_bwd/mamba1": 0,       # A (D, N): a decay per state
    "selective_scan_bwd/mamba2": 0,       # A (D,): one decay per channel
}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGS = {
    "decode_attention": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _I, _I, _F, _P],
    "paged_decode_attention": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "flash_attention": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _I, _F, _I, _P],
    "flash_attention_bwd_dkdv": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "flash_attention_bwd_dq": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                               _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "selective_scan": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _I, _I, _L, _L, _L, _L, _P],
    "selective_scan_bwd": [_I] + [_P] * 18 + [_I] * 7 + [_L] * 4 + [_P],
}
_LIB_OF = {
    "decode_attention": "decode_attention",
    "paged_decode_attention": "decode_attention",
    "flash_attention": "flash_attention",
    "flash_attention_bwd_dkdv": "flash_attention_bwd",
    "flash_attention_bwd_dq": "flash_attention_bwd",
    "selective_scan": "selective_scan",
    "selective_scan_bwd": "selective_scan_bwd",
}
_fns = {}


def reset_launches() -> None:
    for counts in (launches, variant_launches):
        for k in counts:
            counts[k] = 0


@contextlib.contextmanager
def recorded_launches():
    """Wrap a CUDA graph's capture: the launches made inside are recorded,
    not run, so they leave ``launches`` and ``variant_launches`` as they
    were and fill the dict yielded (key: launches) for ``add_launches``."""
    before = (dict(launches), dict(variant_launches))
    rec: Dict[str, int] = {}
    try:
        yield rec
    finally:
        for counts, old in zip((launches, variant_launches), before):
            for k, n in counts.items():
                if n != old[k]:
                    rec[k] = n - old[k]
                    counts[k] = old[k]


def add_launches(rec: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture recorded `rec`."""
    for k, n in rec.items():
        (variant_launches if k in variant_launches else launches)[k] += n


def _fn(name: str):
    f = _fns.get(name)
    if f is None:
        f = getattr(build.load(_LIB_OF[name]), name)
        f.argtypes = _SIGS[name]
        f.restype = ctypes.c_int
        _fns[name] = f
    return f


def _check(name: str, *tensors, dtype=None) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: tensors must lie on a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype} != {dtype}")


#: why each wrapper without a backward refuses inputs that require grad
_NO_BACKWARD = {
    "flash_attention": "differentiate through kernels.ops.attention, whose "
                       "FlashAttention runs the backward kernels",
    "decode_attention": "decode never trains; call it under torch.no_grad()",
    "paged_decode_attention": "decode never trains; call it under "
                              "torch.no_grad()",
    "selective_scan": "differentiate through kernels.ops.selective_scan or "
                      "ops.ssd, whose SelectiveScan runs the backward kernel",
}


def _no_grad(name: str, *tensors) -> None:
    """Raise where a launch would drop gradients: grad mode is on and an
    input requires grad, but the kernel's output has no autograd history."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward kernel here and would "
                           f"drop the inputs' gradients: "
                           f"{_NO_BACKWARD[name]}")


def _ints(name: str, t: torch.Tensor, n: int) -> torch.Tensor:
    if tuple(t.shape) != (n,):
        raise ValueError(f"{name}: expected ({n},) int32, got "
                         f"{tuple(t.shape)}")
    return t.to(torch.int32).contiguous()


def _run(name: str, variant: Optional[str], *args) -> None:
    """Launch entry point `name`; `variant` is its key in
    ``variant_launches``, or None."""
    err = _fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1
    if variant is not None:
        variant_launches[variant] += 1


def _body(family: str, t: torch.Tensor) -> str:
    """The ``variant_launches`` key of the body a `t.dtype` launch runs."""
    return family + ("/tensor_core" if t.dtype == torch.bfloat16
                     else "/cuda_core")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _window(window: Optional[int]) -> int:
    return -1 if window is None else int(window)


def _scale(sm_scale: Optional[float], hd: int) -> float:
    return float(sm_scale if sm_scale is not None else hd ** -0.5)


def _dtype(name: str, q: torch.Tensor) -> int:
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         "(float32 or bfloat16)")
    return _DTYPES[q.dtype]


DECODE_HEAD_DIMS = (32, 64, 80, 128, 256)
FLASH_HEAD_DIMS = (32, 64, 80, 128)
#: bytes of K and V rows (16-byte padded) one decode block stages
DECODE_KV_SMEM = 64 * 1024
#: decode blocks to aim for: a few waves over the H100's 132 SMs
DECODE_BLOCKS = 4 * 132
DECODE_MIN_CHUNK = 64
#: flash blocks (about one per SM) to keep when choosing the taller query
#: tile; scripts/flash_tile_sweep.py measures both heights
FLASH_MIN_BLOCKS = 128


def _decode_shape_ok(name: str, h: int, kv: int, hd: int) -> None:
    g = h // kv if kv and h % kv == 0 else 0
    if (g not in (1, 2, 4, 8, 16) or hd not in DECODE_HEAD_DIMS
            or g * hd > 1024):
        raise ValueError(f"{name}: unsupported heads/head_dim "
                         f"(H={h}, KV={kv}, hd={hd})")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def decode_plan(cap: int, b: int, kv: int, hd: int,
                itemsize: int) -> Tuple[int, int]:
    """Split-KV launch plan -> (chunk, splits): split s covers cache
    positions [s * chunk, min((s + 1) * chunk, cap)), so the splits cover
    [0, cap) once and none is empty. From host-known shapes only: `cap`
    is the cache's capacity (S, or max_pages * page). Enough splits for
    about DECODE_BLOCKS blocks over the (kv head, row) pairs, chunks of at
    least DECODE_MIN_CHUNK positions (a multiple of 16) and at most what
    DECODE_KV_SMEM holds."""
    row = hd * itemsize + 16
    max_chunk = max(16, DECODE_KV_SMEM // (2 * row) // 16 * 16)
    want = _cdiv(DECODE_BLOCKS, max(b * kv, 1))
    splits = max(1, min(want, _cdiv(cap, DECODE_MIN_CHUNK)))
    chunk = min(max_chunk, max(16, _cdiv(_cdiv(cap, splits), 16) * 16))
    return chunk, max(1, _cdiv(cap, chunk))


def flash_plan(b: int, sq: int, h: int) -> int:
    """Warps per block of the tensor-core flash body (16 query rows
    each): 8 (128-row query tiles, each K/V tile read from L2 once per
    128 rows) when that still gives FLASH_MIN_BLOCKS blocks, else 4."""
    return 8 if b * h * _cdiv(sq, 128) >= FLASH_MIN_BLOCKS else 4


#: (device index, stream) -> [partials f32, merge counters int32]
_scratch: Dict[Tuple[int, int], list] = {}


def _decode_scratch(dev: torch.device, stream: int, n_part: int,
                    n_counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-KV scratch of this device and stream, grown as needed.
    Launches on one stream run in order, so they can share it; the
    kernel returns every counter to zero."""
    st = _scratch.setdefault((dev.index, stream), [None, None])
    if st[0] is None or st[0].numel() < n_part:
        st[0] = torch.empty(max(n_part, 1), dtype=torch.float32, device=dev)
    if st[1] is None or st[1].numel() < n_counters:
        st[1] = torch.zeros(max(n_counters, 1), dtype=torch.int32,
                            device=dev)
    return st[0], st[1]


def _decode_launch(name, q, cap, kv, ptrs, dims, window, sm_scale):
    """Plan, scratch and launch shared by both decode wrappers: `ptrs` are
    the entry point's pointers before `out`, `dims` its ints before the
    plan."""
    b, h, hd = q.shape
    code = _dtype(name, q)
    chunk, splits = decode_plan(cap, b, kv, hd, q.element_size())
    n_ml = b * kv * splits * (h // kv) * 2
    stream = _stream()
    part, counters = _decode_scratch(q.device, stream, n_ml * (hd + 2) // 2,
                                     b * kv)
    out = torch.empty_like(q)
    _run(name, None, code, *ptrs,
         out.data_ptr(), part.data_ptr(), part.data_ptr() + 4 * n_ml,
         counters.data_ptr(), *dims, chunk, splits, _window(window),
         _scale(sm_scale, hd), stream)
    return out


def decode_attention(q, k, v, lengths, *, window=None, sm_scale=None):
    """q (B,H,hd), k/v (B,S,KV,hd), lengths (B,) -> (B,H,hd)."""
    name = "decode_attention"
    b, h, hd = q.shape
    _, s, kv, _ = k.shape
    _decode_shape_ok(name, h, kv, hd)
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"{name}: shape mismatch {q.shape} {k.shape} "
                         f"{v.shape}")
    _no_grad(name, q, k, v)
    lengths = _ints(name, lengths, b)
    _check(name, q, k, v, dtype=q.dtype)
    _check(name, lengths)
    return _decode_launch(
        name, q, s, kv,
        (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr()),
        (b, s, h, kv, hd), window, sm_scale)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           window=None, sm_scale=None):
    """q (B,H,hd), pools (P,page,KV,hd), block_tables (B,max_pages),
    lengths (B,) -> (B,H,hd)."""
    name = "paged_decode_attention"
    b, h, hd = q.shape
    p_total, page, kv, _ = k_pool.shape
    _decode_shape_ok(name, h, kv, hd)
    if k_pool.shape != v_pool.shape or k_pool.shape[3] != hd:
        raise ValueError(f"{name}: shape mismatch {q.shape} {k_pool.shape}")
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(f"{name}: block_tables must be (B, max_pages)")
    _no_grad(name, q, k_pool, v_pool)
    bt = block_tables.to(torch.int32).contiguous()
    lengths = _ints(name, lengths, b)
    _check(name, q, k_pool, v_pool, dtype=q.dtype)
    _check(name, bt, lengths)
    max_pages = bt.shape[1]
    return _decode_launch(
        name, q, max_pages * page, kv,
        (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(),
         lengths.data_ptr()),
        (b, p_total, page, max_pages, h, kv, hd), window, sm_scale)


def _flash_shapes(name, q, k, v, lengths):
    """Checks shared by the forward and backward wrappers -> (b, sq, sk,
    h, kv, hd, lengths as contiguous int32 or None)."""
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    if hd not in FLASH_HEAD_DIMS or kv == 0 or h % kv:
        raise ValueError(f"{name}: unsupported heads/head_dim "
                         f"(H={h}, KV={kv}, hd={hd})")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"{name}: shape mismatch {q.shape} {k.shape}")
    _check(name, q, k, v, dtype=q.dtype)
    lens = None
    if lengths is not None:
        lens = _ints(name, lengths, b)
        _check(name, lens)
    return b, sq, sk, h, kv, hd, lens


def flash_attention(q, k, v, *, causal=True, window=None, lengths=None,
                    q_offset=None, sm_scale=None, return_lse=False):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd) [, lengths (B,), q_offset (B,)]
    -> (B,Sq,H,hd), and with return_lse also lse (B,H,Sq) f32: each row's
    log-sum-exp of its scaled scores, -inf where nothing is attended."""
    name = "flash_attention"
    _no_grad(name, q, k, v)
    b, sq, sk, h, kv, hd, lens = _flash_shapes(name, q, k, v, lengths)
    offs = None
    if q_offset is not None:
        offs = _ints(name, q_offset, b)
        _check(name, offs)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    code = _dtype(name, q)
    _run(name, _body(name, q), code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
         lens.data_ptr() if lens is not None else None,
         offs.data_ptr() if offs is not None else None,
         out.data_ptr(), lse.data_ptr() if lse is not None else None,
         b, sq, sk, h, kv, hd, int(bool(causal)),
         _window(window), _scale(sm_scale, hd), flash_plan(b, sq, h),
         _stream())
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True,
                        window=None, lengths=None, q_offset=None,
                        sm_scale=None):
    """Gradients of ``flash_attention`` from its output `out` and `lse`
    and the output's gradient `dout` (B,Sq,H,hd) -> (dq, dk, dv) in the
    inputs' dtype. Two launches on one stream: dQ over query tiles, which
    also writes each row's Delta = rowsum(dO o O) into an f32 (B,H,Sq)
    buffer allocated here, then dK/dV over key tiles (GQA summed in the
    block), which reads it. bf16 runs the tensor-core bodies, f32 the
    CUDA-core ones in IEEE f32 (``variant_launches`` counts each launch by
    its body); both are deterministic. Training has no query offset, so
    `q_offset` is refused."""
    name = "flash_attention_bwd"
    if q_offset is not None:
        raise ValueError(f"{name}: q_offset has no use in training and the "
                         "backward kernels do not take it")
    b, sq, sk, h, kv, hd, lens = _flash_shapes(name, q, k, v, lengths)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"{name}: out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    if tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"{name}: lse {tuple(lse.shape)} must be "
                         f"{(b, h, sq)}")
    _check(name, out, dout, dtype=q.dtype)
    _check(name, lse, dtype=torch.float32)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _bwd_launch("flash_attention_bwd_dq", q, k, v, out, lse, dout, lens,
                delta, (dq,), causal, window, sm_scale)
    _bwd_launch("flash_attention_bwd_dkdv", q, k, v, out, lse, dout, lens,
                delta, (dk, dv), causal, window, sm_scale)
    return dq, dk, dv


def _bwd_launch(name, q, k, v, out, lse, dout, lens, delta, grads, causal,
                window, sm_scale) -> None:
    """One backward kernel, on tensors `flash_attention_bwd` has checked:
    dQ (`grads` = (dq,)) reads `out` and writes `delta`; dK/dV (`grads` =
    (dk, dv)) reads `delta`."""
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    lp = lens.data_ptr() if lens is not None else None
    if name == "flash_attention_bwd_dq":
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), dout.data_ptr(), lp, delta.data_ptr())
    else:
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dout.data_ptr(), lp)
    _run(name, _body("flash_attention_bwd", q),
         _dtype("flash_attention_bwd", q), *ptrs,
         *(g.data_ptr() for g in grads), b, sq, sk, h, kv, hd,
         int(bool(causal)), _window(window), _scale(sm_scale, hd), _stream())


SCAN_STATES = (4, 8, 16, 32, 64)
#: states per thread the kernel is built for (with 1 to 16 warps a block)
SCAN_NPL = (1, 2, 4, 8)
#: time steps staged per chunk the kernel is built for, most first
SCAN_STEPS = (64, 32)
SCAN_CHANNELS = 32          # channels per block, one per lane
SCAN_SMS = 132              # H100 SXM
SCAN_SM_SMEM = 228 * 1024   # shared memory of one SM, 1 KB of it per block
SCAN_SM_THREADS = 2048
#: warps per SM the grid must give before the plan takes more states per
#: thread, and warps per SM the steps per chunk may not push residency
#: under; both from scripts/scan_plan_sweep.py (PERF.md §6): at
#: 1 x 512, 4 states per thread (8 warps per SM) beat 2 (16 warps)
SCAN_MIN_WARPS = 8
SCAN_RESIDENT_WARPS = 16


class ScanPlan(NamedTuple):
    npl: int                # states per thread
    steps: int              # time steps staged per chunk
    grid: Tuple[int, int]   # (channel blocks, batch rows)
    threads: int            # 32 lanes (channels) x n / npl warps


def scan_npl_options(n: int) -> Tuple[int, ...]:
    """States per thread the kernel takes for d_state `n`."""
    return tuple(p for p in SCAN_NPL if n % p == 0 and n // p <= 16)


def scan_smem(steps: int, n: int, npl: int, itemsize: int) -> int:
    """Dynamic shared memory of one scan block, as
    csrc/selective_scan.cu:smem_bytes: x and dt as copied, dt and x by
    records (x in two buffers), the (B, C) pairs, and each warp's partial
    C.h per step."""
    c = SCAN_CHANNELS
    return (5 * steps * c * itemsize + 2 * steps * n * itemsize
            + (n // npl) * steps * c * 4)


def scan_resident_blocks(steps: int, n: int, npl: int, itemsize: int) -> int:
    """Scan blocks one SM holds by shared memory and threads."""
    return min(SCAN_SM_SMEM // (scan_smem(steps, n, npl, itemsize) + 1024),
               SCAN_SM_THREADS // (SCAN_CHANNELS * n // npl))


def scan_plan(b: int, s: int, d: int, n: int, itemsize: int = 2) -> ScanPlan:
    """Launch plan of the scan from host-known shapes only. Block (i, b)
    covers channels [32 i, 32 i + 32) of batch row b, lane l channel
    32 i + l, warp g states [g npl, (g + 1) npl). States per thread: of
    those with which an SM holds two blocks, the most (least shared-memory
    and epilogue work per exp) for which the grid still gives
    SCAN_MIN_WARPS warps per SM. Steps per chunk: the most (up to the
    sequence, rounded up to 32) with which an SM holds two blocks and
    SCAN_RESIDENT_WARPS warps, or all the grid gives it if fewer."""
    blocks = b * _cdiv(d, SCAN_CHANNELS)
    opts = [p for p in scan_npl_options(n) if scan_resident_blocks(
        SCAN_STEPS[-1], n, p, itemsize) >= 2]
    for npl in reversed(opts):
        if _cdiv(blocks, SCAN_SMS) * (n // npl) >= SCAN_MIN_WARPS:
            break
    warps = n // npl
    want = min(SCAN_RESIDENT_WARPS, _cdiv(blocks, SCAN_SMS) * warps)
    cap = max(SCAN_STEPS[-1], _cdiv(s, 32) * 32)
    steps = SCAN_STEPS[-1]
    for t in SCAN_STEPS:
        held = scan_resident_blocks(t, n, npl, itemsize)
        if t <= cap and held >= 2 and held * warps >= want:
            steps = t
            break
    return ScanPlan(npl, steps, (_cdiv(d, SCAN_CHANNELS), b),
                    SCAN_CHANNELS * warps)


def _scan_shapes(name, x, dt, A, B, C, D) -> int:
    """Checks shared by the scan's forward and backward wrappers -> N. A
    is (D, N), or (D,): one scalar per channel."""
    bsz, s, d = x.shape
    n = B.shape[-1]
    if n not in SCAN_STATES:
        raise ValueError(f"{name}: unsupported d_state {n} "
                         f"(one of {SCAN_STATES})")
    a_ok = tuple(A.shape) in ((d, n), (d,))
    if (dt.shape != x.shape or not a_ok or D.shape != (d,)
            or B.shape != (bsz, s, n) or C.shape != (bsz, s, n)):
        raise ValueError(f"{name}: shape mismatch x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} A {tuple(A.shape)} B "
                         f"{tuple(B.shape)} C {tuple(C.shape)} D "
                         f"{tuple(D.shape)}")
    _check(name, x, dt, dtype=x.dtype)
    if not all(t.is_cuda for t in (A, B, C, D)):
        raise ValueError(f"{name}: tensors must lie on a CUDA device")
    if any(t.dtype != x.dtype or t.stride(2) != 1 for t in (B, C)):
        raise ValueError(f"{name}: B and C need x's dtype and a unit last "
                         "stride")
    return n


def selective_scan(x, dt, A, B, C, D, *, return_state=False,
                   save_states=False):
    """x, dt (B,S,D) contiguous; A (D,N), or (D,) for one scalar per
    channel (Mamba-2's, ``ops.ssd_channel_args``), which the kernel reads
    expanded to (D,N); B, C (B,S,N) with unit last stride (strided views
    are fine); D (D,) -> y (B,S,D) in x's dtype, and
    with return_state also h_last (B,D,N) f32. With save_states (for
    training) -> (y, states, plan) instead: states (B, ceil(S/T), D, N)
    f32 holds h after each T-step chunk of the launch plan `plan` (T =
    plan.steps), which ``selective_scan_bwd`` takes with them; y is bitwise
    the same as without."""
    name = "selective_scan"
    if return_state and save_states:
        raise ValueError(f"{name}: return_state or save_states, not both "
                         "(the last chunk state is h_last)")
    _no_grad(name, x, dt, A, B, C, D)
    n = _scan_shapes(name, x, dt, A, B, C, D)
    bsz, s, d = x.shape
    if A.dim() == 1:
        A = A[:, None].expand(d, n)
    A = A.float().contiguous()
    D = D.float().contiguous()
    plan = scan_plan(bsz, s, d, n, x.element_size())
    y = torch.empty_like(x)
    h = (torch.empty((bsz, d, n), dtype=torch.float32, device=x.device)
         if return_state else None)
    states = (torch.empty((bsz, _cdiv(s, plan.steps), d, n),
                          dtype=torch.float32, device=x.device)
              if save_states else None)
    _run(name, None, _dtype(name, x), x.data_ptr(), dt.data_ptr(), A.data_ptr(),
         B.data_ptr(), C.data_ptr(), D.data_ptr(), y.data_ptr(),
         h.data_ptr() if h is not None else None,
         states.data_ptr() if states is not None else None, bsz, s, d, n,
         plan.npl, plan.steps, B.stride(0), B.stride(1), C.stride(0),
         C.stride(1), _stream())
    if save_states:
        return y, states, plan
    return (y, h) if return_state else y


def scan_bwd_cluster(d: int) -> int:
    """Channel blocks per cluster of the scan backward for d channels: the
    blocks of one batch row whose dB and dC sums it adds in distributed
    shared memory, the most of 8, 4, 2 and 1 that divides the channel
    blocks."""
    ncb = _cdiv(d, SCAN_CHANNELS)
    c = 8
    while ncb % c:
        c //= 2
    return c


def selective_scan_bwd(x, dt, A, B, C, D, states, dy, plan: ScanPlan):
    """Gradients of ``selective_scan`` from the forward's inputs, its chunk
    `states` and launch `plan` (``save_states=True``) and the output's
    gradient `dy` (B,S,D) -> (dx, ddt, dA, dB, dC, dD): dx, ddt (B,S,D)
    and dB, dC (B,S,N, contiguous) in x's dtype, dA (A's shape) and dD
    (D,) f32.

    A (D, N) runs the Mamba-1 body and gives dA (D, N). A (D,), one scalar
    per channel (Mamba-2's per-head A over its head's channels,
    ``ops.ssd_channel_args``; the forward kernel reads it expanded),
    runs the Mamba-2 body, which takes one decay per (b, t, channel), and
    gives dA (D,). ``variant_launches`` counts each call by its body. The
    backward reads the forward's chunk states at its `plan.steps` and
    takes its own states per thread. One call, two launches on one
    stream: the scan in reverse, which writes partial sums of dB and dC
    (over the channel blocks of a cluster, ``scan_bwd_cluster``) and of dA
    and dD (over batch rows) into f32 buffers allocated here, then the
    sums of those partials in a fixed order. Deterministic: no atomics."""
    name = "selective_scan_bwd"
    n = _scan_shapes(name, x, dt, A, B, C, D)
    per_channel = A.dim() == 1
    bsz, s, d = x.shape
    if dy.shape != x.shape:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} must be x's shape "
                         f"{tuple(x.shape)}")
    if plan.steps not in SCAN_STEPS:
        raise ValueError(f"{name}: {plan.steps} steps per chunk (one of "
                         f"{SCAN_STEPS})")
    want = (bsz, _cdiv(s, plan.steps), d, n)
    if tuple(states.shape) != want:
        raise ValueError(f"{name}: states {tuple(states.shape)} must be "
                         f"{want} for {plan.steps} steps per chunk")
    _check(name, dy, dtype=x.dtype)
    _check(name, states, dtype=torch.float32)
    A = A.float().contiguous()
    D = D.float().contiguous()
    cl = scan_bwd_cluster(d)
    ncl = _cdiv(d, SCAN_CHANNELS) // cl
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dB = torch.empty((bsz, s, n), dtype=x.dtype, device=x.device)
    dC = torch.empty_like(dB)
    dA = torch.empty(A.shape, dtype=torch.float32, device=x.device)
    dD = torch.empty((d,), dtype=torch.float32, device=x.device)
    # the partial sums: dB and dC per cluster, dA and dD per batch row
    parts = [torch.empty(shape, dtype=torch.float32, device=x.device)
             for shape in ((bsz, s, ncl, n), (bsz, s, ncl, n),
                           (bsz,) + tuple(A.shape), (bsz, d))]
    body = "mamba2" if per_channel else "mamba1"
    _run(name, f"{name}/{body}", _dtype(name, x), x.data_ptr(),
         dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
         D.data_ptr(), states.data_ptr(), dy.data_ptr(), dx.data_ptr(),
         ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
         dD.data_ptr(), *(t.data_ptr() for t in parts),
         bsz, s, d, n, plan.steps, int(per_channel), cl, B.stride(0),
         B.stride(1), C.stride(0), C.stride(1), _stream())
    return dx, ddt, dA, dB, dC, dD
