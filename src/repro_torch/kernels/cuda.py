"""Python wrappers of the hand-written CUDA attention kernels.

Each wrapper checks device, dtype, shape, contiguity and alignment,
allocates the output with ``torch.empty``, launches on PyTorch's current
stream, raises if the launch returned a CUDA error, and adds one to its
entry in ``launches`` — there and nowhere else, so a run can show that it
went through the kernel. The kernels' sources and design notes are in
``csrc/``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

#: launches per kernel since the last `reset_launches()`
launches = {
    "flash_attention": 0,
    "decode_attention": 0,
    "paged_decode_attention": 0,
}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGS = {
    "decode_attention": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                         _P],
    "paged_decode_attention": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _F, _P],
    "flash_attention": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _I, _F, _P],
}
_LIB_OF = {
    "decode_attention": "decode_attention",
    "paged_decode_attention": "decode_attention",
    "flash_attention": "flash_attention",
}
_fns = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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


def _ints(name: str, t: torch.Tensor, n: int) -> torch.Tensor:
    if tuple(t.shape) != (n,):
        raise ValueError(f"{name}: expected ({n},) int32, got "
                         f"{tuple(t.shape)}")
    return t.to(torch.int32).contiguous()


def _run(name: str, *args) -> None:
    err = _fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1


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


def _decode_shape_ok(name: str, h: int, kv: int, hd: int) -> None:
    g = h // kv if kv and h % kv == 0 else 0
    if (g not in (1, 2, 4, 8, 16) or hd not in (32, 64, 128, 256)
            or g * hd > 1024):
        raise ValueError(f"{name}: unsupported heads/head_dim "
                         f"(H={h}, KV={kv}, hd={hd})")


def decode_attention(q, k, v, lengths, *, window=None, sm_scale=None):
    """q (B,H,hd), k/v (B,S,KV,hd), lengths (B,) -> (B,H,hd)."""
    name = "decode_attention"
    b, h, hd = q.shape
    _, s, kv, _ = k.shape
    _decode_shape_ok(name, h, kv, hd)
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"{name}: shape mismatch {q.shape} {k.shape} "
                         f"{v.shape}")
    lengths = _ints(name, lengths, b)
    _check(name, q, k, v, dtype=q.dtype)
    _check(name, lengths)
    out = torch.empty_like(q)
    _run(name, _dtype(name, q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
         lengths.data_ptr(), out.data_ptr(), b, s, h, kv, hd,
         _window(window), _scale(sm_scale, hd), _stream())
    return out


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
    bt = block_tables.to(torch.int32).contiguous()
    lengths = _ints(name, lengths, b)
    _check(name, q, k_pool, v_pool, dtype=q.dtype)
    _check(name, bt, lengths)
    out = torch.empty_like(q)
    _run(name, _dtype(name, q), q.data_ptr(), k_pool.data_ptr(),
         v_pool.data_ptr(), bt.data_ptr(), lengths.data_ptr(),
         out.data_ptr(), b, p_total, page, bt.shape[1], h, kv, hd,
         _window(window), _scale(sm_scale, hd), _stream())
    return out


def flash_attention(q, k, v, *, causal=True, window=None, lengths=None,
                    q_offset=None, sm_scale=None):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd) [, lengths (B,), q_offset (B,)]
    -> (B,Sq,H,hd)."""
    name = "flash_attention"
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    if hd not in (32, 64, 128) or kv == 0 or h % kv:
        raise ValueError(f"{name}: unsupported heads/head_dim "
                         f"(H={h}, KV={kv}, hd={hd})")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"{name}: shape mismatch {q.shape} {k.shape}")
    _check(name, q, k, v, dtype=q.dtype)
    lens = offs = None
    if lengths is not None:
        lens = _ints(name, lengths, b)
        _check(name, lens)
    if q_offset is not None:
        offs = _ints(name, q_offset, b)
        _check(name, offs)
    out = torch.empty_like(q)
    _run(name, _dtype(name, q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
         lens.data_ptr() if lens is not None else None,
         offs.data_ptr() if offs is not None else None,
         out.data_ptr(), b, sq, sk, h, kv, hd, int(bool(causal)),
         _window(window), _scale(sm_scale, hd), _stream())
    return out
