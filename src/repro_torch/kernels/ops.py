"""Dispatch of the kernel entry points by the tensors' device.

A CUDA tensor launches the hand-written kernel (``kernels/cuda.py``); a
CPU tensor takes the plain version (``kernels/ref.py``). There is no
fallback: a CUDA call the kernel cannot take raises. Unlike the
reference's dispatch (``src/repro/kernels/ops.py:48``), attention with
``lengths`` or ``q_offset`` launches the prefill kernel too, so the
serving path's bucketed and chunked prefill run on it. Likewise the
scan kernel also returns the final state, so the serving prefill
(``selective_scan_with_state``) runs on it and not only the full-sequence
forward.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import cuda as _cuda
from repro_torch.kernels import ref as _ref


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              lengths=None, q_offset=None, sm_scale: Optional[float] = None):
    """Prefill/train attention. q (B,Sq,H,hd), k/v (B,Sk,KV,hd)."""
    if q.is_cuda:
        return _cuda.flash_attention(
            q, k, v, causal=causal, window=window, lengths=lengths,
            q_offset=q_offset, sm_scale=sm_scale)
    return _ref.attention_ref(
        q, k, v, causal=causal, window=window, lengths=lengths,
        q_offset=q_offset, sm_scale=sm_scale)


def decode_attention(q, k, v, lengths, *, window: Optional[int] = None,
                     sm_scale: Optional[float] = None):
    """Single-token decode attention. q (B,H,hd), k/v (B,S,KV,hd)."""
    if q.is_cuda:
        return _cuda.decode_attention(q, k, v, lengths, window=window,
                                      sm_scale=sm_scale)
    return _ref.decode_attention_ref(q, k, v, lengths, window=window,
                                     sm_scale=sm_scale)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           window: Optional[int] = None,
                           sm_scale: Optional[float] = None):
    """Single-token decode attention over a physical KV page pool.
    q (B,H,hd); pools (P,page,KV,hd); block_tables (B,max_pages) int32
    (entries >= P are sentinels)."""
    if q.is_cuda:
        return _cuda.paged_decode_attention(
            q, k_pool, v_pool, block_tables, lengths, window=window,
            sm_scale=sm_scale)
    return _ref.paged_decode_attention_ref(
        q, k_pool, v_pool, block_tables, lengths, window=window,
        sm_scale=sm_scale)


def selective_scan(x, dt, A, B, C, D):
    """Mamba-1 selective scan. x, dt (B,S,D); A (D,N); B, C (B,S,N);
    D (D,) -> y (B,S,D) in x's dtype."""
    if x.is_cuda:
        return _cuda.selective_scan(x, dt, A, B, C, D)
    return _ref.selective_scan_ref(x, dt, A, B, C, D)


def selective_scan_with_state(x, dt, A, B, C, D):
    """The scan and its final state: -> (y (B,S,D), h_last (B,D,N) f32)."""
    if x.is_cuda:
        return _cuda.selective_scan(x, dt, A, B, C, D, return_state=True)
    return _ref.selective_scan_with_state_ref(x, dt, A, B, C, D)


def selective_scan_step(h, x, dt, A, B, C, D):
    """One decode step of the recurrence, plain torch on every device (as
    the reference: a handful of elementwise ops, no kernel)."""
    return _ref.selective_scan_step_ref(h, x, dt, A, B, C, D)
