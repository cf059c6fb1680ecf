"""Dispatch of the attention entry points by the tensors' device.

A CUDA tensor launches the hand-written kernel (``kernels/cuda.py``); a
CPU tensor takes the plain version (``kernels/ref.py``). There is no
fallback: a CUDA call the kernel cannot take raises. Unlike the
reference's dispatch (``src/repro/kernels/ops.py:48``), attention with
``lengths`` or ``q_offset`` launches the prefill kernel too, so the
serving path's bucketed and chunked prefill run on it.
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
