"""Plain PyTorch versions of the attention kernels.

The semantic ground truth, line for line with ``src/repro/kernels/ref.py``:
the CPU path of every dispatch in ``kernels/ops.py`` and the yardstick the
CUDA kernels are held against on the card. Fully masked rows follow this
reference (uniform average over the masked keys); the CUDA kernels write
zeros there, as the Pallas kernels do — the serving path never produces
such a row outside of padding that is dropped.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating KV heads (GQA)."""
    kv = k.shape[2]
    if kv == num_q_heads:
        return k
    assert num_q_heads % kv == 0, (num_q_heads, kv)
    return torch.repeat_interleave(k, num_q_heads // kv, dim=2)


def attention_ref(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Sk, KV, hd)
    v: torch.Tensor,            # (B, Sk, KV, hd)
    *,
    causal: bool = True,
    q_offset: Optional[torch.Tensor] = None,   # (B,) absolute pos of q[0]
    lengths: Optional[torch.Tensor] = None,    # (B,) valid kv length
    window: Optional[int] = None,              # sliding window size
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head attention with GQA, causality, per-request lengths and an
    optional sliding window. Returns (B, Sq, H, hd)."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    dev = q.device

    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    kv_pos = torch.arange(sk, device=dev)[None, None, None, :]
    if q_offset is None:
        q_pos = torch.arange(sq, device=dev)[None, None, :, None]
    else:
        q_pos = (q_offset.to(dev)[:, None, None, None]
                 + torch.arange(sq, device=dev)[None, None, :, None])
    mask = torch.ones(logits.shape, dtype=torch.bool, device=dev)
    if causal:
        mask &= kv_pos <= q_pos
    if lengths is not None:
        mask &= kv_pos < lengths.to(dev)[:, None, None, None]
    if window is not None:
        mask &= kv_pos > q_pos - window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def decode_attention_ref(
    q: torch.Tensor,            # (B, H, hd) — single new token per request
    k: torch.Tensor,            # (B, S, KV, hd) KV cache
    v: torch.Tensor,
    lengths: torch.Tensor,      # (B,) tokens in cache (incl. current)
    *,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-step decode attention against a static-slot KV cache."""
    out = attention_ref(
        q[:, None], k, v, causal=False, lengths=lengths,
        q_offset=lengths - 1, window=window, sm_scale=sm_scale,
    )
    return out[:, 0]


def paged_decode_attention_ref(
    q: torch.Tensor,             # (B, H, hd)
    k_pool: torch.Tensor,        # (P, page, KV, hd) physical page pool
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_pages) int32; >= P = sentinel
    lengths: torch.Tensor,       # (B,) tokens in cache (incl. current)
    *,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over a paged pool: gather each request's pages into
    a contiguous (B, max_pages*page, KV, hd) view (sentinels clamped to
    P-1; what they alias is masked by `lengths`) and defer to
    `decode_attention_ref`. When that view is as deep as the contiguous
    cache the result is bitwise the contiguous one (masked positions
    contribute exact zeros and the reduction shapes match)."""
    b = q.shape[0]
    p_total, page = k_pool.shape[0], k_pool.shape[1]
    bt = torch.clamp(block_tables.long(), max=p_total - 1)
    n_pages = bt.shape[1]
    k = k_pool[bt].reshape(b, n_pages * page, *k_pool.shape[2:])
    v = v_pool[bt].reshape(b, n_pages * page, *v_pool.shape[2:])
    return decode_attention_ref(q, k, v, lengths, window=window,
                                sm_scale=sm_scale)
