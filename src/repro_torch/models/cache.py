"""Decode caches: static-slot KV, SSM-state or hybrid cache and the
physical page pool.

Layouts are the reference's (``src/repro/models/cache.py``):

  length        (B,)                       valid context tokens per slot
  ssm_h         (L, B, d_inner, N) f32     Mamba-1 scan state
  ssm_h         (L, B, NH, HD, N) f32      Mamba-2 scan state per head
  ssm_conv      (L, B, d_conv-1, d_inner)  Mamba-1 conv buffer
  ssm_conv      (L, B, d_conv-1, d_inner + 2N)  Mamba-2 conv buffer (x, B, C)
  k, v          (L, B, S_max, KV, hd)      contiguous cache rows
  k, v          (L, P, page, KV, hd)       physical page pool
  block_tables  (B, max_pages) int32       page ids per slot, ordered;
                                           entries >= P are sentinels
  cross_k/v     (L, B, S_enc, KV, hd)      enc-dec cross-attention memory
  enc_length    (B,) int32                 valid encoder positions

With ``kv_repeat`` r every k/v leaf (cross planes included, as the
reference's) holds KV * r heads.

A hybrid cache holds k/v for each application of the shared attention
block (L = num_layers // hybrid_attn_every) beside the Mamba-2 leaves
(L = its Mamba-2 layers, rounds x per_round in the reference's order).
An encoder-decoder cache (encdec, audio) holds the decoder's k/v and
each decoder layer's cross-attention k/v over the encoder's output,
written once at prefill and read by every decode step; it is never
paged.

For attention, `length` is the single validity gate in both layouts:
attention never reads past it, and the next decode write lands on the
first stale position, so rolling back a multi-step overshoot is
re-pinning `length`. Recurrent state has no such gate (ssm, hybrid).

The reference relies on JAX's out-of-range rules, which torch does not
share; each case is spelled out here: sentinel scatters drop, gathers
clamp sentinel ids to P-1.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def _num_attn_applications(cfg: ModelConfig) -> int:
    if cfg.kind == "ssm":
        return 0
    if cfg.hybrid_attn_every:
        return cfg.num_layers // cfg.hybrid_attn_every
    return cfg.num_layers


def _cache_device(device, abstract: bool) -> torch.device:
    """`device`, or ``meta`` for an abstract cache (shapes and dtypes
    only, nothing allocated: the reference's ShapeDtypeStruct leaves)."""
    return torch.device("meta") if abstract else resolve_device(device)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               enc_seq: int = 0, dtype=torch.bfloat16, device="cuda",
               abstract: bool = False, kv_repeat: int = 1):
    """Contiguous decode cache, zero-filled. Attention layers (or shared
    attention applications) get k/v; Mamba layers get the scan state
    ssm_h in f32 and the conv buffer ssm_conv in `dtype`, in the module
    docstring's Mamba-1 or Mamba-2 layout; an encoder-decoder gets
    cross_k/cross_v `enc_seq` positions deep and enc_length. With
    `abstract` every leaf is on the ``meta`` device."""
    dev = _cache_device(device, abstract)
    cache = {"length": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    kv = cfg.num_kv_heads * kv_repeat
    n = _num_attn_applications(cfg)
    if n:
        shape = (n, batch, max_seq, kv, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    n_ssm = len(cfg.ssm_layer_ids())
    if n_ssm:
        s, di = cfg.ssm, cfg.d_inner
        if s.version == 2:
            state = (di // s.headdim, s.headdim, s.d_state)
            conv_dim = di + 2 * s.d_state
        else:
            state, conv_dim = (di, s.d_state), di
        cache["ssm_h"] = torch.zeros((n_ssm, batch, *state),
                                     dtype=torch.float32, device=dev)
        cache["ssm_conv"] = torch.zeros((n_ssm, batch, s.d_conv - 1,
                                         conv_dim), dtype=dtype, device=dev)
    if cfg.kind in ("encdec", "audio"):
        shape = (cfg.num_layers, batch, enc_seq, kv, cfg.head_dim)
        cache["cross_k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["cross_v"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["enc_length"] = torch.zeros((batch,), dtype=torch.int32,
                                          device=dev)
    return cache


def supports_physical_paging(cfg: ModelConfig) -> bool:
    """Physical paging covers archs whose decode state is pure
    length-gated self-attention KV: recurrent state (ssm, hybrid) has no
    positional gate to page against, and encoder memory (encdec, audio)
    is a second, unpaged cache."""
    return cfg.kind in ("dense", "vlm", "moe")


def init_paged_cache(cfg: ModelConfig, batch: int, num_pages: int,
                     page_size: int, max_seq: int, *, dtype=torch.bfloat16,
                     device="cuda", abstract: bool = False,
                     kv_repeat: int = 1):
    """Physically paged decode cache; sentinel table entries equal
    `num_pages` so unallocated writes drop and gathers clamp. With
    `abstract` every leaf is on the ``meta`` device."""
    assert supports_physical_paging(cfg), cfg.kind
    assert 0 < page_size, page_size
    dev = _cache_device(device, abstract)
    n = _num_attn_applications(cfg)
    max_pages = -(-max_seq // page_size)
    shape = (n, num_pages, page_size, cfg.num_kv_heads * kv_repeat,
             cfg.head_dim)
    return {
        "length": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "block_tables": torch.full((batch, max_pages), num_pages,
                                   dtype=torch.int32, device=dev),
    }


def is_paged(cache) -> bool:
    return "block_tables" in cache


def paged_write_tokens(pool, block_tables, starts, seg, counts):
    """Scatter contiguous token segments into the page pool, in place.

    pool (L, P, page, KV, hd); block_tables (B, max_pages); seg
    (L, B, n, KV, hd) holds `counts[b]` valid tokens per row, landing at
    absolute positions starts[b] .. starts[b]+counts[b]. Positions beyond
    `counts`, past the table width, or routed to a sentinel page are
    dropped (the reference's mode="drop"). Returns the pool."""
    p_total, page = pool.shape[1], pool.shape[2]
    n = seg.shape[2]
    max_pages = block_tables.shape[1]
    dev = pool.device
    ar = torch.arange(n, device=dev)
    pos = starts.to(dev).long()[:, None] + ar[None]
    pg_idx = pos // page
    pid = block_tables.to(dev).long().gather(
        1, torch.clamp(pg_idx, max=max_pages - 1))
    valid = ((ar[None] < counts.to(dev).long()[:, None])
             & (pg_idx < max_pages) & (pid < p_total))
    bi, ni = valid.nonzero(as_tuple=True)
    pool[:, pid[bi, ni], (pos % page)[bi, ni]] = seg[:, bi, ni].to(pool.dtype)
    return pool


def paged_gather_rows(pool, table_rows, max_seq: int):
    """Rebuild contiguous cache rows from the pool: (L, P, page, KV, hd),
    table_rows (B, max_pages) -> (L, B, max_seq, KV, hd). Sentinels clamp
    to P-1; callers only read positions < length."""
    p_total = pool.shape[1]
    rows = pool[:, torch.clamp(table_rows.to(pool.device).long(),
                               max=p_total - 1)]
    flat = rows.reshape(rows.shape[0], rows.shape[1], -1, *rows.shape[4:])
    return flat[:, :, :max_seq]


def with_block_tables(cache, tables):
    """Re-pin the device block tables (returns a new dict)."""
    return dict(cache, block_tables=torch.as_tensor(
        tables, dtype=torch.int32).to(cache["length"].device))


def with_lengths(cache, lengths):
    """Re-pin the per-slot valid-context lengths (returns a new dict)."""
    return dict(cache, length=torch.as_tensor(
        lengths, dtype=torch.int32).to(cache["length"].device))


def supports_length_rollback(cfg: ModelConfig) -> bool:
    """True when `length` alone defines cache validity (attention caches),
    so decoding past a point and re-pinning `length` is a full rollback."""
    return cfg.kind not in ("ssm", "hybrid")
