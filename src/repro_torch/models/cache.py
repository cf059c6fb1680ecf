"""Decode caches: static-slot KV cache and the physical page pool.

Layouts are the reference's (``src/repro/models/cache.py``):

  length        (B,)                       valid context tokens per slot
  k, v          (L, B, S_max, KV, hd)      contiguous cache rows
  k, v          (L, P, page, KV, hd)       physical page pool
  block_tables  (B, max_pages) int32       page ids per slot, ordered;
                                           entries >= P are sentinels

`length` is the single validity gate in both layouts: attention never
reads past it, and the next decode write lands on the first stale
position, so rolling back a multi-step overshoot is re-pinning `length`.

The reference relies on JAX's out-of-range rules, which torch does not
share; each case is spelled out here: sentinel scatters drop, gathers
clamp sentinel ids to P-1.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def _num_attn_applications(cfg: ModelConfig) -> int:
    if cfg.kind not in ("dense", "vlm", "moe"):
        raise NotImplementedError(
            f"model kind {cfg.kind!r} is not ported yet (dense only)")
    return cfg.num_layers


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               dtype=torch.bfloat16, device="cuda"):
    """Contiguous decode cache, zero-filled."""
    dev = resolve_device(device)
    n = _num_attn_applications(cfg)
    shape = (n, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {
        "length": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
    }


def supports_physical_paging(cfg: ModelConfig) -> bool:
    """Physical paging covers archs whose decode state is pure
    length-gated self-attention KV."""
    return cfg.kind in ("dense", "vlm", "moe")


def init_paged_cache(cfg: ModelConfig, batch: int, num_pages: int,
                     page_size: int, max_seq: int, *, dtype=torch.bfloat16,
                     device="cuda"):
    """Physically paged decode cache; sentinel table entries equal
    `num_pages` so unallocated writes drop and gathers clamp."""
    assert supports_physical_paging(cfg), cfg.kind
    assert 0 < page_size, page_size
    dev = resolve_device(device)
    n = _num_attn_applications(cfg)
    max_pages = -(-max_seq // page_size)
    shape = (n, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
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
        tables, dtype=torch.int32).to(cache["k"].device))


def with_lengths(cache, lengths):
    """Re-pin the per-slot valid-context lengths (returns a new dict)."""
    return dict(cache, length=torch.as_tensor(
        lengths, dtype=torch.int32).to(cache["k"].device))


def supports_length_rollback(cfg: ModelConfig) -> bool:
    """True when `length` alone defines cache validity (attention caches),
    so decoding past a point and re-pinning `length` is a full rollback."""
    return cfg.kind not in ("ssm", "hybrid")
