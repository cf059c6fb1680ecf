"""Attention blocks (GQA, optional QKV bias, RoPE, sliding window).

Weight layout per (stacked) layer, ``x @ W`` orientation as in the
reference (``src/repro/models/attention.py``):
  wq (d, H*hd), wk (d, KV*hd), wv (d, KV*hd), wo (H*hd, d)
  [bq (H*hd,), bk, bv when qkv_bias]

Entry points:
  - ``attn_train``:       full-sequence self-attention, causal or not
                          (the encoder's is bidirectional)
  - ``attn_prefill``:     causal prompt attention, also returns k/v
  - ``attn_decode``:      one token against a contiguous cache row
  - ``attn_decode_paged``: one token against a physical page pool
  - ``cross_attn_kv`` / ``cross_attn_apply``: an encoder-decoder's
                          cross-attention over the encoder's output
The audio kind (SeamlessM4T) applies no RoPE anywhere, as the reference.
The decode entry points write the new k/v into the cache IN PLACE (the
reference returns new arrays); they return the same tensors so call
sites read like the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rope


def _rope_on(cfg: ModelConfig) -> bool:
    return cfg.kind != "audio"


def _qkv(p, x, cfg: ModelConfig, positions, *, apply_rope: bool):
    b, s = x.shape[0], x.shape[1]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if apply_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_train(p, x, cfg: ModelConfig, *, causal: bool = True,
               window: Optional[int] = None, lengths=None):
    """Full-sequence self-attention (causal, or bidirectional for the
    encoder) with keys at or past `lengths` masked."""
    o, _, _ = _self_attn(p, x, cfg, causal, window, lengths)
    return o


def attn_prefill(p, x, cfg: ModelConfig, *, window: Optional[int] = None,
                 lengths=None):
    """Causal self-attention over a (right-padded) prompt; also returns
    the k/v planes for the cache."""
    return _self_attn(p, x, cfg, True, window, lengths)


def _self_attn(p, x, cfg, causal, window, lengths):
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q, k, v = _qkv(p, x, cfg, positions, apply_rope=_rope_on(cfg))
    o = ops.attention(q, k, v, causal=causal, window=window, lengths=lengths)
    return o.reshape(b, s, -1) @ p["wo"], k, v


def attn_decode(p, x_tok, k_cache, v_cache, lengths, cfg: ModelConfig, *,
                window: Optional[int] = None):
    """One-token decode.

    x_tok (B, d); k_cache/v_cache (B, S, KV, hd) hold `lengths` (B,) valid
    tokens. Writes the new k/v at position `lengths` — clamped to S-1, as
    the reference's dynamic_update_slice clamps — and attends over
    lengths+1 tokens. Returns (out (B, d), k_cache, v_cache)."""
    b = x_tok.shape[0]
    q, k_new, v_new = _qkv(p, x_tok[:, None, :], cfg, lengths[:, None],
                           apply_rope=_rope_on(cfg))
    idx = torch.clamp(lengths.long(), max=k_cache.shape[1] - 1)
    rows = torch.arange(b, device=x_tok.device)
    k_cache[rows, idx] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, idx] = v_new[:, 0].to(v_cache.dtype)
    o = ops.decode_attention(q[:, 0], k_cache, v_cache, lengths + 1,
                             window=window)
    return o.reshape(b, -1) @ p["wo"], k_cache, v_cache


def paged_write_plan(block_tables, lengths, num_pages: int, page: int):
    """Where each slot's decode write lands in the pool, without a host
    sync: (page ids, offsets, keep mask, representative row).

    The reference scatters with mode="drop" (targets >= P vanish); torch
    has no such mode. Dropped rows are redirected to the target of a kept
    row with that row's own value (or, when no row is kept, all to one
    cell with its current value), so duplicate indices always carry equal
    values and the result is deterministic. The plan depends only on the
    tables and lengths, so one plan serves every layer of a step."""
    max_pages = block_tables.shape[1]
    pg_idx = torch.clamp(lengths.long() // page, max=max_pages - 1)
    pid = block_tables.long().gather(1, pg_idx[:, None])[:, 0]
    off = lengths.long() % page
    keep = pid < num_pages
    rep = torch.argmax(keep.to(torch.int32))    # first kept row, else 0
    tgt_pid = torch.clamp(torch.where(keep, pid, pid[rep]), max=num_pages - 1)
    tgt_off = torch.where(keep, off, off[rep])
    return tgt_pid, tgt_off, keep, rep


def _paged_write(pool, plan, new):
    tgt_pid, tgt_off, keep, rep = plan
    cur = pool[tgt_pid[rep], tgt_off[rep]]
    rep_val = torch.where(keep[rep], new[rep], cur)
    pool[tgt_pid, tgt_off] = torch.where(keep[:, None, None], new,
                                         rep_val[None])


def attn_decode_paged(p, x_tok, k_pool, v_pool, block_tables, lengths,
                      cfg: ModelConfig, *, window: Optional[int] = None,
                      plan=None):
    """One-token decode against a physically paged KV pool.

    x_tok (B, d); k_pool/v_pool (P, page, KV, hd); block_tables
    (B, max_pages) int32 (entries >= P are sentinels). Writes the new k/v
    at page block_tables[b, min(lengths[b] // page, max_pages-1)], offset
    lengths[b] % page — sentinel targets drop — then attends through the
    table. `plan` is `paged_write_plan(...)` when the caller shares one
    across layers. Returns (out (B, d), k_pool, v_pool)."""
    b = x_tok.shape[0]
    q, k_new, v_new = _qkv(p, x_tok[:, None, :], cfg, lengths[:, None],
                           apply_rope=_rope_on(cfg))
    if plan is None:
        plan = paged_write_plan(block_tables, lengths, k_pool.shape[0],
                                k_pool.shape[1])
    _paged_write(k_pool, plan, k_new[:, 0].to(k_pool.dtype))
    _paged_write(v_pool, plan, v_new[:, 0].to(v_pool.dtype))
    o = ops.paged_decode_attention(q[:, 0], k_pool, v_pool, block_tables,
                                   lengths + 1, window=window)
    return o.reshape(b, -1) @ p["wo"], k_pool, v_pool


def cross_attn_kv(p, enc_out, cfg: ModelConfig):
    """Cross-attention k/v (B, Se, KV, hd) of the encoder's output, no
    RoPE."""
    b, s, _ = enc_out.shape
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    k = (enc_out @ p["wk"]).reshape(b, s, kv, hd)
    v = (enc_out @ p["wv"]).reshape(b, s, kv, hd)
    return k, v


def cross_attn_apply(p, x, k, v, enc_lengths, cfg: ModelConfig):
    """x (B, Sq, d) attends, bidirectionally, over the encoder memory k/v
    (B, Se, KV, hd) up to `enc_lengths` (None: all of it). The prefill
    kernel takes it at every Sq, decode's Sq = 1 included, as the
    reference's ``ops.attention`` does."""
    b, sq, _ = x.shape
    q = (x @ p["wq"]).reshape(b, sq, cfg.num_heads, cfg.head_dim)
    o = ops.attention(q, k, v, causal=False, lengths=enc_lengths)
    return o.reshape(b, sq, -1) @ p["wo"]
