"""Dense decoder assembly: full-sequence forward and one decode step.

Weights are stacked with a leading layer axis, as in the reference
(``src/repro/models/transformer.py``), whose ``jax.lax.scan`` over the
layers becomes a Python loop here. Only the dense family is ported; the
other families raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import embed_apply, mlp_apply, rms_norm, unembed


def layer_params(tree, i: int):
    """Layer `i` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def _check_kind(cfg: ModelConfig) -> None:
    if cfg.kind != "dense":
        raise NotImplementedError(
            f"model kind {cfg.kind!r} is not ported yet (dense only)")


def forward(params, cfg: ModelConfig, batch, *,
            window: Optional[int] = None, collect_cache: bool = False,
            lengths=None, return_hidden: bool = False):
    """Full-sequence causal forward.

    Returns (logits, aux) or, with collect_cache, (logits, aux, parts)
    where parts = {"k": [L x (B, S, KV, hd)], "v": [...]} holds each
    layer's k/v planes for the cache. With return_hidden the final-normed
    hidden states replace the logits."""
    _check_kind(cfg)
    h = embed_apply(params["embed"], batch["tokens"])
    ks, vs = [], []
    for i in range(cfg.num_layers):
        bp = layer_params(params["blocks"], i)
        x = rms_norm(h, bp["attn_norm_scale"], cfg.norm_eps)
        a, k, v = attn.attn_prefill(bp["attn"], x, cfg, window=window,
                                    lengths=lengths)
        ks.append(k)
        vs.append(v)
        h = h + a
        x = rms_norm(h, bp["mlp_norm_scale"], cfg.norm_eps)
        h = h + mlp_apply(bp["mlp"], x)
    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    out = h if return_hidden else unembed(params, h)
    if collect_cache:
        return out, aux, {"k": ks, "v": vs}
    return out, aux


def decode_step(params, cfg: ModelConfig, tokens, cache, *,
                window: Optional[int] = None):
    """One decode iteration: tokens (B,) int32 -> (logits (B, V), cache').

    The cache's k/v are updated in place; the returned dict carries
    length + 1. A cache with `block_tables` routes through the page pool
    (one write plan serves every layer)."""
    _check_kind(cfg)
    lengths = cache["length"]
    h = embed_apply(params["embed"], tokens)
    paged = "block_tables" in cache
    plan = None
    if paged:
        plan = attn.paged_write_plan(cache["block_tables"], lengths,
                                     cache["k"].shape[1], cache["k"].shape[2])
    for i in range(cfg.num_layers):
        bp = layer_params(params["blocks"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        x = rms_norm(h, bp["attn_norm_scale"], cfg.norm_eps)
        if paged:
            a, _, _ = attn.attn_decode_paged(
                bp["attn"], x, kc, vc, cache["block_tables"], lengths, cfg,
                window=window, plan=plan)
        else:
            a, _, _ = attn.attn_decode(bp["attn"], x, kc, vc, lengths, cfg,
                                       window=window)
        h = h + a
        x = rms_norm(h, bp["mlp_norm_scale"], cfg.norm_eps)
        h = h + mlp_apply(bp["mlp"], x)
    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    logits = unembed(params, h)
    return logits, dict(cache, length=lengths + 1)
