"""Decoder assembly: full-sequence forward and one decode step.

Weights are stacked with a leading layer axis, as in the reference
(``src/repro/models/transformer.py``), whose ``jax.lax.scan`` over the
layers becomes a Python loop here. Every family is ported: dense, vlm
(dense with a projected vision-patch prefix; logits over the text
positions only), moe (attention plus a routed-expert MLP), ssm
(Mamba-1), hybrid (Mamba-2 rounds, each followed by one weight-shared
attention+MLP block), and the encoder-decoders encdec and audio (a
bidirectional encoder over frame embeddings, then decoder layers of
causal self-attention, cross-attention over the encoder's output and an
MLP; audio applies no RoPE).

The encoder's entry dtype differs from the reference's on purpose.
Frames are f32 host arrays; in JAX ``f32 @ bf16`` promotes, so under
bf16 weights the reference's encoder runs in f32 and its cross planes
come out f32. ``f32 @ bf16`` raises in torch, so ``encode`` casts the
frames to the embedding's dtype: under bf16 weights the port's encoder
runs in bf16 (on the flash kernel's tensor-core body on the card) and
its cross planes are written in the cache's dtype. In f32 the two
agree, which is where the CPU differential tests hold them. Patch
embeddings are cast to ``vision_proj``'s dtype the same way.

Training (``forward(..., remat=True)`` under autograd) checkpoints each
layer — each round for hybrid — with ``torch.utils.checkpoint``
(non-reentrant): only the residual stream between layers is kept and
everything inside a layer is recomputed on the backward pass, the
counterpart of the reference's ``jax.checkpoint(nothing_saveable)``
(``src/repro/models/transformer.py:137``). ``forward`` and ``encode``
first split the stacked weights into per-layer views with
``torch.unbind`` (``unstack_layers``): under autograd a slice taken by
indexing back-propagates a zero tensor the size of the whole stack for
every layer, while unbind's backward stacks the layers' gradients once.
The decode paths index the stacks directly.

``kv_repeat`` (the reference's KV-head replication) reaches the
self-attention of the dense, vlm, moe and hybrid forwards and decode
steps; the encoder-decoders and the training forward (which passes 1)
do not take it, as the reference's do not.

While a ``torch.profiler`` session records, the dense and moe layers of
the prefill forward and of ``decode_step`` open profiler ranges
``repro_torch.norm``, ``repro_torch.attention`` and ``repro_torch.mlp``
around their sublayers (``obs.spans.sublayer_ranges``), so a trace puts
each launch down to its sublayer; otherwise they cost one check a call.

``verify_step`` and ``propose_step`` (speculative decoding) are loops
over ``decode_step`` with no host sync inside, as the reference's scans
are, so a verify window is bitwise the same decode steps taken one by
one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import embed_apply, mlp_apply, rms_norm, unembed
from repro_torch.models.layout import keep_layout
from repro_torch.obs.spans import active, sublayer_ranges, unranged


def layer_params(tree, i: int):
    """Layer `i` of a stacked parameter tree (views, no copies), or of
    one that ``unstack_layers`` split into per-layer lists."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


#: the stacked subtrees and how many leading layer axes they have
STACKED = {"blocks": 1, "enc_blocks": 1, "dec_blocks": 1, "rounds": 2}


def unstack_layers(params):
    """The stacked subtrees with each leaf split into (nested) per-layer
    lists of views by ``torch.unbind``; ``layer_params`` indexes either.
    A tree already split is returned as it is."""
    def split(t, depth):
        if isinstance(t, dict):
            return {k: split(v, depth) for k, v in t.items()}
        if not isinstance(t, torch.Tensor):
            return t
        parts = torch.unbind(t)
        return list(parts) if depth == 1 else [split(x, depth - 1)
                                               for x in parts]
    return {k: split(v, STACKED[k]) if k in STACKED else v
            for k, v in params.items()}


def remat_call(fn, remat: bool, *args):
    """One layer (or hybrid round) fn(h, ...) -> h' or (h', ...); with
    `remat` under autograd through non-reentrant
    ``torch.utils.checkpoint``, so only its inputs are kept and it is
    recomputed on the backward pass. h' keeps h's layout
    (``layout.keep_layout``)."""
    if remat and torch.is_grad_enabled():
        out = torch.utils.checkpoint.checkpoint(fn, *args,
                                                use_reentrant=False)
    else:
        out = fn(*args)
    if isinstance(out, tuple):
        return (keep_layout(out[0], args[0]), *out[1:])
    return keep_layout(out, args[0])


PORTED_KINDS = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec", "audio")
ENCDEC_KINDS = ("encdec", "audio")


def check_kind(cfg: ModelConfig) -> None:
    if cfg.kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"model kind {cfg.kind!r} is not ported yet "
            f"(ported: {', '.join(PORTED_KINDS)})")


def forward(params, cfg: ModelConfig, batch, *,
            window: Optional[int] = None, collect_cache: bool = False,
            lengths=None, return_hidden: bool = False,
            moe_seq_chunk: int = 0, remat: bool = False, moe_ep_mesh=None,
            kv_repeat: int = 1):
    """Full-sequence causal forward.

    batch: {"tokens": (B, S)} plus "patch_embeds" (B, P, d) for a vlm
    (a prefix of P positions; `lengths` then counts them) and "frames"
    (B, Se, d) [, "enc_lengths" (B,)] for an encoder-decoder.
    Returns (logits, aux) or, with collect_cache, (logits, aux, parts)
    where parts holds each layer's cache planes: {"k": [L x (B, S, KV,
    hd)], "v": [...]} for dense, vlm and moe (S includes a vlm's
    prefix), the same plus "cross_k"/"cross_v" [L x (B, Se, KV, hd)]
    for an encoder-decoder, {"ssm_h": [L x (B, di, N)],
    "ssm_conv": [L x (B, K-1, di)]} for ssm, and for hybrid k/v per
    round beside {"ssm_h": [L_ssm x (B, NH, HD, N)], "ssm_conv": [L_ssm x
    (B, K-1, di + 2N)]} in rounds x per_round order. With return_hidden the
    final-normed hidden states replace the logits. A moe model's aux is
    the sum of its layers' load-balance losses; with `lengths` padding
    positions are routed to no expert, and `moe_seq_chunk` routes over
    sequence chunks (``moe.moe_apply_chunked``) and `moe_ep_mesh`
    expert-parallel over that mesh (``distributed.moe_ep``, which takes
    precedence, as in the reference). With `remat` under autograd each
    layer (hybrid: each round) is checkpointed."""
    check_kind(cfg)
    params = unstack_layers(params)
    encdec = cfg.kind in ENCDEC_KINDS
    h = None if encdec else _embed_inputs(params, cfg, batch)
    if encdec:
        h, parts = _forward_encdec(params, cfg, batch, lengths,
                                   collect_cache, remat)
    elif cfg.kind == "ssm":
        h, parts = _forward_ssm(params, cfg, h, collect_cache, lengths,
                                remat)
    elif cfg.kind == "hybrid":
        h, parts = _forward_hybrid(params, cfg, h, window, collect_cache,
                                   lengths, remat, kv_repeat)
    else:
        h, parts, aux = _forward_dense(params, cfg, h, window, lengths,
                                       moe_seq_chunk, collect_cache, remat,
                                       moe_ep_mesh, kv_repeat)
    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    if cfg.kind == "vlm" and "patch_embeds" in batch:
        h = h[:, batch["patch_embeds"].shape[1]:]   # the text positions
    if cfg.kind != "moe":
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    out = h if return_hidden else unembed(params, h)
    if collect_cache:
        return out, aux, parts
    return out, aux


def _embed_inputs(params, cfg, batch):
    """Token embedding, behind a vlm's projected patch prefix."""
    h = embed_apply(params["embed"], batch["tokens"])
    if cfg.kind == "vlm" and "patch_embeds" in batch:
        w = params["vision_proj"]["kernel"]
        vis = batch["patch_embeds"].to(w.dtype) @ w
        h = torch.cat([vis.to(h.dtype), h], dim=1)
    return h


def encode(params, cfg: ModelConfig, enc_inputs, enc_lengths=None, *,
           remat: bool = False):
    """The encoder stack over frame embeddings (B, Se, d), bidirectional,
    keys at or past `enc_lengths` masked -> (B, Se, d). The frames are
    cast to the embedding's dtype (module docstring)."""
    def layer(h, bp):
        x = rms_norm(h, bp["attn_norm_scale"], cfg.norm_eps)
        a = attn.attn_train(bp["attn"], x, cfg, causal=False,
                            lengths=enc_lengths)
        return _add_mlp(bp, cfg, h, a)

    params = unstack_layers(params)
    h = enc_inputs.to(params["embed"]["table"].dtype)
    for i in range(cfg.num_encoder_layers):
        h = remat_call(layer, remat, h, layer_params(params["enc_blocks"], i))
    return rms_norm(h, params["enc_norm"]["scale"], cfg.norm_eps)


def _forward_encdec(params, cfg, batch, lengths, collect_cache=True,
                    remat=False):
    enc_lengths = batch.get("enc_lengths")
    enc_out = encode(params, cfg, batch["frames"], enc_lengths, remat=remat)
    h = embed_apply(params["embed"], batch["tokens"])

    def layer(h, bp):
        x = rms_norm(h, bp["self_norm_scale"], cfg.norm_eps)
        a, k, v = attn.attn_prefill(bp["self_attn"], x, cfg, lengths=lengths)
        h = h + a
        x = rms_norm(h, bp["cross_norm_scale"], cfg.norm_eps)
        ck, cv = attn.cross_attn_kv(bp["cross_attn"], enc_out, cfg)
        h = _add_mlp(bp, cfg, h, attn.cross_attn_apply(
            bp["cross_attn"], x, ck, cv, enc_lengths, cfg))
        return h, (k, v, ck, cv)

    parts = {"k": [], "v": [], "cross_k": [], "cross_v": []}
    for i in range(cfg.num_layers):
        h, planes = remat_call(layer, remat, h,
                           layer_params(params["dec_blocks"], i))
        if collect_cache:
            for key, t in zip(parts, planes):
                parts[key].append(t)
    return h, parts


def _forward_ssm(params, cfg, h, collect_cache, lengths, remat=False):
    def layer(h, bp):
        x = rms_norm(h, bp["norm_scale"], cfg.norm_eps)
        if collect_cache:
            y, st = ssm_lib.mamba1_prefill(bp["mamba"], x, cfg, lengths)
            return h + y, st
        return h + ssm_lib.mamba1_apply(bp["mamba"], x, cfg), None

    hs, convs = [], []
    for i in range(cfg.num_layers):
        h, st = remat_call(layer, remat, h, layer_params(params["blocks"], i))
        if collect_cache:
            hs.append(st["h"])
            convs.append(st["conv"])
    return h, {"ssm_h": hs, "ssm_conv": convs}


def _rounds(params):
    """(rounds, per_round) of a hybrid tree, stacked or unstacked."""
    scales = params["rounds"]["norm_scale"]
    return len(scales), len(scales[0])


def _add_mlp(bp, cfg, h, a, ranges=unranged):
    """Residual add of an attention output `a`, then the block's MLP
    (`ranges`: ``sublayer_ranges()``'s)."""
    with ranges("norm"):
        h = h + a
        x = rms_norm(h, bp["mlp_norm_scale"], cfg.norm_eps)
    with ranges("mlp"):
        return h + mlp_apply(bp["mlp"], x)


def _forward_hybrid(params, cfg, h, window, collect_cache, lengths,
                    remat=False, kv_repeat=1):
    shared = params["shared"]
    rounds, per = _rounds(params)

    def round_fn(h, rp):
        hs, convs = [], []
        for j in range(per):
            lp = layer_params(rp, j)
            x = rms_norm(h, lp["norm_scale"], cfg.norm_eps)
            if collect_cache:
                y, st = ssm_lib.mamba2_prefill(lp["mamba"], x, cfg, lengths)
                hs.append(st["h"])
                convs.append(st["conv"])
            else:
                y = ssm_lib.mamba2_apply(lp["mamba"], x, cfg)
            h = h + y
        x = rms_norm(h, shared["attn_norm_scale"], cfg.norm_eps)
        a, k, v = attn.attn_prefill(shared["attn"], x, cfg, window=window,
                                    lengths=lengths, kv_repeat=kv_repeat)
        return _add_mlp(shared, cfg, h, a), (k, v, hs, convs)

    ks, vs, hs, convs = [], [], [], []
    for r in range(rounds):
        h, (k, v, rh, rc) = remat_call(round_fn, remat, h,
                                   layer_params(params["rounds"], r))
        if collect_cache:
            ks.append(k)
            vs.append(v)
            hs += rh
            convs += rc
    return h, {"k": ks, "v": vs, "ssm_h": hs, "ssm_conv": convs}


def _moe_mlp(bp, cfg, h, a, valid, seq_chunk, ep_mesh=None, cap=None):
    """Residual add of an attention output `a`, then the block's MoE
    layer -> (h', aux); `cap` (slots per expert) reaches ``moe_apply``."""
    h = h + a
    x = rms_norm(h, bp["mlp_norm_scale"], cfg.norm_eps)
    if ep_mesh is not None:
        from repro_torch.distributed.moe_ep import moe_apply_ep
        y, aux = moe_apply_ep(bp["moe"], x, cfg, ep_mesh, valid=valid)
    elif seq_chunk:
        y, aux = moe_lib.moe_apply_chunked(bp["moe"], x, cfg, valid=valid,
                                           seq_chunk=seq_chunk)
    else:
        y, aux = moe_lib.moe_apply(bp["moe"], x, cfg, valid=valid, cap=cap)
    return h + y, aux


def _forward_dense(params, cfg, h, window, lengths, moe_seq_chunk,
                   collect_cache=True, remat=False, moe_ep_mesh=None,
                   kv_repeat=1):
    valid = None
    if lengths is not None:
        valid = (torch.arange(h.shape[1], device=h.device)[None]
                 < lengths[:, None])
    ranges = sublayer_ranges()

    def layer(h, bp):
        with ranges("norm"):
            x = rms_norm(h, bp["attn_norm_scale"], cfg.norm_eps)
        with ranges("attention"):
            a, k, v = attn.attn_prefill(bp["attn"], x, cfg, window=window,
                                        lengths=lengths, kv_repeat=kv_repeat)
        if cfg.kind == "moe":
            with ranges("mlp"):
                h, aux = _moe_mlp(bp, cfg, h, a, valid, moe_seq_chunk,
                                  moe_ep_mesh)
        else:
            h, aux = _add_mlp(bp, cfg, h, a, ranges), None
        return h, k, v, aux

    ks, vs, auxs = [], [], []
    for i in range(cfg.num_layers):
        h, k, v, aux = remat_call(layer, remat, h,
                              layer_params(params["blocks"], i))
        if collect_cache:
            ks.append(k)
            vs.append(v)
        if aux is not None:
            auxs.append(aux)
    aux = torch.stack(auxs).sum() if auxs else None
    return h, {"k": ks, "v": vs}, aux


def decode_step(params, cfg: ModelConfig, tokens, cache, *,
                window: Optional[int] = None, kv_repeat: int = 1,
                live: Optional[moe_lib.LiveRows] = None):
    """One decode iteration: tokens (B,) int32 -> (logits (B, V), cache').

    The cache's k/v (or ssm_h/ssm_conv, or all four for hybrid) are
    updated in place (an encoder-decoder's cross planes are only read);
    the returned dict carries length + 1. A cache with
    `block_tables` routes through the page pool (one write plan serves
    every layer).

    A moe model routes the `live` rows only (``moe.LiveRows``), at one
    slot per live row and expert, so nothing drops and each row is
    routed as a call of its own; with `live` None it routes every row
    under ``moe.capacity(B)``, as the reference does. Into the log with a
    span open on this thread (the engine's ``engine.decode_block``) it
    counts ``moe.routed_slots`` (routed rows x top-k) and
    ``moe.expert_rows`` (experts x capacity: the rows the expert products
    compute), each over every layer."""
    check_kind(cfg)
    lengths = cache["length"]
    h = embed_apply(params["embed"], tokens)
    if cfg.kind == "ssm":
        h = _decode_ssm(params, cfg, h, cache)
    elif cfg.kind in ENCDEC_KINDS:
        h = _decode_encdec(params, cfg, h, cache, window)
    elif cfg.kind == "hybrid":
        h = _decode_hybrid(params, cfg, h, cache, window, kv_repeat)
    else:
        h = _decode_dense(params, cfg, h, cache, window, kv_repeat, live)
    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params, h), dict(cache, length=lengths + 1)


def _decode_ssm(params, cfg, h, cache):
    for i in range(cfg.num_layers):
        bp = layer_params(params["blocks"], i)
        x = rms_norm(h, bp["norm_scale"], cfg.norm_eps)
        y, st = ssm_lib.mamba1_decode(
            bp["mamba"], x,
            {"h": cache["ssm_h"][i], "conv": cache["ssm_conv"][i]}, cfg)
        cache["ssm_h"][i] = st["h"]
        cache["ssm_conv"][i] = st["conv"]
        h = keep_layout(h + y, h)
    return h


def _decode_hybrid(params, cfg, h, cache, window, kv_repeat=1):
    shared = params["shared"]
    rounds, per = _rounds(params)
    lengths = cache["length"]
    for r in range(rounds):
        rp = layer_params(params["rounds"], r)
        for j in range(per):
            lp = layer_params(rp, j)
            i = r * per + j
            x = rms_norm(h, lp["norm_scale"], cfg.norm_eps)
            y, st = ssm_lib.mamba2_decode(
                lp["mamba"], x,
                {"h": cache["ssm_h"][i], "conv": cache["ssm_conv"][i]}, cfg)
            cache["ssm_h"][i] = st["h"]
            cache["ssm_conv"][i] = st["conv"]
            h = h + y
        x = rms_norm(h, shared["attn_norm_scale"], cfg.norm_eps)
        a, _, _ = attn.attn_decode(shared["attn"], x, cache["k"][r],
                                   cache["v"][r], lengths, cfg, window=window,
                                   kv_repeat=kv_repeat)
        h = keep_layout(_add_mlp(shared, cfg, h, a), h)
    return h


def _decode_encdec(params, cfg, h, cache, window):
    """Decoder layers over the cache: self-attention decode, then
    cross-attention of the one new position over the layer's cross
    planes up to enc_length (the prefill kernel at Sq = 1 on the card,
    as the reference's ``ops.attention``)."""
    lengths, enc_lengths = cache["length"], cache["enc_length"]
    for i in range(cfg.num_layers):
        bp = layer_params(params["dec_blocks"], i)
        x = rms_norm(h, bp["self_norm_scale"], cfg.norm_eps)
        a, _, _ = attn.attn_decode(bp["self_attn"], x, cache["k"][i],
                                   cache["v"][i], lengths, cfg, window=window)
        h = h + a
        x = rms_norm(h, bp["cross_norm_scale"], cfg.norm_eps)
        c = attn.cross_attn_apply(bp["cross_attn"], x[:, None],
                                  cache["cross_k"][i], cache["cross_v"][i],
                                  enc_lengths, cfg)
        h = keep_layout(_add_mlp(bp, cfg, h, c[:, 0]), h)
    return h


def _moe_decode_plan(cfg, rows: int, live):
    """(valid (B, 1) or None, slots per expert) of a moe decode step over
    `rows` rows, counted into the active span log (``decode_step``)."""
    m = cfg.moe
    if live is None:
        valid, routed, cap = None, rows, moe_lib.capacity(rows, cfg)
    else:
        valid, routed = live.mask[:, None], live.count
        cap = max(live.count, 1)
    log = active()
    if log is not None:
        n = cfg.num_layers
        log.count(("moe.routed_slots", n * routed * m.top_k),
                  ("moe.expert_rows", n * m.num_experts * cap))
    return valid, cap


def _decode_dense(params, cfg, h, cache, window, kv_repeat=1, live=None):
    lengths = cache["length"]
    paged = "block_tables" in cache
    plan = None
    if paged:
        plan = attn.paged_write_plan(cache["block_tables"], lengths,
                                     cache["k"].shape[1], cache["k"].shape[2])
    if cfg.kind == "moe":
        valid, cap = _moe_decode_plan(cfg, h.shape[0], live)
    ranges = sublayer_ranges()
    for i in range(cfg.num_layers):
        bp = layer_params(params["blocks"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        with ranges("norm"):
            x = rms_norm(h, bp["attn_norm_scale"], cfg.norm_eps)
        with ranges("attention"):
            if paged:
                a, _, _ = attn.attn_decode_paged(
                    bp["attn"], x, kc, vc, cache["block_tables"], lengths,
                    cfg, window=window, plan=plan, kv_repeat=kv_repeat)
            else:
                a, _, _ = attn.attn_decode(bp["attn"], x, kc, vc, lengths,
                                           cfg, window=window,
                                           kv_repeat=kv_repeat)
        if cfg.kind == "moe":
            with ranges("mlp"):
                h2, _ = _moe_mlp(bp, cfg, h[:, None], a[:, None], valid, 0,
                                 cap=cap)
            h2 = h2[:, 0]
        else:
            h2 = _add_mlp(bp, cfg, h, a, ranges)
        h = keep_layout(h2, h)
    return h


def verify_step(params, cfg: ModelConfig, tokens, cache, *,
                window: Optional[int] = None, kv_repeat: int = 1):
    """Verify a T-token proposal window: tokens (B, T) int32 ->
    (logits (B, T, V), cache') with the cache's length advanced by T.

    Position j consumes tokens[:, j] against the cache as grown by the
    positions before it: T `decode_step` calls, exactly as T sequential
    decode iterations, so the logits are bitwise theirs (the speculative
    engine's lossless gate rests on it). Rejected positions leave stale
    k/v past the accepted length, which the caller rolls back by
    `length` alone."""
    out = []
    for j in range(tokens.shape[1]):
        logits, cache = decode_step(params, cfg, tokens[:, j], cache,
                                    window=window, kv_repeat=kv_repeat)
        out.append(logits)
    return torch.stack(out, dim=1), cache


def propose_step(params, cfg: ModelConfig, tokens, cache, k: int, *,
                 window: Optional[int] = None, kv_repeat: int = 1):
    """Greedy k+1 draft tokens: step 0 consumes `tokens` (B,), each later
    step its own argmax (first max wins on ties, as jnp.argmax), with no
    host sync. The (k+1)-th step keeps the draft cache's invariant
    (serving/speculative.py). Returns (proposals (B, k+1) int32,
    cache')."""
    out = []
    tok = tokens
    for _ in range(k + 1):
        logits, cache = decode_step(params, cfg, tok, cache, window=window,
                                    kv_repeat=kv_repeat)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1), cache
