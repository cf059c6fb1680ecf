"""FLOP and byte counts of a model step and of each attention kernel, from
shapes alone, and the roofline bound they give on one H100.

The counts follow the kernels' bound arithmetic that the port's PERF.md
kept (section "How the bounds are counted"): each input read once and each
output written once over the HBM bandwidth, against the operations over
the bf16 tensor-core peak; attention is 4 * H * hd FLOPs per attended
(query, key) pair. Only the work the inputs need is counted: valid tokens,
not padding; active rows, not empty slots; the top-k experts a token is
routed to, not every expert a batched product touches.

`model` below is the ``model`` block of a configuration file.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

from qoebench.frozen.hardware import PEAK_BF16_FLOPS, PEAK_HBM_BW

BF16 = 2


def head_dim(model: dict) -> int:
    return int(model.get("head_dim") or model["d_model"] // model["num_heads"])


def layer_matmul_params(model: dict) -> int:
    """Weights one token multiplies through in one layer: the attention
    projections and the MLP, or for a moe layer the router, the shared
    experts and its top-k routed experts."""
    d, h, kv, hd = (model["d_model"], model["num_heads"],
                    model["num_kv_heads"], head_dim(model))
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    moe = model.get("moe")
    if moe:
        f = moe["d_expert"]
        mlp = (d * moe["num_experts"]
               + 3 * d * f * (moe["top_k"] + moe["num_shared_experts"]))
    else:
        mlp = (3 if model.get("gated_mlp", True) else 2) * d * model["d_ff"]
    return attn + mlp


def unembed_params(model: dict) -> int:
    return model["d_model"] * model["vocab_size"]


def attention_flops(model: dict, pairs: float) -> float:
    """All layers' attention FLOPs over `pairs` attended (query, key) pairs."""
    return 4.0 * model["num_heads"] * head_dim(model) * pairs \
        * model["num_layers"]


def causal_pairs(lengths: Iterable[int]) -> float:
    n = np.asarray(list(lengths), dtype=np.float64)
    return float(np.sum(n * (n + 1) / 2))


def prefill_flops(model: dict, lengths: Iterable[int]) -> float:
    """One prefill call over rows of these valid lengths: every valid token
    through every layer, causal attention over its row, and the unembed
    of each row's last position (the only logits a prefill returns)."""
    lengths = list(lengths)
    tokens = float(sum(lengths))
    return (2.0 * layer_matmul_params(model) * model["num_layers"] * tokens
            + attention_flops(model, causal_pairs(lengths))
            + 2.0 * unembed_params(model) * len(lengths))


def decode_flops(model: dict, attended: Iterable[int]) -> float:
    """One decode iteration of the active rows, row r attending
    `attended[r]` positions (its context and the new token)."""
    attended = list(attended)
    rows = len(attended)
    return (2.0 * (layer_matmul_params(model) * model["num_layers"]
                   + unembed_params(model)) * rows
            + attention_flops(model, float(sum(attended))))


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the chip can take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BW)


def flash_bound_s(model: dict, lengths: Iterable[int]) -> float:
    """One layer's flash launch over rows of these valid lengths: q, k, v
    read and o written once (bf16), 4 * H * hd FLOPs per causal pair."""
    lengths = list(lengths)
    h, kv, hd = model["num_heads"], model["num_kv_heads"], head_dim(model)
    tokens = float(sum(lengths))
    nbytes = tokens * (2 * h + 2 * kv) * hd * BF16
    flops = 4.0 * h * hd * causal_pairs(lengths)
    return roofline_s(flops, nbytes)


def decode_bound_s(model: dict, attended: Iterable[int],
                   page_size: int = 16) -> float:
    """One layer's paged-decode launch: each active row's k and v over the
    positions it attends, its block-table entries, q read and o written."""
    attended = np.asarray(list(attended), dtype=np.float64)
    h, kv, hd = model["num_heads"], model["num_kv_heads"], head_dim(model)
    rows = float(attended.size)
    nbytes = (float(attended.sum()) * 2 * kv * hd * BF16
              + float(np.ceil(attended / page_size).sum()) * 4
              + rows * 2 * h * hd * BF16)
    flops = 4.0 * h * hd * float(attended.sum())
    return roofline_s(flops, nbytes)


def param_count(model: dict) -> int:
    """Every weight of the model (all experts), as the port stores them."""
    d, L, V = model["d_model"], model["num_layers"], model["vocab_size"]
    h, kv, hd = model["num_heads"], model["num_kv_heads"], head_dim(model)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d + 2 * d
    if model.get("qkv_bias"):
        attn += (h + 2 * kv) * hd
    moe = model.get("moe")
    if moe:
        f = moe["d_expert"]
        mlp = d * moe["num_experts"] + 3 * d * f * (
            moe["num_experts"] + moe["num_shared_experts"])
    else:
        mlp = (3 if model.get("gated_mlp", True) else 2) * d * model["d_ff"]
    head = 0 if model.get("tie_embeddings") else V * d
    return V * d + head + d + L * (attn + mlp)


def kv_token_bytes(model: dict) -> int:
    return 2 * model["num_layers"] * model["num_kv_heads"] \
        * head_dim(model) * BF16


def decode_step_s(model: dict, attended: Iterable[int]) -> float:
    """Least time of one decode iteration: every weight read once, each
    active row's attended k/v read and its new k/v written, against
    decode_flops."""
    attended = list(attended)
    nbytes = (param_count(model) * BF16
              + (float(sum(attended)) + len(attended)) * kv_token_bytes(model))
    return roofline_s(decode_flops(model, attended), nbytes)


def prefill_step_s(model: dict, lengths: Iterable[int]) -> float:
    """Least time of one prefill call: every weight read once and each
    valid token's k/v written, against prefill_flops."""
    lengths = list(lengths)
    nbytes = (param_count(model) * BF16
              + float(sum(lengths)) * kv_token_bytes(model))
    return roofline_s(prefill_flops(model, lengths), nbytes)
