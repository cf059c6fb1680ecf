"""Shared neural-net building blocks (plain PyTorch functions)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layout import keep_layout, rows_like


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in f32 and cast back to x's dtype (laid out as x,
    ``keep_layout``)."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return keep_layout(((xf * torch.rsqrt(var + eps)) * scale.float())
                       .to(dt), x)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, half-split layout. x (..., S, H, hd), positions
    broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * freqs            # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU when the layer has a gate, else tanh-GeLU (jax.nn.gelu's
    default approximation)."""
    if "gate" in p:
        h = F.silu(x @ p["gate"]) * (x @ p["up"])
    else:
        h = F.gelu(x @ p["up"], approximate="tanh")
    return h @ p["down"]


def embed_apply(p, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table, laid out like the tokens
    (``layout.rows_like``)."""
    return rows_like(p["table"][tokens], tokens)


def unembed(params, h: torch.Tensor) -> torch.Tensor:
    """h (..., d) -> logits (..., V). Uses the tied table if no lm_head."""
    if "lm_head" in params:
        return h @ params["lm_head"]["kernel"]
    return h @ params["embed"]["table"].T
