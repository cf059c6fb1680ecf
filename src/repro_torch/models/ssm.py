"""Mamba-1 and Mamba-2 blocks: full-sequence forward, prefill with decode
state, and one decode step — ``src/repro/models/ssm.py``.

State carried per request (the SSM analogue of the KV cache, constant in
size), in the cache dtype for the conv buffer and f32 for the scan state:
Mamba-1 a conv buffer (d_conv-1, d_inner) and a state (d_inner, N);
Mamba-2 a conv buffer (d_conv-1, d_inner + 2N) over x, B and C, and a
state (NH, HD, N) per head.

The scans go through ``kernels.ops``: on CUDA tensors the hand-written
selective-scan kernel, which also writes the final state, so the serving
prefill runs on it (the reference's prefill reruns a sequential scan for
the state). ``B`` and ``C`` reach the kernel as column slices of the
x_proj output, strided views the kernel takes as they are; x and dt are
contiguous. Mamba-2's recurrence reaches the same kernel through
``ops.ssd`` / ``ops.ssd_with_state`` (per-head dt, A and D broadcast over
the head's channels).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm
from repro_torch.models.layout import split_dim


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as jax.nn.softplus computes it (F.softplus turns into
    the identity above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, prev=None):
    """x (B, S, C), w (K, C) depthwise causal conv; prev: optional
    (B, K-1, C) left context. Returns (y (B, S, C), new_prev (B, K-1, C))."""
    k = w.shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev, x], dim=1)                       # (B, S+K-1, C)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(k))
    new_prev = xp[:, -(k - 1):, :] if k > 1 else prev
    return y, new_prev


def _conv_step(x_tok: torch.Tensor, w: torch.Tensor, prev: torch.Tensor):
    """One-token conv. x_tok (B, C), prev (B, K-1, C)."""
    xp = torch.cat([prev, x_tok[:, None, :]], dim=1)       # (B, K, C)
    y = torch.einsum("bkc,kc->bc", xp, w)
    return y, xp[:, 1:, :]


def _mamba1_bcd(p, xc: torch.Tensor, cfg: ModelConfig):
    """Project the conv output to (dt, B, C); B and C are views."""
    n = cfg.ssm.d_state
    dt_rank = max(cfg.d_model // 16, 1)
    dbc = xc @ p["x_proj"]
    dt = softplus(dbc[..., :dt_rank] @ p["dt_proj"] + p["dt_bias"])
    return dt, dbc[..., dt_rank:dt_rank + n], dbc[..., dt_rank + n:]


def _mamba1_in(p, x: torch.Tensor, cfg: ModelConfig):
    """in_proj, causal conv and the (dt, B, C) projection of a sequence.
    Returns (x_in, z, xc, dt, B, C, A)."""
    x_in, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xc, _ = _causal_conv(x_in, p["conv_w"])
    xc = F.silu(xc + p["conv_b"])
    dt, B, C = _mamba1_bcd(p, xc, cfg)
    A = -torch.exp(p["A_log"].float())
    return x_in, z, xc, dt, B, C, A


def mamba1_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba-1 block. x (B, S, d) -> (B, S, d)."""
    _, z, xc, dt, B, C, A = _mamba1_in(p, x, cfg)
    y = ops.selective_scan(xc, dt, A, B, C, p["D"].float())
    return (y * F.silu(z)) @ p["out_proj"]


def mamba1_prefill(p, x: torch.Tensor, cfg: ModelConfig, lengths):
    """Like apply, but also returns the decode state at position
    lengths-1 of each right-padded row: dt is zeroed past `lengths`, so
    padding leaves the recurrence alone (exp(0*A) = 1, 0*B*x = 0), and the
    conv buffer holds each row's last K-1 valid inputs."""
    b, s, _ = x.shape
    x_in, z, xc, dt, B, C, A = _mamba1_in(p, x, cfg)
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
    else:
        pad = torch.arange(s, device=x.device)[None] >= lengths[:, None]
        dt = dt.masked_fill(pad[..., None], 0.0)
    conv_prev = _gather_last(x_in, lengths, p["conv_w"].shape[0] - 1)
    y, h_last = ops.selective_scan_with_state(xc, dt, A, B, C,
                                              p["D"].float())
    return (y * F.silu(z)) @ p["out_proj"], {"h": h_last, "conv": conv_prev}


def _gather_last(x: torch.Tensor, lengths, k: int) -> torch.Tensor:
    """Last k valid rows of x (B, S, C) given per-request lengths; rows
    before a short sequence's start are zeros."""
    b, s, c = x.shape
    idx = (lengths.to(x.device).long()[:, None] - k
           + torch.arange(k, device=x.device)[None])         # (B, k)
    g = torch.gather(x, 1, idx.clamp(0, s - 1)[..., None].expand(b, k, c))
    return g.masked_fill((idx < 0)[..., None], 0.0)


def mamba1_decode(p, x_tok: torch.Tensor, state, cfg: ModelConfig):
    """One-token decode. x_tok (B, d); state {"h": (B, di, N) f32,
    "conv": (B, K-1, di)}. Returns (out (B, d), new state)."""
    x_in, z = (x_tok @ p["in_proj"]).chunk(2, dim=-1)
    xc, conv = _conv_step(x_in, p["conv_w"], state["conv"])
    xc = F.silu(xc + p["conv_b"])
    dt, B, C = _mamba1_bcd(p, xc, cfg)
    A = -torch.exp(p["A_log"].float())
    h, y = ops.selective_scan_step(
        state["h"], xc.float(), dt.float(), A, B.float(), C.float(),
        p["D"].float())
    y = y.to(x_tok.dtype) * F.silu(z)
    return y @ p["out_proj"], {"h": h, "conv": conv}


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------

def _mamba2_split(p, x: torch.Tensor, cfg: ModelConfig):
    """in_proj -> (z, xbc, dt, nh): z (.., di), xbc (.., di + 2N) the conv's
    input (x, B, C), dt (.., nh) before softplus; views of one product."""
    s = cfg.ssm
    di = cfg.d_inner
    nh = di // s.headdim
    zxbcdt = x @ p["in_proj"]
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * s.d_state],
            zxbcdt[..., -nh:], nh)


def _mamba2_out(p, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig):
    """Gated norm and out_proj: rms_norm(y * silu(z)) @ out_proj."""
    return rms_norm(y * F.silu(z), p["norm_scale"], cfg.norm_eps) \
        @ p["out_proj"]


def mamba2_apply(p, x: torch.Tensor, cfg: ModelConfig, *, lengths=None,
                 return_state: bool = False):
    """Full-sequence Mamba-2 (SSD) block. x (B, S, d) -> (B, S, d), and
    with return_state the decode state at position lengths-1 of each
    right-padded row: dt is zeroed past `lengths` (padding leaves the
    recurrence alone) and the conv buffer holds each row's last K-1 valid
    conv inputs, gathered from xbc before the conv."""
    s = cfg.ssm
    di = cfg.d_inner
    b, slen, _ = x.shape
    z, xbc, dt, nh = _mamba2_split(p, x, cfg)
    conv_prev = None
    if return_state:
        eff = lengths if lengths is not None else torch.full(
            (b,), slen, dtype=torch.int32, device=x.device)
        conv_prev = _gather_last(xbc, eff, p["conv_w"].shape[0] - 1)
    xbc_c, _ = _causal_conv(xbc, p["conv_w"])
    xbc_c = F.silu(xbc_c + p["conv_b"])
    x_in = split_dim(xbc_c[..., :di], 2, (nh, s.headdim))
    B = xbc_c[..., di:di + s.d_state]
    C = xbc_c[..., di + s.d_state:]
    dt = softplus(dt + p["dt_bias"])
    if lengths is not None:
        pad = torch.arange(slen, device=x.device)[None] >= lengths[:, None]
        dt = dt.masked_fill(pad[..., None], 0.0)
    A = -torch.exp(p["A_log"].float())
    if return_state:
        y, h_last = ops.ssd_with_state(x_in, dt, A, B, C, p["D"].float())
    else:
        y = ops.ssd(x_in, dt, A, B, C, p["D"].float())
    out = _mamba2_out(p, y.reshape(b, slen, di), z, cfg)
    if return_state:
        return out, {"h": h_last, "conv": conv_prev}
    return out


def mamba2_prefill(p, x: torch.Tensor, cfg: ModelConfig, lengths):
    return mamba2_apply(p, x, cfg, lengths=lengths, return_state=True)


def mamba2_decode(p, x_tok: torch.Tensor, state, cfg: ModelConfig):
    """One-token decode. x_tok (B, d); state {"h": (B, NH, HD, N) f32,
    "conv": (B, K-1, di + 2N)}. Returns (out (B, d), new state)."""
    s = cfg.ssm
    di = cfg.d_inner
    b = x_tok.shape[0]
    z, xbc, dt, nh = _mamba2_split(p, x_tok, cfg)
    xbc_c, conv = _conv_step(xbc, p["conv_w"], state["conv"])
    xbc_c = F.silu(xbc_c + p["conv_b"])
    x_in = xbc_c[..., :di].reshape(b, nh, s.headdim)
    B = xbc_c[..., di:di + s.d_state]
    C = xbc_c[..., di + s.d_state:]
    dt = softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    h, y = ops.ssd_step(state["h"], x_in.float(), dt.float(), A, B.float(),
                        C.float(), p["D"].float())
    y = y.reshape(b, di).to(x_tok.dtype)
    return _mamba2_out(p, y, z, cfg), {"h": h, "conv": conv}
