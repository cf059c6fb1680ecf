"""Plain PyTorch versions of the attention and scan kernels (Mamba-1's
selective scan and Mamba-2's state-space-dual recurrence).

The semantic ground truth, line for line with ``src/repro/kernels/ref.py``:
the CPU path of every dispatch in ``kernels/ops.py`` and the yardstick the
CUDA kernels are held against on the card. ``attention_lse_ref`` and
``attention_bwd_ref`` are the plain versions of the flash kernel's `lse`
output and of the backward kernels, and ``selective_scan_bwd_ref`` that of
the scan's backward kernel; the CPU path differentiates ``attention_ref``
and the scans with torch autograd instead, as the reference does with
XLA's. Fully masked rows follow this
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


def _mask(b, sq, sk, dev, *, causal, window, lengths):
    """(B, 1, Sq, Sk) visibility of key j from query i (positions are the
    indices): attention_ref's mask without a query offset."""
    kv_pos = torch.arange(sk, device=dev)[None, None, None, :]
    q_pos = torch.arange(sq, device=dev)[None, None, :, None]
    mask = torch.ones((b, 1, sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= kv_pos <= q_pos
    if lengths is not None:
        mask &= kv_pos < lengths.to(dev)[:, None, None, None]
    if window is not None:
        mask &= kv_pos > q_pos - window
    return mask


def attention_lse_ref(q, k, v, *, causal=True, window=None, lengths=None,
                      sm_scale=None) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled, masked scores -> (B, H, Sq)
    f32, -inf for a row with nothing to attend: the plain version of the
    flash kernel's `lse` output."""
    b, sq, h, hd = q.shape
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     _repeat_kv(k, h).float()) * scale
    mask = _mask(b, sq, k.shape[1], q.device, causal=causal, window=window,
                 lengths=lengths)
    return torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)


def attention_bwd_ref(q, k, v, out, lse, dout, *, causal=True, window=None,
                      lengths=None, sm_scale=None):
    """Gradients of attention from its output and `lse`, the explicit
    formulas in f32: P = exp(scale Q K^T - lse) (0 where masked and on rows
    with lse = -inf), dP = dO V^T, Delta = rowsum(dO o O), dS = P o (dP -
    Delta); dV = P^T dO and dK = scale dS^T Q summed over each KV head's
    query heads, dQ = scale dS K. Returns (dq, dk, dv) in the inputs'
    dtype: the plain version of the backward kernels
    (csrc/flash_attention_bwd.cu)."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    qf, of, dof = q.float(), out.float(), dout.float()
    kf, vf = _repeat_kv(k, h).float(), _repeat_kv(v, h).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    mask = _mask(b, sq, sk, q.device, causal=causal, window=window,
                 lengths=lengths) & torch.isfinite(lse)[..., None]
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = torch.einsum("bqhd,bqhd->bhq", dof, of)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(b, sk, kvh, g, hd).sum(3)
    dv = dv.reshape(b, sk, kvh, g, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def selective_scan_with_state_ref(
    x: torch.Tensor,     # (B, S, D)   D = d_inner
    dt: torch.Tensor,    # (B, S, D)   softplus'd timestep
    A: torch.Tensor,     # (D, N), or (D,) per channel; negative
    B: torch.Tensor,     # (B, S, N)
    C: torch.Tensor,     # (B, S, N)
    D: torch.Tensor,     # (D,)
):
    """Mamba-1 selective scan, sequential, with the final state.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t;  y_t = C_t . h_t + D*x_t
    The arithmetic of the reference's ``ssm._scan_with_state``: f32 state
    from zero, y cast to x's dtype, h_last (B, D, N) kept f32. A (D,), one
    scalar per channel (``ops.ssd_channel_args``), is A (D, N) expanded
    over the states, as the kernel's wrapper takes it."""
    bsz, s, d = x.shape
    n = B.shape[-1]
    A = A.float()
    if A.dim() == 1:
        A = A[:, None].expand(d, n)
    h = torch.zeros((bsz, d, n), dtype=torch.float32, device=x.device)
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=x.device)
    for t in range(s):
        dA = torch.exp(dtf[:, t, :, None] * A[None])
        h = dA * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        y[:, t] = torch.einsum("bdn,bn->bd", h, Cf[:, t])
    y = y + xf * D.float()[None, None]
    return y.to(x.dtype), h


def selective_scan_ref(x, dt, A, B, C, D) -> torch.Tensor:
    """Mamba-1 selective scan, sequential oracle. Returns y (B, S, D) in
    x's dtype (the reference's ``selective_scan_ref``)."""
    return selective_scan_with_state_ref(x, dt, A, B, C, D)[0]


def selective_scan_bwd_ref(x, dt, A, B, C, D, dy):
    """Gradients of the selective scan, the reverse recurrence written
    out in f32 (not autograd): with a_t = exp(dt_t A) and u_t = dt_t x_t
    per (b, d, n), the adjoint g_t = C_t dy_t + a_{t+1} g_{t+1} gives
    dx_t = dt_t sum_n g_t B_t + D dy_t, ddt_t = sum_n g_t (A a_t h_{t-1}
    + x_t B_t), dB_t = sum_d g_t u_t, dC_t = sum_d dy_t h_t,
    dA = sum_{b,t} g_t dt_t a_t h_{t-1} and dD = sum_{b,t} dy_t x_t.
    Returns (dx, ddt, dA, dB, dC, dD): dx, ddt, dB and dC in their inputs'
    dtypes, dA and dD f32 — the plain version of the backward kernel
    (csrc/selective_scan_bwd.cu).

    A (D, N) is the Mamba-1 body's form. A (D,), one scalar per channel,
    is the Mamba-2 body's (``ops.ssd_channel_args``): the decay a_t is
    then one value per (b, t, d), A folds out of the sums over n,
    ddt_t = A a_t sum_n g_t h_{t-1} + x_t sum_n g_t B_t and
    dA = sum_{b,t} dt_t a_t sum_n g_t h_{t-1}, and dA is (D,)."""
    bsz, s, d = x.shape
    n = B.shape[-1]
    A = A.float()
    per_channel = A.dim() == 1
    a_bc = A[:, None] if per_channel else A    # (D, 1) or (D, N)
    xf, dtf, Bf, Cf, dyf = (t.float() for t in (x, dt, B, C, dy))
    hs = [torch.zeros((bsz, d, n), dtype=torch.float32, device=x.device)]
    for t in range(s):                       # h_t, from the zero state
        hs.append(torch.exp(dtf[:, t, :, None] * a_bc[None]) * hs[-1]
                  + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :])
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(A)
    carry = torch.zeros_like(hs[0])          # a_{t+1} g_{t+1}
    for t in reversed(range(s)):
        a = torch.exp(dtf[:, t, :, None] * a_bc[None])
        g = Cf[:, t, None, :] * dyf[:, t, :, None] + carry
        s1 = (g * Bf[:, t, None, :]).sum(-1)
        dx[:, t] = dtf[:, t] * s1 + D.float() * dyf[:, t]
        if per_channel:                      # a_t sum_n g_t h_{t-1}
            r = a[..., 0] * (g * hs[t]).sum(-1)
            ddt[:, t] = A * r + xf[:, t] * s1
            dA += (r * dtf[:, t]).sum(0)
        else:
            q = g * a * hs[t]
            ddt[:, t] = (q * A[None]).sum(-1) + xf[:, t] * s1
            dA += (q * dtf[:, t, :, None]).sum(0)
        dB[:, t] = (g * (dtf[:, t] * xf[:, t])[..., None]).sum(1)
        dC[:, t] = (dyf[:, t, :, None] * hs[t + 1]).sum(1)
        carry = a * g
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA, dB.to(B.dtype),
            dC.to(C.dtype), (dyf * xf).sum((0, 1)))


def selective_scan_step_ref(
    h: torch.Tensor,     # (B, D, N) carried state
    x: torch.Tensor,     # (B, D)
    dt: torch.Tensor,    # (B, D)
    A: torch.Tensor,     # (D, N)
    B: torch.Tensor,     # (B, N)
    C: torch.Tensor,     # (B, N)
    D: torch.Tensor,     # (D,)
):
    """One decode step of the Mamba-1 recurrence. Returns (h', y)."""
    dA = torch.exp(dt[..., None] * A[None])
    h = dA * h + dt[..., None] * B[:, None, :] * x[..., None]
    y = torch.einsum("bdn,bn->bd", h, C) + x * D[None]
    return h, y


def ssd_with_state_ref(
    x: torch.Tensor,     # (B, S, NH, HD)
    dt: torch.Tensor,    # (B, S, NH)  softplus'd
    A: torch.Tensor,     # (NH,)       negative scalar per head
    B: torch.Tensor,     # (B, S, N)
    C: torch.Tensor,     # (B, S, N)
    D: torch.Tensor,     # (NH,)
):
    """Mamba-2 state-space-dual recurrence, sequential, with the final
    state.

    Per head: h_t = exp(dt_t * A) h_{t-1} + dt_t * x_t B_t^T,
    y_t = h_t C_t + D x_t. The arithmetic of the reference's
    ``ssm._ssd_with_state``: f32 state from zero, y cast to x's dtype,
    h_last (B, NH, HD, N) kept f32."""
    bsz, s, nh, hd = x.shape
    n = B.shape[-1]
    A = A.float()
    h = torch.zeros((bsz, nh, hd, n), dtype=torch.float32, device=x.device)
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    y = torch.empty((bsz, s, nh, hd), dtype=torch.float32, device=x.device)
    for t in range(s):
        da = torch.exp(dtf[:, t] * A[None])                     # (B, NH)
        dbx = (dtf[:, t, :, None, None] * xf[:, t, ..., None]
               * Bf[:, t, None, None, :])
        h = da[..., None, None] * h + dbx
        y[:, t] = torch.einsum("bhdn,bn->bhd", h, Cf[:, t])
    y = y + xf * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def ssd_ref(x, dt, A, B, C, D) -> torch.Tensor:
    """Mamba-2 recurrence, sequential oracle. Returns y (B, S, NH, HD) in
    x's dtype (the reference's ``ssd_ref``)."""
    return ssd_with_state_ref(x, dt, A, B, C, D)[0]


def ssd_step_ref(h, x, dt, A, B, C, D):
    """One decode step of the Mamba-2 recurrence.

    h (B,NH,HD,N), x (B,NH,HD), dt (B,NH), A (NH,), B/C (B,N), D (NH,).
    Returns (h', y) with y (B,NH,HD)."""
    da = torch.exp(dt * A[None])
    h = (da[..., None, None] * h
         + dt[..., None, None] * x[..., None] * B[:, None, None, :])
    y = torch.einsum("bhdn,bn->bhd", h, C) + x * D[None, :, None]
    return h, y
