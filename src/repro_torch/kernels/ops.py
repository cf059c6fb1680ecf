"""Dispatch of the kernel entry points by the tensors' device.

A CUDA tensor launches the hand-written kernel (``kernels/cuda.py``); a
CPU tensor takes the plain version (``kernels/ref.py``). There is no
fallback: a CUDA call the kernel cannot take raises. Unlike the
reference's dispatch (``src/repro/kernels/ops.py:48``), attention with
``lengths`` or ``q_offset`` launches the prefill kernel too, so the
serving path's bucketed and chunked prefill run on it. Likewise the
scan kernel also returns the final state, so the serving prefill
(``selective_scan_with_state``) runs on it and not only the full-sequence
forward.

Attention and the scan train on the card: in grad mode on CUDA, with an
input that requires grad, attention runs through ``FlashAttention`` and
the scan (Mamba-1's and Mamba-2's alike) through ``SelectiveScan``, each
a forward kernel that saves what its hand-written backward kernel needs.
On the CPU torch autograd differentiates the plain versions, as the
reference trains through XLA's autodiff of its ``attention_ref``,
``selective_scan_ref`` and ``ssd_ref``. There is no fallback in grad mode
either: the card never differentiates a plain version. The serving
prefill's entry points (``selective_scan_with_state``,
``ssd_with_state``) and decode stay forward-only; their CUDA kernels
refuse, in grad mode, inputs that require grad
(``kernels/cuda.py:_no_grad``) rather than drop their gradients.

Mamba-2's recurrence (``ssd``) runs on the same scan kernel: it is the
selective scan with each head's dt, A and D broadcast over the head's
channels, A as one scalar per channel (``ssd_channel_args``). In
training its backward runs the backward kernel's Mamba-2 body, which
takes one decay per (b, t, channel) where the Mamba-1 body takes one per
state. The reference's chunked SSD
(``src/repro/kernels/ops.py:_ssd_chunked``) is its TPU kernelisation in
XLA, not a Pallas kernel, and like Mamba-1's ``"chunked"`` scan it has no
counterpart here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda as _cuda
from repro_torch.kernels import ref as _ref


def _trains(*tensors) -> bool:
    """Grad mode is on and an input requires grad: the call must record
    its backward."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class FlashAttention(torch.autograd.Function):
    """The flash kernel with its hand-written backward: the forward also
    writes each row's log-sum-exp and saves q, k, v, out and lse; the
    backward launches ``flash_attention_bwd`` (dQ, then dK/dV). Under
    ``torch.utils.checkpoint`` the recomputed forward launches the kernel
    again and saves afresh."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, lengths, sm_scale):
        out, lse = _cuda.flash_attention(
            q, k, v, causal=causal, window=window, lengths=lengths,
            sm_scale=sm_scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, lengths=lengths,
                        sm_scale=sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _cuda.flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None


class SelectiveScan(torch.autograd.Function):
    """The scan kernel with its hand-written backward: the forward also
    writes h after each of its T-step chunks and saves them with the
    inputs and its launch plan; the backward launches
    ``selective_scan_bwd`` with that plan, which recomputes h inside each
    chunk from those states. A is (D, N) (Mamba-1: the backward's Mamba-1
    body) or (D,), one scalar per channel (Mamba-2, ``ssd_channel_args``:
    the forward's wrapper expands it to (D, N) for its kernel, the
    backward's Mamba-2 body reads it as it is). A and D come back in their
    own shapes, so
    autograd sums Mamba-2's per-channel dA and dD over each head. Under
    ``torch.utils.checkpoint`` the recomputed forward launches the scan
    again and saves afresh."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D):
        y, states, plan = _cuda.selective_scan(x, dt, A, B, C, D,
                                               save_states=True)
        ctx.save_for_backward(x, dt, A, B, C, D, states)
        ctx.plan = plan
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, B, C, D, states = ctx.saved_tensors
        dx, ddt, dA, dB, dC, dD = _cuda.selective_scan_bwd(
            x, dt, A, B, C, D, states, dy.contiguous(), ctx.plan)
        return dx, ddt, dA.to(A.dtype), dB, dC, dD.to(D.dtype)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              lengths=None, q_offset=None, sm_scale: Optional[float] = None):
    """Prefill/train attention. q (B,Sq,H,hd), k/v (B,Sk,KV,hd). On CUDA
    in grad mode with an input that requires grad it runs through
    ``FlashAttention`` (forward and backward kernels); otherwise the
    forward kernel alone, as serving does."""
    if q.is_cuda:
        if _trains(q, k, v):
            if q_offset is not None:
                raise ValueError("attention: q_offset has no use in "
                                 "training and the backward kernels do not "
                                 "take it")
            return FlashAttention.apply(q, k, v, causal, window, lengths,
                                        sm_scale)
        return _cuda.flash_attention(
            q, k, v, causal=causal, window=window, lengths=lengths,
            q_offset=q_offset, sm_scale=sm_scale)
    return _ref.attention_ref(
        q, k, v, causal=causal, window=window, lengths=lengths,
        q_offset=q_offset, sm_scale=sm_scale)


def decode_attention(q, k, v, lengths, *, window: Optional[int] = None,
                     sm_scale: Optional[float] = None):
    """Single-token decode attention. q (B,H,hd), k/v (B,S,KV,hd)."""
    if q.is_cuda:
        return _cuda.decode_attention(q, k, v, lengths, window=window,
                                      sm_scale=sm_scale)
    return _ref.decode_attention_ref(q, k, v, lengths, window=window,
                                     sm_scale=sm_scale)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           window: Optional[int] = None,
                           sm_scale: Optional[float] = None):
    """Single-token decode attention over a physical KV page pool.
    q (B,H,hd); pools (P,page,KV,hd); block_tables (B,max_pages) int32
    (entries >= P are sentinels)."""
    if q.is_cuda:
        return _cuda.paged_decode_attention(
            q, k_pool, v_pool, block_tables, lengths, window=window,
            sm_scale=sm_scale)
    return _ref.paged_decode_attention_ref(
        q, k_pool, v_pool, block_tables, lengths, window=window,
        sm_scale=sm_scale)


def _scan(x, dt, A, B, C, D):
    """The scan kernel on CUDA tensors: through ``SelectiveScan`` when the
    call trains, else the forward alone, as serving does."""
    if _trains(x, dt, A, B, C, D):
        return SelectiveScan.apply(x, dt, A, B, C, D)
    return _cuda.selective_scan(x, dt, A, B, C, D)


def selective_scan(x, dt, A, B, C, D):
    """Mamba-1 selective scan. x, dt (B,S,D); A (D,N); B, C (B,S,N);
    D (D,) -> y (B,S,D) in x's dtype. On CUDA in grad mode with an input
    that requires grad it runs through ``SelectiveScan`` (forward and
    backward kernels)."""
    if x.is_cuda:
        return _scan(x, dt, A, B, C, D)
    return _ref.selective_scan_ref(x, dt, A, B, C, D)


def selective_scan_with_state(x, dt, A, B, C, D):
    """The scan and its final state: -> (y (B,S,D), h_last (B,D,N) f32)."""
    if x.is_cuda:
        return _cuda.selective_scan(x, dt, A, B, C, D, return_state=True)
    return _ref.selective_scan_with_state_ref(x, dt, A, B, C, D)


def selective_scan_step(h, x, dt, A, B, C, D):
    """One decode step of the recurrence, plain torch on every device (as
    the reference: a handful of elementwise ops, no kernel)."""
    return _ref.selective_scan_step_ref(h, x, dt, A, B, C, D)


def ssd_channel_args(x, dt, A, B, C, D):
    """Mamba-2's arguments per channel, channel c = head * HD + p: x
    (B,S,NH,HD) -> contiguous (B,S,NH*HD); dt (B,S,NH) -> each head's dt
    repeated over its HD channels, contiguous, in x's dtype; A (NH,) ->
    (NH*HD,) and D (NH,) -> (NH*HD,), f32; B and C as they are (column
    slices of the conv output, unit last stride). The scan's h_last
    (B, NH*HD, N) is then (B, NH, HD, N) as a view."""
    b, s, nh, hd = x.shape
    xs = x.reshape(b, s, nh * hd).contiguous()
    dts = dt.to(x.dtype).repeat_interleave(hd, dim=-1)
    return (xs, dts, A.float().repeat_interleave(hd), B, C,
            D.float().repeat_interleave(hd))


def ssd(x, dt, A, B, C, D):
    """Mamba-2 recurrence. x (B,S,NH,HD); dt (B,S,NH); A (NH,); B, C
    (B,S,N); D (NH,) -> y (B,S,NH,HD) in x's dtype. Trains on CUDA
    through ``SelectiveScan`` on ``ssd_channel_args``: the backward
    kernel's Mamba-2 body gives the per-channel gradients, and autograd
    carries them back to each head's dt, A and D."""
    if x.is_cuda:
        return _scan(*ssd_channel_args(x, dt, A, B, C, D)).view(x.shape)
    return _ref.ssd_ref(x, dt, A, B, C, D)


def ssd_with_state(x, dt, A, B, C, D):
    """The recurrence and its final state: -> (y (B,S,NH,HD),
    h_last (B,NH,HD,N) f32)."""
    if x.is_cuda:
        y, h = _cuda.selective_scan(*ssd_channel_args(x, dt, A, B, C, D),
                                    return_state=True)
        b, _, nh, hd = x.shape
        return y.view(x.shape), h.view(b, nh, hd, -1)
    return _ref.ssd_with_state_ref(x, dt, A, B, C, D)


def ssd_step(h, x, dt, A, B, C, D):
    """One decode step of the Mamba-2 recurrence, plain torch on every
    device (as ``selective_scan_step``)."""
    return _ref.ssd_step_ref(h, x, dt, A, B, C, D)
