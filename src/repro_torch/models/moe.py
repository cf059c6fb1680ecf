"""Mixture-of-Experts layer: shared experts + routed top-k experts.

The counterpart of ``src/repro/models/moe.py``, with the same arithmetic:
the router product in x's dtype, then f32; softmax, top-k and
renormalisation; capacity ``min(int(1.25 * t * k / E) + 1, t)``; each
routed slot's position in its expert's queue by a cumulative count, slots
at or over capacity dropped; expert products batched over E; the
weighted combine; the shared MLP. The reference has no Pallas kernel
here (XLA einsums and scatters), so neither has the port: the expert
products are ``torch.bmm``.

Where the reference leans on JAX's scatter rules, the port spells them
out:

* Padding tokens (``valid`` false) carry the off-range expert id E. JAX
  drops such a dispatch scatter and clamps such a combine gather; torch
  raises (on a card, a device-side assert). Here the dispatch buffer has
  a waste row for every expert and one waste expert, so off-range and
  dropped slots land there and are sliced off; the gather clamps E to
  E - 1, whose weight of 0 cancels it.
* The combine is a scatter-add with each token's index repeated top-k
  times; as an atomic ``index_add_`` on a card it would sum in no fixed
  order. Since the indices are ``repeat(arange(t), k)``, it is a sum over
  each token's k slots, taken here in slot order in x's dtype — the
  order XLA's scatter adds them in.
* ``torch.topk`` promises no order among equal values, where
  ``jax.lax.top_k`` keeps the lower index first. Routing ties are rare in
  f32 and the port adds no tie-breaking; a differential that meets one
  classifies it with ``serving.lossless.audit_flips``.

Like any capacity-routed MoE the result is weakly batch-dependent: which
slots drop depends on every token in the call. Decode is the exception
the serving engine relies on: it routes only the batch's live rows
(``valid``) under a capacity of one slot per live row (``cap``),
which no expert's queue can pass, since a token's top-k experts are
distinct; so no slot drops and each decoded token is routed as a call of
its own, as the plain reference (``qoebench/reference/model.py``) routes
it. Under the reference engine's setting every slot of the batch is
routed, empty ones included, at ``capacity(B)``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp_apply

CAPACITY_FACTOR = 1.25


class LiveRows(NamedTuple):
    """The rows of a decode batch that hold a request: `mask` (B,) bool on
    the device and `count`, their number, on the host. A moe decode step
    given them routes those rows only, at `count` slots per expert."""
    mask: torch.Tensor
    count: int


def capacity(t: int, cfg: ModelConfig) -> int:
    """Slots per expert for a call over t tokens."""
    m = cfg.moe
    return min(int(CAPACITY_FACTOR * t * m.top_k / m.num_experts) + 1, t)


def moe_apply_chunked(p, x, cfg: ModelConfig, valid=None,
                      seq_chunk: int = 2048):
    """`moe_apply` over sequence chunks (capacity per chunk), as the
    reference's scan: chunk = the largest halving of seq_chunk that
    divides S; the aux loss is the chunks' mean."""
    b, slen, d = x.shape
    chunk = min(seq_chunk, slen)
    while slen % chunk:
        chunk //= 2
    n = slen // chunk
    if n <= 1:
        return moe_apply(p, x, cfg, valid=valid)
    ys, auxs = [], []
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        y, aux = moe_apply(p, x[:, sl], cfg,
                           valid=None if valid is None else valid[:, sl])
        ys.append(y)
        auxs.append(aux)
    return torch.cat(ys, dim=1), torch.stack(auxs).mean()


def route(router, xt: torch.Tensor, cfg: ModelConfig, valid=None,
          cap=None):
    """Routing and capacity plan of t tokens xt (t, d): softmax over the
    router logits, top-k, renormalised weights, each slot's position in
    its expert's queue and whether it fits the capacity (`cap` slots per
    expert; ``capacity(t, cfg)`` by default). Returns a dict of
    probs (t, E) f32, top_w (t, k) f32, top_e (t, k) (E for padding),
    slot_pos (t*k,) (== cap where dropped), keep (t*k,) bool, cap and
    by_expert (E, t*k) bool (each slot's expert, one-hot by column)."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    t = xt.shape[0]
    logits = (xt @ router).float()                              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)                 # (T, k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    if valid is not None:
        vt = valid.reshape(t)
        top_w = top_w * vt[:, None]
        top_e = torch.where(vt[:, None], top_e, E)              # no expert
        probs = probs * vt[:, None]
    if cap is None:
        cap = capacity(t, cfg)
    flat_e = top_e.reshape(t * k)
    # position of each slot within its expert's queue (exact in integers;
    # an off-range slot has no expert and position 0, as in the reference)
    # (E, T*k): each expert's row of slots, so the running count is an
    # inner-dimension scan
    by_expert = torch.arange(E, device=xt.device)[:, None] == flat_e[None]
    counts = torch.cumsum(by_expert.to(torch.int32), dim=1,
                          dtype=torch.int32)
    e_clamped = torch.clamp(flat_e, max=E - 1)
    slot_pos = torch.where(
        flat_e < E, counts.gather(0, e_clamped[None])[0] - 1, 0)
    keep = slot_pos < cap
    slot_pos = torch.where(keep, slot_pos, cap)   # dropped -> waste row
    return dict(probs=probs, top_w=top_w, top_e=top_e, slot_pos=slot_pos,
                keep=keep, cap=cap, by_expert=by_expert)


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, valid=None,
              cap=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar f32).

    valid: optional (B, S) bool; padding tokens are routed to no expert,
    so they consume no capacity and add nothing to the aux loss.
    cap: slots per expert, in place of ``capacity(B * S, cfg)``."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    plan = route(p["router"], xt, cfg, valid, cap)
    cap, slot_pos, keep = plan["cap"], plan["slot_pos"], plan["keep"]
    flat_e = plan["top_e"].reshape(t * k)
    flat_w = plan["top_w"].reshape(t * k)

    # ---- load-balance auxiliary loss (Switch-style) ----------------------
    me = plan["probs"].mean(dim=0)
    ce = plan["by_expert"].view(E, t, k).sum(dim=2).float().mean(dim=1) / k
    aux = E * torch.sum(me * ce) * m.router_aux_loss_coef

    # ---- capacity-based dispatch ------------------------------------------
    # buffer (E + 1, cap + 1, d): row `cap` of each expert and expert E
    # take the dropped and off-range slots; every real (expert, position)
    # is written by exactly one slot
    token_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    dest = flat_e.long() * (cap + 1) + slot_pos.long()
    buf = xt.new_zeros(((E + 1) * (cap + 1), d))
    buf[dest] = xt[token_idx]
    buf = buf.view(E + 1, cap + 1, d)[:E, :cap]                 # (E, C, d)

    # ---- expert FFN, batched over experts ----------------------------------
    ex = p["experts"]
    h = F.silu(torch.bmm(buf, ex["gate"])) * torch.bmm(buf, ex["up"])
    out = torch.bmm(h, ex["down"])                              # (E, C, d)

    # ---- combine ------------------------------------------------------------
    e_clamped = torch.clamp(flat_e, max=E - 1)
    gathered = out[e_clamped, torch.clamp(slot_pos, max=cap - 1)]
    gathered = (gathered * (flat_w * keep)[:, None]).to(x.dtype)
    gathered = gathered.view(t, k, d)
    y = gathered[:, 0]
    for j in range(1, k):
        y = y + gathered[:, j]

    if "shared" in p:
        y = y + mlp_apply(p["shared"], xt)
    return y.reshape(b, s, d), aux
