"""Expert-parallel MoE dispatch over a ``DeviceMesh`` —
``src/repro/distributed/moe_ep.py``, whose ``shard_map`` becomes SPMD
code that every rank of the mesh runs on its own shard:

  * tokens are split over the data axes and replicated over "model"
    (the activations' layout), so each rank selects the tokens routed to
    its own experts with no communication;
  * each rank runs its E/tp experts (E padded up to a multiple of tp with
    zero experts the router never picks) on its data shard's tokens;
  * the one collective of the forward is an all-reduce over "model" of
    the partial per-token outputs (a token's k experts live on at most k
    model ranks); the aux loss is averaged over the data axes.

Capacity is per (data shard x expert): ``moe.route`` over the shard's
tokens, whose capacity reads ``moe.CAPACITY_FACTOR`` at call time, so
retuning it (as the no-drop tests do) moves both paths alike. Every rank
routes all E experts (the router is replicated) and keeps the slots of
its own; a slot's position in its expert's queue is the same whether
counted over all experts or over one rank's.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import data_axes, model_axis
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import mlp_apply


class _AllReduce(torch.autograd.Function):
    """Forward: the sum over `groups` in turn (with `mean`, divided by
    their sizes' product). Backward: the cotangent as it is. The result
    is replicated over the groups, so each rank's cotangent already is
    the whole one for its own input: its partial outputs (a sum over
    "model") or its shard's statistic (a mean over the data axes, whose
    rank gradients the data-parallel average then averages)."""

    @staticmethod
    def forward(ctx, x, groups, mean):
        x = x.clone()
        n = 1
        for g in groups:
            dist.all_reduce(x, group=g)
            n *= dist.get_world_size(g)
        return x / n if mean else x

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _FromReplicated(torch.autograd.Function):
    """Forward: identity, where replicated values enter a rank's share of
    the experts. Backward: all-reduce (sum) over the model group, so the
    replicated computation upstream gets the cotangent of every rank's
    experts, the same on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _local_experts(w: torch.Tensor, e0: int, e_local: int) -> torch.Tensor:
    """Rows [e0, e0 + e_local) of an (E, ...) expert stack, zero rows past
    E (the pad experts)."""
    own = w[e0:min(e0 + e_local, w.shape[0])]
    pad = e_local - own.shape[0]
    if pad:
        own = torch.cat([own, own.new_zeros((pad, *w.shape[1:]))])
    return own


def moe_apply_ep(p, x: torch.Tensor, cfg: ModelConfig, mesh,
                 valid=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`moe.moe_apply` expert-parallel on `mesh`, run on every rank.

    p: the layer's full moe params (router, experts (E, ...), shared),
    the same on every rank; x (B, S, d): this rank's data shard of the
    tokens, the same on every model rank of the shard; valid: its (B, S)
    mask or None. Returns (y (B, S, d), aux): y this shard's output, the
    same on every model rank; aux the load-balance loss averaged over the
    data shards, the same on every rank.

    Gradients (torch autograd; the collectives have backwards of their
    own): let each rank's loss be computed from its outputs, the same on
    the model ranks of a data shard, and let the global loss be the mean
    of the data shards' losses. Then each rank's gradient of a replicated
    leaf (router, shared experts, everything upstream of x) is the same
    on every model rank of its shard, and its gradient of the expert
    stacks is nonzero only on its own experts' rows; averaging each
    leaf's gradient over the data axes (as data parallelism does) gives
    the global loss's gradient of every replicated leaf and of the
    rank's own experts. Backward runs one all-reduce over "model" for
    each of the experts' inputs and routing weights.

    ``DTensor`` inputs (the multi-pod dry run's, placed by the sharding
    rules) are brought to that layout first: x and valid split over the
    data axes and whole over "model", the router and shared experts
    gathered, the expert stacks split over "model" by E (their rows
    [e0, e0 + E/tp), padded with zero experts, as here); y and aux come
    back as DTensors laid out like x and replicated."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return _moe_apply_ep_dtensor(p, x, cfg, mesh, valid)
    return _moe_apply_ep(p, x, cfg, mesh, valid)


def _moe_apply_ep(p, x, cfg, mesh, valid=None, experts=None):
    """`moe_apply_ep` on local tensors; `experts`: this rank's expert
    stacks already cut (None: cut from p's full ones)."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    names = list(mesh.mesh_dim_names)
    tp = mesh.size(names.index(model_axis(mesh)))
    model_group = mesh.get_group(model_axis(mesh))
    e_local = -(-E // tp)                   # (E + pad) / tp
    e0 = mesh.get_local_rank(model_axis(mesh)) * e_local

    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    plan = moe_lib.route(p["router"], xt, cfg, valid)
    cap, slot_pos = plan["cap"], plan["slot_pos"]
    flat_e = plan["top_e"].reshape(t * k)

    # aux: the same on every model rank (inputs replicated); mean over
    # the data shards
    me = plan["probs"].mean(dim=0)
    ce = plan["by_expert"].view(E, t, k).sum(dim=2).float().mean(dim=1) / k
    aux = E * torch.sum(me * ce) * m.router_aux_loss_coef
    aux = _AllReduce.apply(
        aux, [mesh.get_group(a) for a in data_axes(mesh)], True)

    # ---- this rank's slots: kept, and routed to one of its experts ------
    local_e = flat_e - e0
    keep = plan["keep"] & (flat_e < E) & (local_e >= 0) & (local_e < e_local)
    xe = _FromReplicated.apply(xt, model_group)
    w = _FromReplicated.apply(plan["top_w"], model_group).reshape(t * k)

    # buffer (e_local + 1, cap + 1, d): every kept slot lands on its own
    # (expert, position); the rest on the waste expert e_local
    token_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    dest = torch.where(keep, local_e * (cap + 1) + slot_pos,
                       e_local * (cap + 1)).long()
    buf = torch.zeros(((e_local + 1) * (cap + 1), d), dtype=x.dtype,
                      device=x.device)
    buf[dest] = xe[token_idx]
    buf = buf.view(e_local + 1, cap + 1, d)[:e_local, :cap]

    ex = experts or {n: _local_experts(p["experts"][n], e0, e_local)
                     for n in ("gate", "up", "down")}
    h = F.silu(torch.bmm(buf, ex["gate"])) * torch.bmm(buf, ex["up"])
    out = torch.bmm(h, ex["down"])                          # (E_loc, C, d)

    # ---- combine, per token in slot order (moe.moe_apply's order) -------
    gathered = out[torch.clamp(local_e, 0, e_local - 1),
                   torch.clamp(slot_pos, max=cap - 1)]
    gathered = (gathered * (w * keep)[:, None]).to(x.dtype).view(t, k, d)
    y = gathered[:, 0]
    for j in range(1, k):
        y = y + gathered[:, j]
    # the forward's one collective over "model": the partials' sum
    y = _AllReduce.apply(y, [model_group], False)

    if "shared" in p:
        y = y + mlp_apply(p["shared"], xt)
    return y.reshape(b, s, d), aux


def _moe_apply_ep_dtensor(p, x, cfg, mesh, valid):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    names = list(mesh.mesh_dim_names)
    # the rows over the data axes, dropping the outer ones where their
    # product does not divide the batch (the sharding rules' fall-back)
    split = [names.index(a) for a in data_axes(mesh)]
    while split and x.shape[0] % math.prod(mesh.size(i) for i in split):
        split = split[1:]
    row = [Shard(0) if i in split else Replicate()
           for i in range(len(names))]
    whole = [Replicate()] * len(names)

    def local(t, placements):
        if not isinstance(t, DTensor):      # a plain tensor is replicated
            t = DTensor.from_local(t, mesh, whole, run_check=False)
        return t.redistribute(mesh, placements).to_local()

    xl = local(x, row)
    vl = None if valid is None else local(valid, row)
    pl = {"router": local(p["router"], whole)}
    if "shared" in p:
        pl["shared"] = {k: local(v, whole) for k, v in p["shared"].items()}
    by_e = [Shard(0) if n == model_axis(mesh) else Replicate()
            for n in names]
    tp = mesh.size(names.index(model_axis(mesh)))
    e_local = -(-cfg.moe.num_experts // tp)
    experts = {}
    for n in ("gate", "up", "down"):
        w = local(p["experts"][n], by_e)      # torch.chunk's split of E
        if w.shape[0] < e_local:
            w = torch.cat([w, w.new_zeros((e_local - w.shape[0],
                                           *w.shape[1:]))])
        experts[n] = w
    y, aux = _moe_apply_ep(pl, xl, cfg, mesh, vl, experts)
    return (DTensor.from_local(y, mesh, row, run_check=False),
            DTensor.from_local(aux, mesh, whole, run_check=False))
