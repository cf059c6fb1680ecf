"""Train-step builder: loss, gradients and the AdamW update, with
per-layer rematerialisation — ``src/repro/training/train.py``.

The reference jits ``value_and_grad`` of ``Model.loss``; here torch
autograd differentiates the same loss eagerly: on the CPU through the
plain attention and scan, on CUDA through the flash kernel's
``FlashAttention`` and the selective scan's ``SelectiveScan``
(hand-written backward kernels, ``kernels/ops.py``), so every kind
trains on the card. Decode has no backward and raises in grad mode.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model import Model
from repro_torch.training.optimizer import (OptimizerConfig, adamw_update,
                                            init_opt_state, leaves, map_tree)


def _like(template, flat):
    """A tree shaped like `template` with the leaves of `flat` in order."""
    it = iter(flat)
    return map_tree(lambda _: next(it), template)


def value_and_grad(model: Model, params, batch):
    """(loss, grads) of ``model.loss`` at `params`, grads a tree shaped
    like `params` (zeros for a leaf the loss does not use, as JAX gives).
    Differentiates detached views of the params, so the caller's tensors
    never require grad."""
    with torch.enable_grad():
        live = map_tree(lambda p: p.detach().requires_grad_(), params)
        flat = list(leaves(live))
        loss = model.loss(live, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), _like(params, [
        torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)])


def build_train_step(model: Model, opt_cfg: OptimizerConfig, *,
                     remat: bool = True, microbatches: int = 1) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) with metrics {"loss", "grad_norm", "lr"}; params and
    opt_state are updated in place. `batch` is a dict of tensors on the
    model's device (tokens, labels, and frames or patch_embeds where the
    kind takes them). With remat each layer is checkpointed (the
    reference sets ``model.remat`` the same way). With microbatches > 1
    the batch splits along its first axis and f32 gradients accumulate
    over the microbatches, then divide, as the reference's scan does;
    only one microbatch's activations are live at a time."""
    if remat:
        model.remat = True

    def train_step(params, opt_state, batch):
        if microbatches <= 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            micro = {k: v.reshape(microbatches, -1, *v.shape[1:])
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(leaves(params)).device)
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves(params)]
            for i in range(microbatches):
                l_i, g_i = value_and_grad(
                    model, params, {k: v[i] for k, v in micro.items()})
                loss = loss + l_i
                for a, g in zip(acc, leaves(g_i)):
                    a.add_(g.float())
            loss = loss / microbatches
            grads = _like(params, [a / microbatches for a in acc])
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def init_train_state(model: Model, generator: torch.Generator,
                     dtype=torch.float32):
    params = model.init(generator, dtype)
    return params, init_opt_state(params)
