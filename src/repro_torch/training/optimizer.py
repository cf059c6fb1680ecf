"""AdamW, its learning-rate schedule and gradient clipping, with the
numerics of ``src/repro/training/optimizer.py``: f32 moments, the clip
scale min(1, clip / (gnorm + 1e-9)), bias correction in f32, decoupled
weight decay on every leaf with ``ndim >= 2`` of the stacked tree (so a
stacked norm scale (L, d) is decayed, as in the reference), the update
cast back to the parameter's dtype.

The reference returns new arrays; here the update runs in place under
``torch.no_grad()`` (params, moments and step), which saves a copy of
every parameter and moment at full width.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor    # () int32
    mu: object            # first moments, the params' tree in f32
    nu: object            # second moments


def leaves(tree):
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to min_lr_ratio (f32)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = next(leaves(params)).device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    map_tree(zeros, params), map_tree(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 squares."""
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(g.float())) for g in leaves(tree)]).sum())


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads, state: OptState):
    """One AdamW step, in place on `params` and `state`'s tensors.
    Returns (params, state, {"grad_norm", "lr"}) like the reference."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    state.step.add_(1)
    b1, b2 = cfg.betas
    stepf = state.step.float()
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    lr = lr_schedule(cfg, stepf)
    # the reference's expressions, evaluated in the same order, but in
    # place where a temporary would die at once: at most two temporaries of
    # a leaf's size are alive (a stacked full-width leaf is several GB)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                          leaves(state.nu)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_(((1 - b2) * g).mul_(g))
        del g
        denom = (v / bc2).sqrt_().add_(cfg.eps)
        delta = (m / bc1).div_(denom)
        del denom
        if p.ndim >= 2:     # decoupled weight decay on matrices only
            delta.add_(cfg.weight_decay * p.float())
        p.copy_((p.float() - delta.mul_(lr)).to(p.dtype))
    return params, state, {"grad_norm": gnorm, "lr": lr}
