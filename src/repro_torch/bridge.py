"""Weights between the reference and the port, and the port's own init.

The reference keeps params as a nested dict (pytree) of arrays with
per-layer leaves stacked on a leading layer axis and projections in
``x @ W`` orientation; the port keeps exactly that tree as a dict of
tensors, so a leaf's path and shape are the same on both sides.

- ``from_numpy``: the reference's tree with numpy leaves (``np.asarray``
  of each JAX array) -> the port's dict of tensors on `device`.
- ``to_numpy``: back (bf16 leaves widen to float32, numpy has no bf16).
- ``init_params``: fresh weights for the dense family, following the
  reference's init (``src/repro/models/transformer.py:39-121``): normal
  with std 0.02, the embedding with std 1.0, norm scales one, biases
  zero. A torch generator cannot reproduce ``jax.random``, so tests that
  compare the two frameworks bridge the reference's weights instead.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def from_numpy(tree, device="cuda", dtype=None):
    """Nested dict of numpy arrays -> nested dict of tensors."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_numpy(v, dev, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(dev)


def to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=torch.float32):
    """Random dense-decoder params in the reference's tree layout.

    Draws on the generator's device in f32 (one layer at a time, so the
    full-width 8B config never holds a whole f32 stack) and stores in
    `dtype` on `device`."""
    if cfg.kind != "dense":
        raise NotImplementedError(
            f"model kind {cfg.kind!r} is not ported yet (dense only)")
    dev = resolve_device(device)
    gdev = generator.device

    def normal(shape, std=0.02):
        x = torch.randn(shape, generator=generator, device=gdev,
                        dtype=torch.float32) * std
        return x.to(device=dev, dtype=dtype)

    def stacked(n, shape, std=0.02):
        out = torch.empty((n, *shape), dtype=dtype, device=dev)
        for i in range(n):
            out[i] = normal(shape, std)
        return out

    L, d = cfg.num_layers, cfg.d_model
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ones = lambda *s: torch.ones(s, dtype=dtype, device=dev)     # noqa: E731
    params = {
        "embed": {"table": normal((cfg.vocab_size, d), std=1.0)},
        "final_norm": {"scale": ones(d)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": normal((d, cfg.vocab_size))}
    attn = {
        "wq": stacked(L, (d, h * hd)),
        "wk": stacked(L, (d, kv * hd)),
        "wv": stacked(L, (d, kv * hd)),
        "wo": stacked(L, (h * hd, d)),
    }
    if cfg.qkv_bias:
        z = lambda n: torch.zeros((L, n), dtype=dtype, device=dev)  # noqa: E731
        attn.update(bq=z(h * hd), bk=z(kv * hd), bv=z(kv * hd))
    mlp = {"up": stacked(L, (d, cfg.d_ff)), "down": stacked(L, (cfg.d_ff, d))}
    if cfg.gated_mlp:
        mlp["gate"] = stacked(L, (d, cfg.d_ff))
    params["blocks"] = {
        "attn_norm_scale": ones(L, d),
        "attn": attn,
        "mlp_norm_scale": ones(L, d),
        "mlp": mlp,
    }
    return params
