"""Checkpoints as npz with path-encoded keys, the format of
``src/repro/training/checkpoint.py``: ``params|<path>`` for every
parameter, ``opt|.step``, ``opt|.mu|<path>`` and ``opt|.nu|<path>`` for
the optimizer state (a NamedTuple's fields appear as ``.name`` in the
reference's key paths), and ``__step__``; the path joins dict keys with
``|``. A file either package writes restores into the other's trees.
bf16 leaves are stored as f32 (numpy has no bf16; the widening is
exact) and cast back to the template's dtype on restore. Saving and
restoring go one leaf at a time, so host memory holds one leaf, not the
tree (a full-width f32 Granite-3-2B checkpoint with its moments is about
30 GB).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.training.optimizer import OptState

SEP = "|"


class _Leaf:
    """A tensor that becomes a host array only when ``np.savez`` writes
    it, so a full-width checkpoint holds one leaf at a time in host
    memory, not the whole tree."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __array__(self, dtype=None, copy=None):
        t = self.t.detach()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
        return arr if dtype is None else arr.astype(dtype)


def _flatten(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{SEP}{k}", out)
        return out
    out[prefix] = _Leaf(tree)
    return out


def _opt_tree(opt: OptState) -> dict:
    return {".step": opt.step, ".mu": opt.mu, ".nu": opt.nu}


def save_checkpoint(path: str, params, opt_state=None, step: int = 0) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = _flatten(params, "params", {})
    if opt_state is not None:
        _flatten(_opt_tree(opt_state), "opt", payload)
    payload["__step__"] = np.asarray(step)
    np.savez(path, **payload)


def restore_checkpoint(path: str, params_template, opt_template=None):
    """Restores into trees shaped like the templates (each leaf's shape,
    dtype and device). Returns (params, step) or, with an optimizer
    template, (params, opt_state, step)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    step = int(data["__step__"])

    def rebuild(template, key):
        if isinstance(template, dict):
            return {k: rebuild(v, f"{key}{SEP}{k}")
                    for k, v in template.items()}
        arr = data[key]
        assert arr.shape == tuple(template.shape), (key, arr.shape,
                                                    template.shape)
        return torch.from_numpy(arr).to(device=template.device,
                                        dtype=template.dtype)

    params = rebuild(params_template, "params")
    if opt_template is None:
        return params, step
    opt = OptState(**{f[1:]: rebuild(t, f"opt{SEP}{f}")
                      for f, t in _opt_tree(opt_template).items()})
    return params, opt, step
