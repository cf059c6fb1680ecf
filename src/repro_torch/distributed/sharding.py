"""Sharding rules: param / batch / cache trees -> per-dimension specs and
DTensor placements — ``src/repro/distributed/sharding.py``.

Scheme: 2-D logical parallelism over the mesh,
  * "model" — tensor parallel: attention heads / d_ff / d_inner / experts;
  * fsdp    — ("pod", "data"): the batch for activations, FSDP for
              weights (every weight matrix is also sharded on its
              non-tensor-parallel dim).

A leaf's spec is a tuple with one entry per leading tensor dim: None
(replicated), a mesh axis name, or a tuple of axis names in mesh order
(that dim split over their product) — the entries of the reference's
``PartitionSpec``, which, like it, may be shorter than the leaf's rank
(the rest replicated; ``()`` replicates the whole leaf). The rules are
name-based over the tree's paths ("|"-joined keys) and fall back to
replication where a dim does not divide by its axes' size. They read
only the mesh's axis names and sizes (``mesh_dim_names``, ``shape``), so
a ``launch.mesh.MeshShape`` serves as well as a ``DeviceMesh``.
``make_shardings`` turns specs into placements for
``torch.distributed.tensor.distribute_tensor`` on a real mesh.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _fit(mesh, dim: int, axis):
    """axis if it divides dim, else None (replicate)."""
    return axis if (axis is not None and dim % _axis_size(mesh, axis) == 0) \
        else None


def _fsdp(mesh):
    axes = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    return axes if len(axes) > 1 else axes[0]


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn("|".join(path), tree)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _rule_for(k: str):
    """(n_base_dims, builder(mesh, shape_tail) -> spec_tail) for the leaf
    at path k, or (0, None)."""
    def two(in_ax, out_ax):
        return 2, lambda mesh, s: (
            _fit(mesh, s[0], in_ax(mesh)), _fit(mesh, s[1], out_ax(mesh)))

    fsdp = _fsdp
    mdl = lambda mesh: "model"          # noqa: E731
    none = lambda mesh: None            # noqa: E731

    if k.endswith("embed|table"):
        return two(mdl, fsdp)            # (V, d): vocab on model, d FSDP
    if "lm_head" in k:
        return two(fsdp, mdl)            # (d, V)
    if any(t in k for t in ("|wq", "|wk", "|wv", "|up", "|gate", "|in_proj",
                            "vision_proj")):
        if "experts|" in k:              # (E, d, fe)
            return 3, lambda mesh, s: (
                _fit(mesh, s[0], "model"), _fit(mesh, s[1], _fsdp(mesh)), None)
        return two(fsdp, mdl)
    if any(t in k for t in ("|wo", "|down", "|out_proj")):
        if "experts|" in k:              # (E, fe, d)
            return 3, lambda mesh, s: (
                _fit(mesh, s[0], "model"), None, _fit(mesh, s[1], _fsdp(mesh)))
        return two(mdl, fsdp)
    if k.endswith("|router"):
        return two(fsdp, none)           # (d, E): E small, replicated
    if k.endswith("|x_proj"):
        return two(mdl, none)
    if k.endswith("|dt_proj"):
        return two(none, mdl)
    if k.endswith("|conv_w"):
        return 2, lambda mesh, s: (None, _fit(mesh, s[1], "model"))
    return 0, None


def param_specs(mesh, params_tree) -> Dict:
    """The spec tree of `params_tree` (tensors of any device, ``meta``
    included)."""
    def spec_one(key, leaf):
        shape = tuple(leaf.shape)
        nbase, builder = _rule_for(key)
        if builder is not None and len(shape) >= nbase:
            lead = (None,) * (len(shape) - nbase)
            return lead + tuple(builder(mesh, shape[len(shape) - nbase:]))
        # 1-D-ish leaves: shard big vectors on model, replicate small ones
        if shape and shape[-1] >= 1024:
            lead = (None,) * (len(shape) - 1)
            return lead + (_fit(mesh, shape[-1], "model"),)
        if key.endswith("|A_log") and len(shape) >= 2 and shape[-2] >= 1024:
            lead = (None,) * (len(shape) - 2)
            return lead + (_fit(mesh, shape[-2], "model"), None)
        return ()

    return _map_with_path(spec_one, params_tree)


# ---------------------------------------------------------------------------
# Batches and caches
# ---------------------------------------------------------------------------

def batch_specs(mesh, batch_tree, cfg: Optional[ModelConfig] = None) -> Dict:
    """Shard the leading batch dim of every batch leaf on the data axes
    (on "data" alone where pod x data does not divide it)."""
    dp = _fsdp(mesh)

    def spec_one(key, leaf):
        shape = tuple(leaf.shape)
        bdim = shape[0] if shape else 1
        first = _fit(mesh, bdim, dp)
        if first is None and isinstance(dp, tuple):
            first = _fit(mesh, bdim, "data")
        return (first,) + (None,) * (len(shape) - 1)

    return _map_with_path(spec_one, batch_tree)


def cache_specs(mesh, cache_tree, cfg: ModelConfig) -> Dict:
    """Decode-cache specs.

    KV (L, B, S, KV, hd): batch on the data axes; heads on "model" where
    they divide, else head_dim on "model", else replicated. Where the
    batch does not divide (long_500k has B=1), the sequence axis takes
    the data axes instead (cache sequence parallelism)."""
    dp = _fsdp(mesh)

    def kv_spec(shape):
        _, b, s, kv, hd = shape
        b_ax = _fit(mesh, b, dp)
        if b_ax is None and isinstance(dp, tuple):
            b_ax = _fit(mesh, b, "data")
        s_ax = _fit(mesh, s, dp) if b_ax is None else None
        head_ax = _fit(mesh, kv, "model")
        hd_ax = None if head_ax else _fit(mesh, hd, "model")
        return (None, b_ax, s_ax, head_ax, hd_ax)

    def spec_one(key, leaf):
        shape = tuple(leaf.shape)
        if key in ("k", "v", "cross_k", "cross_v"):
            return kv_spec(shape)
        if key in ("length", "enc_length"):
            return (_fit(mesh, shape[0], dp),)
        if key == "ssm_h":
            # (L, B, di, N) or (L, B, NH, HD, N)
            b_ax = _fit(mesh, shape[1], dp)
            inner = _fit(mesh, shape[2], "model")
            return (None, b_ax, inner) + (None,) * (len(shape) - 3)
        if key == "ssm_conv":
            b_ax = _fit(mesh, shape[1], dp)
            return (None, b_ax, None, _fit(mesh, shape[3], "model"))
        return ()

    return _map_with_path(spec_one, cache_tree)


def placements(mesh, spec):
    """One leaf's DTensor placements, one per mesh dim: ``Shard(d)`` on
    each mesh axis named by tensor dim d's entry, ``Replicate()`` on the
    rest. A dim over two axes (("pod", "data")) is ``Shard(d)`` on both:
    DTensor splits it in mesh order, pod-major, as the reference's
    ``PartitionSpec`` does."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                out[mesh.mesh_dim_names.index(axis)] = Shard(d)
    return tuple(out)


def make_shardings(mesh, spec_tree):
    """Spec tree -> tree of placement tuples, for
    ``distribute_tensor(leaf, mesh, placements)`` on `mesh`."""
    if isinstance(spec_tree, dict):
        return {k: make_shardings(mesh, v) for k, v in spec_tree.items()}
    return placements(mesh, spec_tree)
