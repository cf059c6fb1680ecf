"""Layouts for tensors split over a mesh (``DTensor``s, as the
multi-pod dry run, ``launch/dryrun.py``, places them).

Each helper is the plain operation on a plain tensor — a reshape, an
index write, nothing at all — so serving and training on one device run
exactly as they would without it. On a ``DTensor`` it also states a
layout where DTensor's own rules fail or pick a poor one: a reshape
that splits a sharded dim unevenly (KV heads fewer than the model axis),
the cache write of one decode step, the residual stream's layout from
layer to layer (a sharding constraint) and the rows of an embedding
lookup.
"""
from __future__ import annotations

import torch


def _is_dtensor(x) -> bool:
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def rows_like(h: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows `h` laid out like their `tokens`: split over the
    batch as they are, whole over d (the table's layout would split d),
    so the residual stream is batch-parallel from the start."""
    if not (_is_dtensor(h) and _is_dtensor(tokens)):
        return h
    from torch.distributed.tensor import Replicate, Shard
    return h.redistribute(h.device_mesh, [
        Shard(0) if p == Shard(0) else Replicate()
        for p in tokens.placements])


def split_dim(x: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """`x` with dim `dim` split into `sizes` (a reshape).

    A ``DTensor`` (the multi-pod dry run's) whose shards of `dim` do not
    split evenly into sizes[0] — KV heads fewer than the model axis — is
    first gathered on those mesh dims, reshaped, then split again over
    the first new dim the group divides (the head dim), as XLA reshards
    where DTensor refuses. A plain tensor is only reshaped."""
    shape = (*x.shape[:dim], *sizes, *x.shape[dim + 1:])
    if not _is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % x.ndim
    mesh, pl = x.device_mesh, list(x.placements)
    split = [i for i, p in enumerate(pl) if p == Shard(dim)]
    n = 1
    for i in split:
        n *= mesh.size(i)
    if n == 1 or sizes[0] % n == 0:
        return x.reshape(shape)
    x = x.redistribute(mesh, [Replicate() if i in split else p
                              for i, p in enumerate(pl)])
    y = x.reshape(shape)
    for j, size in enumerate(sizes):
        if size % n == 0:
            return y.redistribute(mesh, [Shard(dim + j) if i in split else p
                                         for i, p in enumerate(y.placements)])
    return y


def _shard_span(size: int, mesh, placements, dim: int):
    """(start, length) of this rank's shard of a tensor dim of `size`
    (torch.chunk's split, mesh dims in order)."""
    from torch.distributed.tensor import Shard
    start, length = 0, size
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p == Shard(dim):
            chunk = -(-length // mesh.size(i))
            lo = min(coord[i] * chunk, length)
            start, length = start + lo, min(lo + chunk, length) - lo
    return start, length


class _MergeDims(torch.autograd.Function):
    """A ``DTensor``'s dims `dim` and `dim` + 1 merged; the backward
    splits the gradient again through ``split_dim`` (which gathers a
    gradient split unevenly over the first of them)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.sizes = dim, (x.shape[dim], x.shape[dim + 1])
        return x.flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, ctx.sizes), None


def merge_dims(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`x` with dims `dim` and `dim` + 1 merged (a reshape): the heads of
    an attention output before the output projection. A plain tensor is
    only reshaped; a ``DTensor``'s gradient comes back through
    ``split_dim``."""
    if not _is_dtensor(x):
        return x.reshape(*x.shape[:dim], -1, *x.shape[dim + 2:])
    return _MergeDims.apply(x, dim % x.ndim)


def keep_layout(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`x` laid out as `like` (a partial sum of `like` as replicated)
    where the two have one shape: the residual stream keeps its layout
    from layer to layer, as a sharding constraint does. Only a ``DTensor``
    (the multi-pod dry run's) moves; a plain tensor is returned as it
    is."""
    if not (_is_dtensor(x) and _is_dtensor(like) and x.shape == like.shape):
        return x
    from torch.distributed.tensor import Replicate
    target = [Replicate() if p.is_partial() else p for p in like.placements]
    if list(x.placements) == target:
        return x
    return x.redistribute(like.device_mesh, target)


def write_rows_(cache: torch.Tensor, idx: torch.Tensor,
                new: torch.Tensor) -> None:
    """cache[b, idx[b]] = new[b] for every row b, in place: cache
    (B, S, ...), idx (B,) int, new (B, ...).

    A ``DTensor`` cache is written shard by shard: `new` is laid out like
    a row of the cache, and each rank writes the rows and positions its
    shard holds (a position another rank's sequence shard holds leaves
    the shard as it was)."""
    if not _is_dtensor(cache):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, idx] = new
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = cache.device_mesh, cache.placements
    row_pl = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 2
              else p if p == Shard(0) else Replicate() for p in pl]
    if _is_dtensor(new):
        new = new.redistribute(mesh, row_pl).to_local()
    if _is_dtensor(idx):
        idx = idx.full_tensor()
    local = cache.to_local()
    b0, nb = _shard_span(cache.shape[0], mesh, pl, 0)
    s0, ns = _shard_span(cache.shape[1], mesh, pl, 1)
    pos = idx[b0:b0 + nb].long() - s0
    keep = (pos >= 0) & (pos < ns)
    pos = torch.clamp(pos, 0, ns - 1)
    rows = torch.arange(nb, device=local.device)
    keep = keep.reshape(-1, *([1] * (new.ndim - 1)))
    local[rows, pos] = torch.where(keep, new, local[rows, pos])
