"""Weights made from the run's seed, on the device, in a few large calls.

The layout is the port's parameter tree (``Model.abstract_params``): the
harness asks the port only for the shapes. Every leaf is a view into one
of three flat buffers: normal(0, 0.02) for every matrix (the embedding
table, the projections, the experts, the router, the unembedding), the
published configurations' ``initializer_range``; ones for the norm scales
and zeros for biases. (The port's own initialisation draws the embedding
with std 1: tied to the unembedding, that makes a random model repeat its
last token whatever its context, and no comparison of served tokens could
then see a fault.) The normal buffer is filled by one draw of a
``torch.Generator`` seeded with the run's seed, in the dtype the model is
served in. The same tensors go to the engine and to the reference.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

ALIGN = 128         # elements: each leaf starts 256-byte aligned in bf16


def _leaves(tree, prefix=()) -> List[Tuple[tuple, torch.Size]]:
    out = []
    for key, t in tree.items():
        if isinstance(t, dict):
            out += _leaves(t, prefix + (key,))
        else:
            out.append((prefix + (key,), t.shape))
    return out


def _kind(path: tuple) -> str:
    name = path[-1]
    if name.endswith("scale"):
        return "ones"
    if name in ("bq", "bk", "bv"):
        return "zeros"
    return "small"


def make_params(abstract: Dict, seed: int, device, dtype=torch.bfloat16,
                std: float = 0.02):
    """A tree shaped like `abstract` (meta tensors) with the weights of
    `seed` on `device` in `dtype`; `std` is the projections' spread."""
    leaves = _leaves(abstract)
    offsets, totals = [], {"small": 0, "ones": 0, "zeros": 0}
    for path, shape in leaves:
        kind = _kind(path)
        n = 1
        for s in shape:
            n *= int(s)
        offsets.append((kind, totals[kind], n))
        totals[kind] += -(-n // ALIGN) * ALIGN
    normal = torch.empty(totals["small"], dtype=dtype, device=device)
    draw(normal, seed, std)
    bufs = {"small": normal,
            "ones": torch.ones(totals["ones"], dtype=dtype, device=device),
            "zeros": torch.zeros(totals["zeros"], dtype=dtype,
                                 device=device)}
    tree: Dict = {}
    for (path, shape), (kind, off, n) in zip(leaves, offsets):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = bufs[kind][off: off + n].view(shape)
    return tree


def draw(normal: torch.Tensor, seed: int, std: float = 0.02) -> None:
    """One draw of the seed's generator over the normal buffer, scaled to
    `std`."""
    gen = torch.Generator(device=normal.device)
    gen.manual_seed(int(seed) % (1 << 63))
    normal.normal_(0.0, std, generator=gen)


def reseed(tree: Dict, seed: int, std: float = 0.02) -> None:
    """Redraw, in place, the weights of `tree` (made by make_params) for
    another seed: the same tensors, so an engine holding them serves the
    new weights."""
    emb = tree["embed"]["table"]
    draw(emb._base if emb._base is not None else emb, seed, std)


def param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_bytes(t) for t in tree.values())
    return tree.numel() * tree.element_size()
