"""Multi-pod dry run: every (arch x input shape x mesh) step on DTensors
over a fake process group — ``src/repro/launch/dryrun.py``.

The reference lowers and compiles each phase's step for 256 or 512 faked
host devices and reads XLA's memory and cost analyses. The port has no
compiler to ask, so it runs the step itself, once, in one process that
plays rank 0 of a fake process group (``FakeStore``, backend "fake") the
size of the mesh: params, optimizer moments, batch and cache are
``DTensor``s placed by the port's ``param_specs`` / ``batch_specs`` /
``cache_specs`` through ``make_shardings``, their local shards
``FakeTensor``s (shapes and dtypes, nothing allocated), and the step runs
under ``implicit_replication()`` (plain tensors the model makes, such as
positions and masks, count as replicated). A dispatch mode that sits
below DTensor sees the ops rank 0 runs on its local shards and records:

  * ``flops_per_device``: the matmul-class FLOPs of those ops (the
    formulas of ``torch.utils.flop_counter``), plus the plain version's
    matmul FLOPs of each attention kernel (see below);
  * ``collective_counts`` / ``collective_bytes_by_op``: each
    ``_c10d_functional`` collective DTensor issues, its bytes by
    ``hlo_stats.collective_bytes`` over its group's size: all-reduce
    2(g-1)/g, all-gather (g-1)/g of the result, reduce-scatter (g-1) x
    the result, all-to-all its result. DTensor's shard-to-shard
    all-to-alls run as they would on NCCL (on a CPU mesh DTensor would
    gather the whole tensor instead);
  * ``memory``: ``argument_bytes`` and ``output_bytes``, the local shards
    rank 0 holds of the step's inputs and outputs, and ``peak_bytes``,
    the most bytes of local storage alive at once over the step
    (arguments included).

Ops DTensor runs on global shapes to derive output metadata are not
counted. The kernels the port runs on the card (flash attention, decode,
paged decode, the selective scan) run here as opaque local ops on each
rank's shards: their inputs are redistributed to a layout the kernel can
run per shard (batch, heads or channels split, else replicated; a KV
cache split over its sequence gives a partial output summed across that
axis), and they return empty outputs of the kernel's shapes. An
attention kernel charges the matmul FLOPs of the plain version (4 B Sq
Sk H hd forward, twice that backward, on its local shapes); the scan, an
elementwise recurrence, charges none, as ``hlo_stats`` counts dots only.
The plain scan is T steps of small ops and the plain attention holds
S x S scores, neither of which runs on the card.

Depth. The step runs at d and 2d layers, d one period of the arch's
layer pattern (one layer; one Mamba-2 round plus the shared block for
hybrid; one encoder and one decoder layer for encdec and audio), and
every recorded count — FLOPs, collective counts and bytes, argument,
output and peak bytes — is extrapolated linearly to the configured
depth: c(n) = c(d) + (n / d - 1) (c(2d) - c(d)). A train step with M
microbatches (global_batch // 16 of 16 samples, the reference's choice)
runs at 2 and 3 microbatches and extrapolates the same way in M, but
for the peak, the larger of the two (one microbatch's activations are
alive at a time). This is the port's counterpart of ``hlo_stats``' trip
multiplier: exact for FLOPs, collective counts and argument and output
bytes, whose per-layer and per-microbatch parts repeat; a model of the
collective bytes (DTensor may lay out the stacked gradient of two or
more layers where it keeps one layer's whole: 5.7% of the reduce-scatter
bytes of a 4-layer smoke train step) and of the peak.

Roofline terms use NVIDIA H100 SXM datasheet figures: PEAK_FLOPS,
HBM_BW and LINK_BW below. They are modelled constants, not measured on
a card, and each JSON says so under ``roofline.constants``.

The reference's keys without a counterpart here are dropped:
``lower_s`` and ``compile_s`` (nothing compiles; ``run_s`` is the wall
of the d / 2d runs), ``hlo_flops_per_device`` and
``hlo_bytes_per_device`` (no HLO cost analysis: ``flops_per_device`` is
the matmul count above), ``scan_trip_correction`` (the depth
extrapolation replaces it), ``trip_aware_dot_flops_per_device`` (the
same as ``flops_per_device``), ``fused_bound_bytes_per_device`` and
``memory_s_fused_bound`` (no dot operand census), and ``temp_bytes`` and
``alias_bytes`` (``peak_bytes`` stands in). ``memory_s`` reads the peak
bytes once over HBM_BW, a lower bound on the step's traffic.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--opt N]
      [--out experiments/dryrun_torch]

Shape/phase mapping as the reference's: train_4k -> the train step
(remat, microbatches of 16), prefill_32k -> prefill into a zero cache,
decode_32k / long_500k -> one decode step against a seq_len-deep cache;
long_500k takes the sliding window for archs with attention.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_shape
from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                              make_shardings, param_specs)
from repro_torch.launch.hlo_stats import collective_bytes
from repro_torch.launch.mesh import MeshShape, production_mesh_shape

#: NVIDIA H100 SXM5 datasheet: dense BF16 tensor-core peak, FLOP/s
PEAK_FLOPS = 989e12
#: NVIDIA H100 SXM5 datasheet: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
#: one 400 Gb/s NDR InfiniBand port per GPU (ConnectX-7), bytes/s: a
#: 16-wide model axis spans two 8-GPU NVLink nodes, so its collectives
#: cross the network at this rate
LINK_BW = 50e9
CONSTANTS = {
    "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "link_bw": LINK_BW,
    "source": "modelled: NVIDIA H100 SXM datasheet (bf16 dense, HBM3) "
              "and 400 Gb/s NDR InfiniBand per GPU; not measured",
}
MICRO_SAMPLES = 16


# ---------------------------------------------------------------------------
# The plan: the reference's choices per combination
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    window: Optional[int]
    kv_repeat: int
    moe_seq_chunk: int
    moe_ep: bool


def plan(cfg: ModelConfig, shape_name: str, mesh: MeshShape, opt: int,
         shape: Optional[ShapeConfig] = None) -> Plan:
    """The reference's settings for one combination
    (``src/repro/launch/dryrun.py:build_lowering``): the sliding window
    at long_500k; under opt >= 1 KV heads replicated up to the model
    axis (only where the batch splits over the data axes and the
    replicated cache stays under 8 GB a device) and MoE prefill over
    2048-token chunks; under opt 2 expert-parallel MoE at prefill and
    train (which turns chunking off)."""
    shape = shape or get_shape(shape_name)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    window = None
    if shape_name == "long_500k" and cfg.attn_layer_ids():
        window = cfg.sliding_window
    kv_repeat = 1
    tp = sizes["model"]
    if opt >= 1 and cfg.num_kv_heads and shape.phase in ("prefill",
                                                         "decode"):
        if tp % cfg.num_kv_heads == 0 and tp > cfg.num_kv_heads:
            r = tp // cfg.num_kv_heads
            chips = math.prod(mesh.shape)
            data = chips // tp
            kv_dev = (shape.seq_len * shape.global_batch
                      * cfg.kv_bytes_per_token() * r) / chips
            if shape.global_batch % data == 0 and kv_dev < 8e9:
                kv_repeat = r
    moe_chunk = 2048 if (opt >= 1 and cfg.kind == "moe"
                         and shape.phase == "prefill") else 0
    moe_ep = (opt >= 2 and cfg.kind == "moe"
              and shape.phase in ("prefill", "train"))
    if moe_ep:
        moe_chunk = 0
    return Plan(window, kv_repeat, moe_chunk, moe_ep)


# ---------------------------------------------------------------------------
# Depth and microbatch cuts
# ---------------------------------------------------------------------------

def depth_periods(cfg: ModelConfig) -> int:
    """How many periods of its layer pattern `cfg` stacks."""
    if cfg.kind == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_every
    if cfg.kind in ("encdec", "audio"):
        assert cfg.num_encoder_layers == cfg.num_layers, cfg.name
    return cfg.num_layers


def depth_cut(cfg: ModelConfig, periods: int) -> ModelConfig:
    """`cfg` with `periods` periods of its layer pattern."""
    if cfg.kind == "hybrid":
        return dataclasses.replace(
            cfg, num_layers=periods * cfg.hybrid_attn_every)
    if cfg.kind in ("encdec", "audio"):
        return dataclasses.replace(cfg, num_layers=periods,
                                   num_encoder_layers=periods)
    return dataclasses.replace(cfg, num_layers=periods)


def _lerp(lo: dict, hi: dict, x0: float, x1: float, x: float) -> dict:
    """Every number of two count dicts, linear through (x0, lo) and
    (x1, hi), at x (nested dicts key by key; a key one side lacks is 0
    there)."""
    out = {}
    for k in sorted(set(lo) | set(hi)):
        a, b = lo.get(k, 0), hi.get(k, 0)
        if isinstance(a, dict) or isinstance(b, dict):
            out[k] = _lerp(a or {}, b or {}, x0, x1, x)
        else:
            out[k] = a + (b - a) * (x - x0) / (x1 - x0)
    return out


# ---------------------------------------------------------------------------
# Fake process group and mesh
# ---------------------------------------------------------------------------

def _fake_world(size: int) -> None:
    """A fake default process group of `size` ranks, this process rank
    0 (replacing one of another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    _MESHES.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


_MESHES: Dict[MeshShape, object] = {}


def device_mesh(mesh: MeshShape):
    """The CPU ``DeviceMesh`` of `mesh` over a fake process group of its
    size, this process rank 0 (built once per shape and group)."""
    _fake_world(math.prod(mesh.shape))
    if mesh not in _MESHES:
        from torch.distributed.device_mesh import init_device_mesh
        _MESHES[mesh] = init_device_mesh("cpu", mesh.shape,
                                         mesh_dim_names=mesh.mesh_dim_names)
    return _MESHES[mesh]


# ---------------------------------------------------------------------------
# Counting what rank 0 runs
# ---------------------------------------------------------------------------

_COLLECTIVES = {
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_"): "all-reduce",
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_out"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
    ("_c10d_functional", "broadcast"): "collective-permute",
    ("_c10d_functional", "broadcast_"): "collective-permute",
    ("c10d", "allreduce_"): "all-reduce",
}


def _collective_args(ns: str, args, kwargs, out):
    """(result tensor, group size) of a collective: a functional one
    names its group; c10d's in-place ones (``moe_ep``'s all-reduces) take
    the group object and return their tensors in a list."""
    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d
    if ns == "c10d":
        return out[0][0], dist.ProcessGroup.unbox(args[1]).size()
    name = kwargs.get("group_name", args[-1])
    return out, c10d._resolve_process_group(name).size()


class _Counter:
    """Rank 0's counts over one step (see the module docstring)."""

    def __init__(self):
        self.flops = 0
        self.counts: Dict[str, float] = {}
        self.bytes: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._storages = weakref.WeakKeyDictionary()
        self.meta_depth = 0      # > 0 while DTensor derives metadata

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, n: int) -> None:
        self.live -= n

    def collective(self, op: str, out: torch.Tensor, g: int) -> None:
        b = out.numel() * out.element_size()
        self.counts[op] = self.counts.get(op, 0) + 1
        self.bytes[op] = self.bytes.get(op, 0.0) + collective_bytes(op, b, g)


_COUNTER: Optional[_Counter] = None


def _counting_mode(counter: _Counter):
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import flop_registry

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented        # let DTensor desugar first
            out = func(*args, **kwargs)
            if counter.meta_depth:
                return out
            packet = func._overloadpacket
            if packet in flop_registry:
                counter.flops += int(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            ns, name = func.namespace, packet.__name__
            if (ns, name) in _COLLECTIVES:
                counter.collective(_COLLECTIVES[ns, name],
                                   *_collective_args(ns, args, kwargs, out))
            if packet.__name__ != "wait_tensor":
                for t in tree_flatten(out)[0]:
                    if isinstance(t, torch.Tensor):
                        counter.track(t)
            return out

    return Mode()


def _uncounted(counter: _Counter, fn, real: bool):
    """`fn` with its ops uncounted (and, with `real`, run on real tensors:
    DTensor's index arithmetic for strided shards, which a fake mode
    cannot answer)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    mode = unset_fake_temporarily if real else contextlib.nullcontext

    def wrapped(*a, **k):
        counter.meta_depth += 1
        try:
            with mode():
                return fn(*a, **k)
        finally:
            counter.meta_depth -= 1
    return wrapped


@contextlib.contextmanager
def _counting(counter: _Counter):
    """Count rank 0's local ops, not DTensor's metadata runs."""
    global _COUNTER
    from torch.distributed.tensor import _redistribute as rd
    from torch.distributed.tensor import _sharding_prop as sp
    from torch.distributed.tensor import placement_types as pt
    patches = [(rd, "_gen_transform_infos_non_cached",
                _cached_plans(rd._gen_transform_infos_non_cached)),
               (sp.ShardingPropagator, "_propagate_tensor_meta_non_cached",
                _uncounted(counter, sp.ShardingPropagator
                           ._propagate_tensor_meta_non_cached, False)),
               (pt._StridedShard, "local_shard_size_and_offset",
                _uncounted(counter, pt._StridedShard
                           .local_shard_size_and_offset, True)),
               (pt, "shard_dim_alltoall", _all_to_all)]
    saved = [(obj, name, getattr(obj, name) if not isinstance(obj, type)
              else obj.__dict__[name]) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    _COUNTER = counter
    try:
        with _counting_mode(counter):
            yield counter
    finally:
        _COUNTER = None
        for obj, name, fn in saved:
            setattr(obj, name, fn)


_PLANS: Dict[tuple, list] = {}


def _plan_key(spec):
    """What a redistribution plan reads of a spec: mesh, placements,
    shard order and shape (not strides or dtype)."""
    meta = spec.tensor_meta
    return (spec.mesh, spec.placements, spec.shard_order,
            getattr(spec, "use_strided_shard_as_shard_order", None),
            None if meta is None else tuple(meta.shape))


def _cached_plans(plan):
    """DTensor's redistribution planner, cached. Under a fake mode DTensor
    plans every redistribution, and every candidate layout's cost,
    afresh: for strided shards a graph search over the mesh's states
    that dominates a 3-D mesh's run."""
    @functools.wraps(plan)
    def cached(src, dst, use_graph_based_transform=None):
        key = (_plan_key(src), _plan_key(dst), use_graph_based_transform)
        if key not in _PLANS:
            _PLANS[key] = plan(src, dst, use_graph_based_transform)
        return _PLANS[key]
    return cached


def _all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-to-shard all-to-all as NCCL runs it (on a CPU mesh
    DTensor would all-gather the whole tensor and keep a chunk)."""
    from torch.distributed import _functional_collectives as funcol
    group = funcol._resolve_group((mesh, mesh_dim))
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, funcol._group_or_group_name(group))


# ---------------------------------------------------------------------------
# The card's kernels as opaque local ops
# ---------------------------------------------------------------------------

def _charge(flops: int) -> None:
    if _COUNTER is not None and not _COUNTER.meta_depth:
        _COUNTER.flops += int(flops)


class _Kernel(torch.autograd.Function):
    """An opaque kernel on local shards: empty outputs of the given
    shapes, `flops` charged forward and `2 * flops` backward."""

    @staticmethod
    def forward(ctx, flops, out_specs, *inputs):
        ctx.flops = flops
        ctx.specs = [(t.shape, t.dtype) for t in inputs]
        _charge(flops)
        outs = tuple(torch.empty(s, dtype=d, device=inputs[0].device)
                     for s, d in out_specs)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        _charge(2 * ctx.flops)
        dev = grads[0].device
        return (None, None) + tuple(torch.empty(s, dtype=d, device=dev)
                                    for s, d in ctx.specs)


def _kernel(flops, out_specs, *inputs):
    diff = [t for t in inputs if t.is_floating_point()]
    return _Kernel.apply(flops, out_specs, *diff)


def _local(t, placements):
    """Rank 0's shard of DTensor `t` laid out as `placements` (a plain
    tensor, replicated, as it is)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, placements).to_local()


def _wrap(local, mesh, placements, shape):
    from torch.distributed.tensor import DTensor
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _run_attn(q, k, v, flops_fn, *, head_dim_q=2):
    """An attention kernel on rank 0's shards. Per mesh dim: rows split
    where the cache (or k) splits its batch; else, on the model axis,
    heads split where q's heads divide (k/v heads too where theirs do,
    else whole; a partial q is reduce-scattered); else a cache split
    over its sequence gives each rank a partial output (the split-KV
    combine, summed across that dim); else all replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    h, kv = q.shape[head_dim_q], k.shape[2]
    qp, kp, op = [], [], []
    for i, name in enumerate(mesh.mesh_dim_names):
        n = mesh.size(i)
        pq, pk = q.placements[i], k.placements[i]
        if (q.shape[0] % n == 0 and k.shape[0] % n == 0
                and (pk == Shard(0) or (pq == Shard(0)
                                        and not pk.is_shard()))):
            lay = (Shard(0), Shard(0), Shard(0))
        elif name == "model" and h % n == 0:
            lay = (Shard(head_dim_q),
                   Shard(2) if kv % n == 0 else Replicate(),
                   Shard(head_dim_q))
        elif pk == Shard(1):
            lay = (Replicate(), Shard(1), Partial())
        else:
            lay = (Replicate(), Replicate(), Replicate())
        for out, p in zip((qp, kp, op), lay):
            out.append(p)
    ql, kl, vl = _local(q, qp), _local(k, kp), _local(v, kp)
    o, = _kernel(flops_fn(ql, kl), [(ql.shape, ql.dtype)], ql, kl, vl)
    return _wrap(o, mesh, op, q.shape)


def _attention(q, k, v, *, causal=True, window=None, lengths=None,
               q_offset=None, sm_scale=None):
    def flops(ql, kl):
        b, sq, h, hd = ql.shape
        return 4 * b * sq * kl.shape[1] * h * hd
    return _run_attn(q, k, v, flops)


def _decode_attention(q, k, v, lengths, *, window=None, sm_scale=None):
    def flops(ql, kl):
        b, h, hd = ql.shape
        return 4 * b * kl.shape[1] * h * hd
    return _run_attn(q, k, v, flops, head_dim_q=1)


def _paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                            window=None, sm_scale=None):
    def flops(ql, kl):
        b, h, hd = ql.shape
        return 4 * b * block_tables.shape[1] * kl.shape[1] * h * hd
    return _run_attn(q, k_pool, v_pool, flops, head_dim_q=1)


def _scan(x, dt, A, B, C, D):
    """The selective scan on rank 0's shards -> (y, h_last): Mamba-1 (x
    (B, S, D), A (D, N)) or Mamba-2 as ``ops.ssd`` takes it (x (B, S, NH,
    HD), A (NH,)); the channels are dim 2 of x in both. Per mesh dim:
    the batch split, or the channels (with dt, A and D; B and C whole),
    else all replicated."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    hshape = (x.shape[0], *x.shape[2:], B.shape[-1])
    xp, ap, bp, hp = [], [], [], []
    for i in range(mesh.ndim):
        m, p = mesh.size(i), x.placements[i]
        if p == Shard(0) and x.shape[0] % m == 0:
            lay = (Shard(0), Replicate(), Shard(0), Shard(0))
        elif p == Shard(2) and x.shape[2] % m == 0:
            lay = (Shard(2), Shard(0), Replicate(), Shard(1))
        else:
            lay = (Replicate(),) * 4
        for out, q in zip((xp, ap, bp, hp), lay):
            out.append(q)
    xl, dtl = _local(x, xp), _local(dt, xp)
    al, dl = _local(A, ap), _local(D, ap)
    bl, cl = _local(B, bp), _local(C, bp)
    hl = (xl.shape[0], *xl.shape[2:], bl.shape[-1])
    y, h = _kernel(0, [(xl.shape, xl.dtype), (hl, torch.float32)],
                   xl, dtl, al, bl, cl, dl)
    return _wrap(y, mesh, xp, x.shape), _wrap(h, mesh, hp, hshape)


@contextlib.contextmanager
def kernels_as_local_ops():
    """Route ``kernels.ops``' kernel entry points through the opaque local
    ops above for the duration."""
    from repro_torch.kernels import ops
    swap = {
        "attention": _attention,
        "decode_attention": _decode_attention,
        "paged_decode_attention": _paged_decode_attention,
        "selective_scan": lambda *a: _scan(*a)[0],
        "selective_scan_with_state": _scan,
        "ssd": lambda *a: _scan(*a)[0],
        "ssd_with_state": _scan,
    }
    saved = {k: getattr(ops, k) for k in swap}
    for k, fn in swap.items():
        setattr(ops, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(ops, k, fn)


# ---------------------------------------------------------------------------
# Building the step
# ---------------------------------------------------------------------------

def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def _place(tree, placements, mesh):
    """Meta leaves -> DTensors of fake local shards, placed."""
    from torch.distributed.tensor import distribute_tensor

    def one(leaf, pl):
        full = torch.empty(leaf.shape, dtype=leaf.dtype)
        return distribute_tensor(full, mesh, list(pl))
    return _map2(one, tree, placements)


def _bytes(tree) -> int:
    """Bytes of the local shards of a tree's tensors (each storage
    once)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten
    seen, n = set(), 0
    for t in tree_flatten(tree)[0]:
        if not isinstance(t, torch.Tensor):
            continue
        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        if id(st) in seen:
            continue
        seen.add(id(st))
        n += t.numel() * t.element_size()
    return n


def build_step(cfg: ModelConfig, shape: ShapeConfig, shape_name: str,
               mesh_shape: MeshShape, opt: int = 0,
               microbatches: Optional[int] = None, mesh=None):
    """The phase's step for one combination, on DTensors over `mesh`
    (``device_mesh(mesh_shape)``, built before the fake mode is entered).
    Call under a ``FakeTensorMode``. Returns (fn, args): fn(*args) runs
    the step."""
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import OptimizerConfig, OptState
    from repro_torch.training.train import build_train_step
    pl = plan(cfg, shape_name, mesh_shape, opt, shape)
    model = Model(cfg, window=pl.window, kv_repeat=pl.kv_repeat,
                  moe_seq_chunk=pl.moe_seq_chunk,
                  moe_ep_mesh=mesh if pl.moe_ep else None, device="cpu")
    p_abs = model.abstract_params(torch.bfloat16)
    p_specs = param_specs(mesh_shape, p_abs)
    params = _place(p_abs, make_shardings(mesh_shape, p_specs), mesh)
    specs = model.input_specs(shape)

    if shape.phase == "train":
        m_abs = _map2(lambda t, _: torch.empty(t.shape, dtype=torch.float32,
                                               device="meta"), p_abs, p_abs)
        p_pl = make_shardings(mesh_shape, p_specs)
        state = OptState(
            _place(torch.empty((), dtype=torch.int32, device="meta"),
                   make_shardings(mesh_shape, ()), mesh),
            _place(m_abs, p_pl, mesh), _place(m_abs, p_pl, mesh))
        batch = _place(specs, make_shardings(
            mesh_shape, batch_specs(mesh_shape, specs, cfg)), mesh)
        micro = microbatches or max(1, shape.global_batch // MICRO_SAMPLES)
        step = build_train_step(model, OptimizerConfig(), remat=True,
                                microbatches=micro)
        return step, (params, state, batch)

    if shape.phase == "prefill":
        batch = _place(specs, make_shardings(
            mesh_shape, batch_specs(mesh_shape, specs, cfg)), mesh)
        c_abs = model.init_cache(shape.global_batch, shape.seq_len,
                                 enc_seq=model.enc_seq(shape.seq_len),
                                 dtype=torch.bfloat16, abstract=True)
        c_pl = make_shardings(mesh_shape, cache_specs(mesh_shape, c_abs, cfg))

        def prefill(params, batch):
            from torch.distributed.tensor import zeros
            cache = _map2(lambda t, p: zeros(t.shape, dtype=t.dtype,
                                             device_mesh=mesh,
                                             placements=list(p)),
                          c_abs, c_pl)
            with torch.no_grad():
                return model.prefill(params, batch, cache)
        return prefill, (params, batch)

    c_abs = specs["cache"]
    cache = _place(c_abs, make_shardings(
        mesh_shape, cache_specs(mesh_shape, c_abs, cfg)), mesh)
    tokens = _place({"tokens": specs["tokens"]}, make_shardings(
        mesh_shape, batch_specs(mesh_shape, {"tokens": specs["tokens"]},
                                cfg)), mesh)["tokens"]

    def decode(params, tokens, cache):
        with torch.no_grad():
            return model.decode_step(params, tokens, cache)
    return decode, (params, tokens, cache)


def measure(cfg: ModelConfig, shape: ShapeConfig, shape_name: str,
            mesh_shape: MeshShape, opt: int = 0,
            microbatches: Optional[int] = None) -> dict:
    """One run of the step: rank 0's counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    mesh = device_mesh(mesh_shape)
    with FakeTensorMode(allow_non_fake_inputs=True), \
            kernels_as_local_ops(), implicit_replication():
        fn, args = build_step(cfg, shape, shape_name, mesh_shape, opt,
                              microbatches, mesh)
        counter = _Counter()
        arg_bytes = _bytes(args)
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_flatten
        for t in tree_flatten(args)[0]:
            if isinstance(t, DTensor):
                counter.track(t.to_local())
        with _counting(counter):
            out = fn(*args)
        out_bytes = _bytes(out)
        del out, args
    return {"flops": counter.flops, "counts": dict(counter.counts),
            "bytes": dict(counter.bytes), "argument_bytes": arg_bytes,
            "output_bytes": out_bytes, "peak_bytes": counter.peak}


def extrapolated_counts(cfg: ModelConfig, shape: ShapeConfig,
                        shape_name: str, mesh_shape: MeshShape,
                        opt: int = 0) -> dict:
    """The counts at the configured depth (and microbatches), from runs
    at d and 2d (and 2 and 3 microbatches) — the module docstring."""
    periods = depth_periods(cfg)
    micro = (max(1, shape.global_batch // MICRO_SAMPLES)
             if shape.phase == "train" else None)

    def at(m, mshape):
        runs = [measure(depth_cut(cfg, p), mshape, shape_name, mesh_shape,
                        opt, m) for p in (1, 2)]
        return _lerp(runs[0], runs[1], 1, 2, periods)

    if micro is None or micro <= 3:
        return at(micro, shape)
    per = shape.global_batch // micro
    lo = at(2, dataclasses.replace(shape, global_batch=2 * per))
    hi = at(3, dataclasses.replace(shape, global_batch=3 * per))
    out = _lerp(lo, hi, 2, 3, micro)
    # one microbatch's activations are alive at a time
    out["peak_bytes"] = max(lo["peak_bytes"], hi["peak_bytes"])
    return out


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            mesh: Optional[MeshShape] = None, opt: int = 0,
            cfg: Optional[ModelConfig] = None,
            shape: Optional[ShapeConfig] = None,
            verbose: bool = True) -> dict:
    """One combination's record: the reference's keys where the port has
    the quantity (module docstring)."""
    mesh = mesh or production_mesh_shape(multi_pod=multi_pod)
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    chips = math.prod(mesh.shape)
    t0 = time.time()
    c = extrapolated_counts(cfg, shape, shape_name, mesh, opt)
    run_s = time.time() - t0
    pl = plan(cfg, shape_name, mesh, opt, shape)
    n_params, n_active = cfg.param_count(), cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.phase != "decode"
                                   else 1)
    model_flops = (6.0 if shape.phase == "train" else 2.0) * n_active * tokens
    flops = float(c["flops"])
    coll = float(sum(c["bytes"].values()))
    terms = {"compute_s": flops / PEAK_FLOPS,
             "memory_s": float(c["peak_bytes"]) / HBM_BW,
             "collective_s": coll / LINK_BW}
    dominant = max(terms, key=terms.get)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": f"{'x'.join(str(s) for s in mesh.shape)}"
                f" ({','.join(mesh.mesh_dim_names)})",
        "chips": int(chips),
        "phase": shape.phase,
        "run_s": round(run_s, 1),
        "flops_per_device": flops,
        "flops_global": flops * chips,
        "collective_bytes_per_device": coll,
        "collective_counts": c["counts"],
        "collective_bytes_by_op": c["bytes"],
        "memory": {"argument_bytes": c["argument_bytes"],
                   "output_bytes": c["output_bytes"],
                   "peak_bytes": c["peak_bytes"]},
        "roofline": {
            **terms,
            "dominant": dominant,
            "model_flops_global": model_flops,
            "useful_flops_ratio": model_flops / max(flops * chips, 1.0),
            "constants": CONSTANTS,
        },
        "window": pl.window,
        "kv_repeat": pl.kv_repeat,
        "params": n_params,
        "active_params": n_active,
        "opt": opt,
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {result['mesh']}: "
              f"run {run_s:.1f}s | args {c['argument_bytes'] / 1e9:.2f} GB"
              f"/dev | peak {c['peak_bytes'] / 1e9:.2f} GB/dev | "
              f"flops/dev {flops:.3e} | coll {coll:.3e} B | "
              f"dominant={dominant}", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt", type=int, default=0,
                    help="0=paper-faithful baseline, 1=beyond-paper opts")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    mesh = production_mesh_shape(multi_pod=args.multi_pod)
    combos = []
    if args.all:
        for a in ARCH_IDS:
            if a == "opt-66b":
                continue       # paper model is benchmark-only, not assigned
            for s in INPUT_SHAPES:
                combos.append((a, s))
    else:
        combos.append((args.arch, args.shape))

    os.makedirs(args.out, exist_ok=True)
    failures = []
    t0 = time.time()
    for arch, shape in combos:
        tag = "multipod" if args.multi_pod else "pod"
        if args.opt:
            tag += f"_opt{args.opt}"
        path = os.path.join(args.out, f"{arch}_{shape}_{tag}.json")
        if os.path.exists(path):
            print(f"[dryrun] skip (exists): {path}")
            continue
        try:
            res = run_one(arch, shape, mesh=mesh, opt=args.opt)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
        except Exception as e:  # noqa: BLE001 — report all failures at end
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"[dryrun] all {len(combos)} combinations ran in "
          f"{time.time() - t0:.1f} s.")


if __name__ == "__main__":
    main()
