"""The port's meshes and sharding rules against the JAX reference (CPU).

``repro_torch.distributed.sharding``'s ``param_specs``, ``batch_specs``
and ``cache_specs`` against ``repro.distributed.sharding``'s
``PartitionSpec``s, leaf for leaf, on the debug meshes (2, 4) and
(pod 2, 2, 2) and on both production meshes, (16, 16) and (2, 16, 16),
for the four archs of ``tests/test_distributed.py`` and an encoder-decoder
one, at smoke and at full size: the params (``abstract_params``), the
train and prefill batches (``input_specs``), the decode caches of
``decode_32k`` and ``long_500k`` (the sequence-parallel fall-back) and a
paged cache. The reference side runs in a subprocess that fakes 512 host
devices (this process is pinned to one by conftest); the port's rules
read only the mesh's axis names and sizes, so its side needs no process
group (``launch.mesh.MeshShape``).

Then a spawned 4-rank gloo group on a (2, 2) ``DeviceMesh`` distributes
smoke params through ``make_shardings`` + ``distribute_tensor``: every
local shard has the shape the spec implies and equals its slice of the
leaf. ``run_ranks`` (spawned ranks over a ``FileStore``, with a
timeout) is shared with ``tests/test_torch_moe_ep.py``. The spawned
tests are in the slow tier, as the reference's mesh tests are.
"""
import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_shape, get_smoke_config
from repro_torch.distributed import (batch_specs, cache_specs,
                                     make_shardings, param_specs)
from repro_torch.launch.mesh import (MeshShape, build_mesh, debug_mesh_shape,
                                     production_mesh_shape)
from repro_torch.models import Model

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["llama3-8b", "qwen2-moe-a2.7b", "falcon-mamba-7b", "zamba2-2.7b",
         "seamless-m4t-medium"]
MESHES = {
    "debug_2x4": debug_mesh_shape(2, 4),
    "debug_pod_2x2x2": debug_mesh_shape(2, 2, pod=2),
    "pod_16x16": production_mesh_shape(),
    "multipod_2x16x16": production_mesh_shape(multi_pod=True),
}
BATCH_SHAPES = ("train_4k", "prefill_32k")
CACHE_SHAPES = ("decode_32k", "long_500k")
PAGED = (8, 64, 16, 1024)        # batch, pages, page size, max_seq

REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, sys
import jax
from jax.sharding import PartitionSpec as P
from repro.configs import get_config, get_shape, get_smoke_config
from repro.distributed.sharding import batch_specs, cache_specs, param_specs
from repro.launch.mesh import make_debug_mesh, make_production_mesh
from repro.models import Model

ARCHS, BATCH_SHAPES, CACHE_SHAPES, PAGED = json.loads(sys.argv[1])
MESHES = {
    "debug_2x4": lambda: make_debug_mesh(2, 4),
    "debug_pod_2x2x2": lambda: make_debug_mesh(2, 2, pod=2),
    "pod_16x16": lambda: make_production_mesh(),
    "multipod_2x16x16": lambda: make_production_mesh(multi_pod=True),
}


def flat(tree):
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        key = "|".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = [list(e) if isinstance(e, tuple) else e for e in spec]
    return out


res = {}
for mname, make in MESHES.items():
    mesh = make()
    for arch in ARCHS:
        for size in ("smoke", "full"):
            cfg = (get_smoke_config if size == "smoke" else get_config)(arch)
            m = Model(cfg)
            trees = {"params": param_specs(mesh, m.abstract_params())}
            for s in BATCH_SHAPES:
                trees[s] = batch_specs(mesh, m.input_specs(get_shape(s)), cfg)
            for s in CACHE_SHAPES:
                cache = m.input_specs(get_shape(s))["cache"]
                trees[s] = cache_specs(mesh, cache, cfg)
            if m.supports_physical_paging():
                b, pages, page, seq = PAGED
                trees["paged"] = cache_specs(mesh, m.init_paged_cache(
                    b, pages, page, seq, abstract=True), cfg)
            for name, tree in trees.items():
                res["/".join((mname, arch, size, name))] = flat(tree)
print(json.dumps(res))
"""


def _port_specs(mesh, arch, size):
    cfg = (get_smoke_config if size == "smoke" else get_config)(arch)
    m = Model(cfg, device="cpu")
    trees = {"params": param_specs(mesh, m.abstract_params())}
    for s in BATCH_SHAPES:
        trees[s] = batch_specs(mesh, m.input_specs(get_shape(s)), cfg)
    for s in CACHE_SHAPES:
        trees[s] = cache_specs(mesh, m.input_specs(get_shape(s))["cache"],
                               cfg)
    if m.supports_physical_paging():
        b, pages, page, seq = PAGED
        trees["paged"] = cache_specs(mesh, m.init_paged_cache(
            b, pages, page, seq, abstract=True), cfg)
    return trees


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"|".join(path): json.loads(json.dumps(tree))}


@pytest.fixture(scope="module")
def reference_specs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    arg = json.dumps([ARCHS, BATCH_SHAPES, CACHE_SHAPES, PAGED])
    out = subprocess.run([sys.executable, "-c", REFERENCE, arg],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(reference_specs, mesh_name, arch):
    mesh = MESHES[mesh_name]
    n_sharded = 0
    for size in ("smoke", "full"):
        trees = _port_specs(mesh, arch, size)
        want_names = {k.split("/")[3] for k in reference_specs
                      if k.startswith(f"{mesh_name}/{arch}/{size}/")}
        assert set(trees) == want_names, (size, set(trees), want_names)
        for name, tree in trees.items():
            got = _flat(tree)
            want = reference_specs["/".join((mesh_name, arch, size, name))]
            assert got == want, (size, name, {
                k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                if got.get(k) != want.get(k)})
            n_sharded += sum(any(e is not None for e in s)
                             for s in got.values())
    assert n_sharded > 0     # the rules shard something on every mesh


def test_specs_fall_back_to_replication():
    """A dim that no axis divides is replicated; the batch falls back to
    "data" alone, then the cache to sequence parallelism."""
    mesh = MeshShape(("pod", "data", "model"), (2, 3, 4))
    w = torch.empty((6, 10), device="meta")
    assert param_specs(mesh, {"blocks": {"attn": {"wq": w}}}) == \
        {"blocks": {"attn": {"wq": (("pod", "data"), None)}}}
    assert batch_specs(mesh, {"tokens": torch.empty((9, 4), device="meta")}) \
        == {"tokens": ("data", None)}
    kv = torch.empty((2, 1, 12, 3, 8), device="meta")
    assert cache_specs(mesh, {"k": kv}, None) == \
        {"k": (None, None, ("pod", "data"), None, "model")}


# ---------------------------------------------------------------------------
# spawned gloo groups
# ---------------------------------------------------------------------------

def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 180.0):
    """Run fn(rank, world, store_path, *args) in `world` spawned processes
    (each calls `init_group`); raise if one fails or the group outlives
    `timeout` seconds, and kill what is left."""
    ctx = torch.multiprocessing.spawn(
        fn, args=(world, str(tmp_path / "store"), *args), nprocs=world,
        join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawned group still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)


def init_group(rank: int, world: int, store_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=120))


def _distribute_worker(rank, world, store_path, out_dir):
    from torch.distributed.tensor import distribute_tensor
    init_group(rank, world, store_path)
    try:
        mesh = build_mesh(debug_mesh_shape(2, 2), "cpu")
        report = {"coord": mesh.get_coordinate()}
        for arch in ("llama3-8b", "qwen2-moe-a2.7b", "zamba2-2.7b"):
            m = Model(get_smoke_config(arch), device="cpu")
            params = m.init(torch.Generator().manual_seed(0))
            specs = param_specs(mesh, params)
            plc = make_shardings(mesh, specs)
            leaves = {}
            for key, leaf in _leaf_items(params):
                dt = distribute_tensor(leaf, mesh, _get(plc, key))
                local = dt.to_local()
                want = _local_slice(leaf, _get(specs, key), mesh)
                leaves["|".join(key)] = [list(local.shape),
                                         bool(torch.equal(local, want))]
            report[arch] = leaves
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def _leaf_items(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_items(v, path + (k,))
    else:
        yield path, tree


def _get(tree, key):
    for k in key:
        tree = tree[k]
    return tree


def _local_slice(leaf, spec, mesh):
    """This rank's block of `leaf` under `spec`, sliced by hand: each
    sharded dim split over its axes in mesh order (pod-major)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = leaf
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx, n = 0, 1
        for a in axes:
            if a is not None:
                idx, n = idx * sizes[a] + coord[a], n * sizes[a]
        step = leaf.shape[d] // n
        out = out.narrow(d, idx * step, step)
    return out


@pytest.mark.slow
def test_distribute_tensor_on_gloo_mesh(tmp_path):
    run_ranks(_distribute_worker, 4, tmp_path, str(tmp_path))
    mesh = debug_mesh_shape(2, 2)
    reports = [json.loads((tmp_path / f"rank{r}.json").read_text())
               for r in range(4)]
    assert sorted(tuple(r["coord"]) for r in reports) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for arch in ("llama3-8b", "qwen2-moe-a2.7b", "zamba2-2.7b"):
        m = Model(get_smoke_config(arch), device="cpu")
        abstract = m.abstract_params()
        specs = param_specs(mesh, abstract)
        sharded = 0
        for key, leaf in _leaf_items(abstract):
            shape = list(leaf.shape)
            for d, entry in enumerate(_get(specs, key)):
                axes = entry if isinstance(entry, tuple) else (entry,)
                n = int(np.prod([dict(zip(mesh.mesh_dim_names,
                                          mesh.shape))[a]
                                 for a in axes if a is not None]))
                shape[d] //= n
            sharded += shape != list(leaf.shape)
            for rep in reports:
                got_shape, equal = rep[arch]["|".join(key)]
                assert got_shape == shape, (arch, key, got_shape, shape)
                assert equal, (arch, key)
        assert sharded > 0, arch
