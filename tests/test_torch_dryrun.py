"""The port's multi-pod dry run against the reference's (CPU).

``repro_torch.launch.dryrun`` runs each phase's step on DTensors over a
fake process group; ``repro.launch.dryrun`` lowers and compiles it for
faked host devices. The reference side runs in one subprocess (its module
sets ``XLA_FLAGS`` at import, and this process is pinned to one device
by conftest), as ``tests/test_torch_sharding.py`` does, and no reference
file changes:

  * the plan — window, kv_repeat, moe_seq_chunk, expert parallelism —
    for every arch of ``--all`` x shape x production mesh (16x16 and
    2x16x16) x opt 0/1/2, 240 cases: ``repro.launch.dryrun.Model`` is
    swapped for a recorder that keeps its keyword arguments and raises,
    so ``build_lowering`` stops before it lowers anything;
  * ``run_one`` at smoke size on the (2, 4) and (pod 2, 2, 2) debug
    meshes for llama3-8b, qwen2-moe, falcon-mamba and zamba2 at every
    phase, with ``get_config`` / ``get_shape`` pointed at the smoke
    configs and the small shapes below as module attributes.

Compared with the port's ``run_one`` on the same meshes: arch, shape,
phase, chips, mesh, window, params, active_params, opt and
``model_flops_global`` exactly; ``argument_bytes`` per device exactly
(the local shards rank 0 holds; DTensor's first shard of an uneven
split is the padded size XLA gives every device); the port's
``flops_per_device`` against the reference's
``trip_aware_dot_flops_per_device`` within [1/2, 4]x. The band is wide
on purpose: both count the matmuls of one device, but DTensor picks each
op's layout from its own cost model. At smoke widths moving a small
activation is cheaper than gathering a weight, so some MLP products run
with the batch gathered over the data axes and whole over the model
axis, up to the model axis' size (4) times XLA's count; the attention
kernels charge their local shapes, where XLA splits the same einsums.

Then the depth and microbatch extrapolation against full runs: a 4-layer
llama3 smoke cut (prefill, and train at 4 microbatches, extrapolated from
2 and 3) and a 3-round zamba2 smoke cut (decode), extrapolated from one
and two periods: FLOPs and collective counts exactly equal to the full
run's, and argument bytes too; collective bytes within 10% (the note at
BYTES_TOL). ``plan`` reads only a ``MeshShape``, and
``main`` writes one JSON per combination and reports failures with exit
1.

The tests that need the reference's subprocess spawn a process and are
``slow``; so is the 4-run train extrapolation, which takes longer than
30 s.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import INPUT_SHAPES, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (debug_mesh_shape, production_mesh_shape)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ALL_ARCHS = [a for a in ARCH_IDS if a != "opt-66b"]
SMOKE_ARCHS = ["llama3-8b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
               "zamba2-2.7b"]
SMALL = {"train_4k": ShapeConfig("train_4k", 64, 32, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 64, 8, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 64, 8, "decode"),
         "long_500k": ShapeConfig("long_500k", 128, 1, "decode")}
MESHES = {"2x4": debug_mesh_shape(2, 4),
          "2x2x2": debug_mesh_shape(2, 2, pod=2)}
FLOPS_BAND = (0.5, 4.0)
# collective bytes need not repeat layer for layer: DTensor may lay out
# the stacked gradient of two or more layers (torch.unbind's backward)
# where it keeps one layer's whole; at 4 smoke layers x 4 microbatches
# the reduce-scatter bytes extrapolated from 1 and 2 layers are 5.7% low
BYTES_TOL = 0.1

REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, sys
import repro.launch.dryrun as d
from repro.configs import get_smoke_config
from repro.configs.base import INPUT_SHAPES, ShapeConfig
from repro.launch.mesh import make_debug_mesh, make_production_mesh

ARCHS, SMOKE_ARCHS, SMALL = json.loads(sys.argv[1])
out = {"plan": {}, "run": {}}


class Stop(Exception):
    pass


class Recorder:
    last = None

    def __init__(self, cfg, **kw):
        Recorder.last = kw
        raise Stop


real_model = d.Model
d.Model = Recorder
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for arch in ARCHS:
        for shape in INPUT_SHAPES:
            for opt in (0, 1, 2):
                try:
                    d.build_lowering(arch, shape, mesh, opt=opt)
                except Stop:
                    pass
                kw = Recorder.last
                out["plan"][f"{int(mp)}|{arch}|{shape}|{opt}"] = [
                    kw["window"], kw["kv_repeat"], kw["moe_seq_chunk"],
                    kw["moe_ep_mesh"] is not None]
d.Model = real_model

shapes = {k: ShapeConfig(*v) for k, v in SMALL.items()}
d.get_config = get_smoke_config
d.get_shape = shapes.__getitem__
for name, mesh in (("2x4", make_debug_mesh(2, 4)),
                   ("2x2x2", make_debug_mesh(2, 2, pod=2))):
    for arch in SMOKE_ARCHS:
        for shape in shapes:
            out["run"][f"{name}|{arch}|{shape}"] = d.run_one(
                arch, shape, mesh=mesh, verbose=False)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    arg = json.dumps([ALL_ARCHS, SMOKE_ARCHS,
                      {k: [v.name, v.seq_len, v.global_batch, v.phase]
                       for k, v in SMALL.items()}])
    res = subprocess.run([sys.executable, "-c", REFERENCE, arg],
                         capture_output=True, text=True, env=env,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.slow
@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_plan_matches_reference(reference, arch, multi_pod):
    mesh = production_mesh_shape(multi_pod=multi_pod)
    cfg = get_config(arch)
    for shape in INPUT_SHAPES:
        for opt in (0, 1, 2):
            p = dryrun.plan(cfg, shape, mesh, opt)
            got = [p.window, p.kv_repeat, p.moe_seq_chunk, p.moe_ep]
            want = reference["plan"][f"{int(multi_pod)}|{arch}|{shape}|{opt}"]
            assert got == want, (shape, opt)


def test_plan_takes_every_branch():
    """The guards and switches the reference's plan has, each met by
    some full config: KV replication at opt 1 (and not at opt 0, nor
    where KV already fills the model axis, nor for B = 1), MoE chunking
    at prefill, expert parallelism at opt 2, the window at long_500k."""
    pod = production_mesh_shape()
    llama = get_config("llama3-8b")
    assert dryrun.plan(llama, "decode_32k", pod, 1).kv_repeat == 2
    assert dryrun.plan(llama, "decode_32k", pod, 0).kv_repeat == 1
    assert dryrun.plan(llama, "long_500k", pod, 1).kv_repeat == 1
    assert dryrun.plan(llama, "long_500k", pod, 0).window == \
        llama.sliding_window
    assert dryrun.plan(get_config("qwen2-moe-a2.7b"), "decode_32k", pod,
                       1).kv_repeat == 1               # KV 16 = tp
    moe = get_config("qwen2-moe-a2.7b")
    assert dryrun.plan(moe, "prefill_32k", pod, 1).moe_seq_chunk == 2048
    p2 = dryrun.plan(moe, "prefill_32k", pod, 2)
    assert p2.moe_ep and p2.moe_seq_chunk == 0
    assert not dryrun.plan(moe, "decode_32k", pod, 2).moe_ep
    assert dryrun.plan(get_config("falcon-mamba-7b"), "long_500k", pod,
                       0).window is None


EXACT = ("arch", "shape", "phase", "chips", "mesh", "window", "params",
         "active_params", "opt")


@pytest.mark.slow
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_run_one_matches_reference(reference, arch, mesh):
    for shape, shp in SMALL.items():
        got = dryrun.run_one(arch, shape, mesh=MESHES[mesh],
                             cfg=get_smoke_config(arch), shape=shp,
                             verbose=False)
        want = reference["run"][f"{mesh}|{arch}|{shape}"]
        for key in EXACT:
            assert got[key] == want[key], (shape, key)
        assert got["roofline"]["model_flops_global"] == \
            want["roofline"]["model_flops_global"], shape
        assert got["memory"]["argument_bytes"] == \
            want["memory"]["argument_bytes"], shape
        ratio = got["flops_per_device"] / \
            want["trip_aware_dot_flops_per_device"]
        assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], (shape, ratio)
        assert got["roofline"]["dominant"] in ("compute_s", "memory_s",
                                               "collective_s")
        assert got["collective_counts"], shape
        assert got["memory"]["peak_bytes"] >= \
            got["memory"]["argument_bytes"], shape


def _check_extrapolation(cfg, shape, name, full_micro=None):
    mesh = MESHES["2x4"]
    got = dryrun.extrapolated_counts(cfg, shape, name, mesh)
    want = dryrun.measure(cfg, shape, name, mesh, 0, full_micro)
    assert got["flops"] == want["flops"]
    assert got["counts"] == want["counts"]
    assert got["argument_bytes"] == want["argument_bytes"]
    assert got["bytes"] == pytest.approx(want["bytes"], rel=BYTES_TOL)


def test_depth_extrapolation_matches_full_run_dense():
    cfg = dryrun.depth_cut(get_smoke_config("llama3-8b"), 4)
    _check_extrapolation(cfg, SMALL["prefill_32k"], "prefill_32k")


def test_depth_extrapolation_matches_full_run_hybrid():
    cfg = dryrun.depth_cut(get_smoke_config("zamba2-2.7b"), 3)
    assert dryrun.depth_periods(cfg) == 3
    _check_extrapolation(cfg, SMALL["decode_32k"], "decode_32k")


@pytest.mark.slow
def test_microbatch_extrapolation_matches_full_run():
    """4 layers x 4 microbatches of 16, from 1-2 layers x 2-3
    microbatches."""
    cfg = dryrun.depth_cut(get_smoke_config("llama3-8b"), 4)
    shape = ShapeConfig("train_4k", 32, 64, "train")
    _check_extrapolation(cfg, shape, "train_4k", full_micro=4)


def test_main_writes_json_and_reports_failures(tmp_path, monkeypatch,
                                                capsys):
    """One combination through ``main`` (its JSON on disk, with the
    modelled constants), then a failing one: listed under FAILURES:,
    exit 1."""
    smoke = {a: get_smoke_config(a) for a in ARCH_IDS}
    monkeypatch.setattr(dryrun, "get_config", smoke.__getitem__)
    monkeypatch.setattr(dryrun, "get_shape", SMALL.__getitem__)
    monkeypatch.setattr(dryrun, "production_mesh_shape",
                        lambda multi_pod=False: MESHES["2x4"])
    dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "llama3-8b_decode_32k_pod.json")
                     .read_text())
    assert rec["chips"] == 8 and rec["phase"] == "decode"
    assert "not measured" in rec["roofline"]["constants"]["source"]
    assert rec["flops_per_device"] > 0
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    assert "FAILURES:" in capsys.readouterr().out


def test_moe_ep_dtensor_entry_matches_local_entry():
    """``moe_apply_ep``'s DTensor entry (the dry run's opt 2), with the
    layer's params placed by the sharding rules, against its plain entry
    on a one-rank (1, 1) mesh, where every collective is the identity:
    the same values, bitwise."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from repro_torch.distributed import make_shardings, param_specs
    from repro_torch.distributed.moe_ep import moe_apply_ep
    from repro_torch.models import Model
    from repro_torch.models.transformer import layer_params

    cfg = get_smoke_config("qwen2-moe-a2.7b")
    shape = debug_mesh_shape(1, 1)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 8, cfg.d_model, generator=gen)
    valid = torch.arange(8)[None] < torch.tensor([8, 5])[:, None]
    with dryrun.device_mesh(shape) as mesh:
        placed = dryrun._map2(
            lambda t, pl: distribute_tensor(t, mesh, list(pl)), params,
            make_shardings(shape, param_specs(shape, params)))
        y0, a0 = moe_apply_ep(layer_params(params["blocks"], 0)["moe"], x,
                              cfg, mesh, valid)
        y1, a1 = moe_apply_ep(layer_params(placed["blocks"], 0)["moe"],
                              distribute_tensor(x, mesh, [Replicate()] * 2),
                              cfg, mesh, valid)
    assert isinstance(y1, DTensor) and isinstance(a1, DTensor)
    assert torch.equal(y1.to_local(), y0)
    assert torch.equal(a1.to_local(), a0)


def test_the_fake_group_lives_only_inside_the_block():
    """The dry run's fake default group is up inside ``device_mesh`` and
    gone after it, also when the block raises, so a later test of the
    process can make a group of its own; inside another default group it
    refuses to start."""
    import torch.distributed as dist
    shape = debug_mesh_shape(2, 2)
    with dryrun.device_mesh(shape) as mesh:
        assert dist.is_initialized() and dist.get_world_size() == 4
        assert tuple(mesh.shape) == (2, 2)
        with pytest.raises(RuntimeError, match="no default group"):
            with dryrun.device_mesh(shape):
                pass
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with dryrun.device_mesh(shape):
            raise ValueError
    assert not dist.is_initialized()
