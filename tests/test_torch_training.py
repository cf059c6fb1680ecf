"""The port's training (``repro_torch.training``) against the JAX
reference's (``repro.training``), on the CPU at smoke size.

The same inputs, made with numpy or bridged from the reference's
params and optimizer state (``bridge.opt_state_from_numpy``), go
through both: the learning-rate schedule, AdamW and the global norm
(allclose at 1e-6, the stacked norm scales decayed as the reference
decays them), the data pipeline (bitwise), checkpoints (a round trip,
and files each package writes restored bitwise by the other), and one
``build_train_step`` step on granite-3-2b smoke against
``jax.jit(build_train_step)``: loss within rel 1e-5, params and first
moments after the step within atol 2e-5 / rtol 2e-4 as
``tests/test_training.py:61-62``. Within the port: 4 microbatches equal
one batch and remat equals no remat (the reference's bounds), 50 steps
of llama3 smoke lower the loss by more than 1.0
(``tests/test_training.py::test_loss_decreases``), and the launcher runs
as a subprocess on the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import Model as JModel
from repro.training import OptimizerConfig as JOptimizerConfig
from repro.training import OptState as JOptState
from repro.training import build_train_step as j_build_train_step
from repro.training import init_train_state as j_init_train_state
from repro.training import optimizer as jopt
from repro.training import packed_batches as j_packed_batches
from repro.training import restore_checkpoint as j_restore
from repro.training import save_checkpoint as j_save
from repro_torch.bridge import (from_numpy, opt_state_from_numpy,
                                opt_state_to_numpy, to_numpy)
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.training import (OptimizerConfig, adamw_update,
                                  build_train_step, global_norm,
                                  init_opt_state, init_train_state,
                                  lr_schedule, packed_batches,
                                  restore_checkpoint, save_checkpoint)
from repro_torch.training.optimizer import leaves

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pairs(x, y, path=""):
    if isinstance(x, dict):
        for k in x:
            yield from _pairs(x[k], y[k], f"{path}/{k}")
    else:
        yield path, x, y


def _close_trees(a, b, atol, rtol):
    for path, x, y in _pairs(a, b):
        np.testing.assert_allclose(x, y, atol=atol, rtol=rtol, err_msg=path)


def _equal_trees(a, b):
    for path, x, y in _pairs(a, b):
        np.testing.assert_array_equal(x, y, err_msg=path)


def _reference_state(arch="granite-3-2b", seed=0):
    cfg = j_smoke(arch)
    jm = JModel(cfg)
    jp, jo = j_init_train_state(jm, jax.random.PRNGKey(seed))
    return cfg, jm, jp, jo


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---- optimizer -------------------------------------------------------------

def test_lr_schedule_matches_reference():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    for step in range(101):
        want = float(jopt.lr_schedule(JOptimizerConfig(**cfg),
                                      jnp.asarray(step)))
        got = float(lr_schedule(OptimizerConfig(**cfg), step))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_adamw_and_global_norm_match_reference():
    """Two AdamW steps from the same params, state and (numpy) gradients:
    params, moments, step, grad norm and lr at 1e-6. The second gradient
    is large enough to be clipped. Stacked norm scales (L, d) are decayed,
    as the reference's `p.ndim >= 2` decays them."""
    _, _, jp, jo = _reference_state()
    rng = np.random.default_rng(5)
    tp = from_numpy(_np_tree(jp), device="cpu")
    to = opt_state_from_numpy(_np_tree(jo), device="cpu")
    norm0 = to_numpy(tp)["blocks"]["attn_norm_scale"].copy()
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=1.0)
    for scale in (1e-3, 10.0):
        grads = jax.tree.map(
            lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32),
            _np_tree(jp))
        grads["blocks"]["attn_norm_scale"][:] = 0.0
        want_norm = float(jopt.global_norm(grads))
        jp, jo, jm = jopt.adamw_update(JOptimizerConfig(**ocfg), jp, grads,
                                       jo)
        assert float(global_norm(from_numpy(grads, device="cpu"))) == \
            pytest.approx(want_norm, rel=1e-6)
        tp, to, tm = adamw_update(OptimizerConfig(**ocfg), tp,
                                  from_numpy(grads, device="cpu"), to)
        assert float(tm["grad_norm"]) == pytest.approx(want_norm, rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    _close_trees(to_numpy(tp), _np_tree(jp), atol=1e-6, rtol=1e-6)
    got = opt_state_to_numpy(to)
    assert int(got.step) == int(jo.step) == 2
    _close_trees(got.mu, _np_tree(jo.mu), atol=1e-6, rtol=1e-6)
    _close_trees(got.nu, _np_tree(jo.nu), atol=1e-6, rtol=1e-6)
    decayed = to_numpy(tp)["blocks"]["attn_norm_scale"]
    assert (decayed < norm0).all()          # zero gradient, decay only


def test_init_opt_state_is_zero_f32():
    cfg = get_smoke_config("llama3-8b")
    params, opt = init_train_state(Model(cfg, device="cpu"),
                                   torch.Generator().manual_seed(0))
    assert int(opt.step) == 0 and opt.step.dtype == torch.int32
    for p, m, v in zip(leaves(params), leaves(opt.mu), leaves(opt.nu)):
        assert m.shape == p.shape and m.dtype == torch.float32
        assert not m.any() and not v.any()
    assert init_opt_state(params).mu.keys() == params.keys()


# ---- data and checkpoints --------------------------------------------------

def test_packed_batches_bitwise():
    ours = packed_batches(997, 4, 33, seed=3)
    ref = j_packed_batches(997, 4, 33, seed=3)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_round_trip(tmp_path):
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    params, opt = init_train_state(Model(cfg, device="cpu"),
                                   torch.Generator().manual_seed(0))
    opt.step.fill_(7)
    for m in leaves(opt.mu):
        m.normal_()
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, params, opt, step=7)
    p2, o2, step = restore_checkpoint(path, params, opt)
    assert step == 7 and int(o2.step) == 7
    _equal_trees(to_numpy(p2), to_numpy(params))
    _equal_trees(to_numpy(o2.mu), to_numpy(opt.mu))
    _equal_trees(to_numpy(o2.nu), to_numpy(opt.nu))
    p3, step = restore_checkpoint(path[:-4], params)
    assert step == 7
    _equal_trees(to_numpy(p3), to_numpy(params))


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-2.7b"])
def test_checkpoints_cross_packages(tmp_path, arch):
    """A file the reference writes restores into the port's params and
    OptState bitwise, and the other way round (zamba2: the hybrid tree's
    two layer axes)."""
    _, _, jp, jo = _reference_state(arch, seed=2)
    jo = JOptState(jnp.asarray(3, jnp.int32),
                   jax.tree.map(lambda m: m + 0.5, jo.mu),
                   jax.tree.map(lambda v: v + 0.25, jo.nu))
    j_save(str(tmp_path / "ref.npz"), jp, jo, step=3)
    tp, to, step = restore_checkpoint(
        str(tmp_path / "ref.npz"),
        from_numpy(jax.tree.map(np.zeros_like, _np_tree(jp)), device="cpu"),
        init_opt_state(from_numpy(_np_tree(jp), device="cpu")))
    assert step == 3 and int(to.step) == 3
    _equal_trees(to_numpy(tp), _np_tree(jp))
    _equal_trees(to_numpy(to.mu), _np_tree(jo.mu))
    _equal_trees(to_numpy(to.nu), _np_tree(jo.nu))
    save_checkpoint(str(tmp_path / "port.npz"), tp, to, step=4)
    jp2, jo2, step = j_restore(str(tmp_path / "port.npz"), jp, jo)
    assert step == 4 and int(jo2.step) == 3
    _equal_trees(_np_tree(jp2), _np_tree(jp))
    _equal_trees(_np_tree(jo2.nu), _np_tree(jo.nu))


# ---- the train step --------------------------------------------------------

def _granite_batch(cfg, b=4, s=32, seed=1):
    batch = next(j_packed_batches(cfg.vocab_size, b, s, seed=seed))
    batch["labels"][0, :5] = -1
    return batch


def test_train_step_matches_reference():
    cfg, jm, jp, jo = _reference_state()
    batch = _granite_batch(cfg)
    jstep = jax.jit(j_build_train_step(jm, JOptimizerConfig(**OPT)))
    jp2, jo2, jmet = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    tm = Model(get_smoke_config("granite-3-2b"), device="cpu")
    step = build_train_step(tm, OptimizerConfig(**OPT))
    assert tm.remat
    tp, to, tmet = step(from_numpy(_np_tree(jp), device="cpu"),
                        opt_state_from_numpy(_np_tree(jo), device="cpu"),
                        _torch_batch(batch))
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                rel=1e-5)
    assert float(tmet["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=1e-5)
    _close_trees(to_numpy(tp), _np_tree(jp2), atol=2e-5, rtol=2e-4)
    # mu = (1 - b1) g after one step: the clipped gradients
    _close_trees(to_numpy(to.mu), _np_tree(jo2.mu), atol=2e-5, rtol=2e-4)


def _port_step(arch, batch, **kw):
    tm = Model(get_smoke_config(arch), device="cpu")
    params, opt = init_train_state(tm, torch.Generator().manual_seed(0))
    step = build_train_step(tm, OptimizerConfig(**OPT), **kw)
    params, opt, met = step(params, opt, _torch_batch(batch))
    return params, opt, met


def test_microbatches_match_full_batch():
    cfg = get_smoke_config("granite-3-2b")
    batch = next(packed_batches(cfg.vocab_size, 8, 32, seed=1))
    p1, o1, m1 = _port_step("granite-3-2b", batch, microbatches=1,
                            remat=False)
    p4, o4, m4 = _port_step("granite-3-2b", batch, microbatches=4,
                            remat=False)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    _close_trees(to_numpy(p1), to_numpy(p4), atol=2e-5, rtol=2e-4)
    _close_trees(to_numpy(o1.mu), to_numpy(o4.mu), atol=2e-5, rtol=2e-4)


def test_remat_matches_no_remat():
    cfg = get_smoke_config("llama3-8b")
    batch = next(packed_batches(cfg.vocab_size, 4, 32, seed=2))
    pa, oa, ma = _port_step("llama3-8b", batch, remat=False)
    pb, ob, mb = _port_step("llama3-8b", batch, remat=True)
    assert float(ma["loss"]) == pytest.approx(float(mb["loss"]), rel=1e-6)
    _close_trees(to_numpy(oa.mu), to_numpy(ob.mu), atol=1e-5, rtol=1e-4)
    _close_trees(to_numpy(pa), to_numpy(pb), atol=1e-5, rtol=1e-4)


def test_train_step_leaves_params_without_grad():
    """The step differentiates detached views, so the caller's params
    never require grad (the kernels without a backward refuse inputs
    that do) and are updated in place."""
    cfg = get_smoke_config("llama3-8b")
    tm = Model(cfg, device="cpu")
    params, opt = init_train_state(tm, torch.Generator().manual_seed(0))
    wq = params["blocks"]["attn"]["wq"]
    before = wq.clone()
    step = build_train_step(tm, OptimizerConfig(**OPT))
    batch = next(packed_batches(cfg.vocab_size, 2, 16, seed=0))
    params2, _, _ = step(params, opt, _torch_batch(batch))
    assert params2["blocks"]["attn"]["wq"] is wq
    assert not wq.requires_grad and not torch.equal(wq, before)
    assert int(opt.step) == 1


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_scan_families_train_on_cpu(arch):
    """ssm and hybrid train on the CPU (the plain scan) from the port's
    own init; every leaf, stacked A_log included, takes the in-place
    AdamW update."""
    cfg = get_smoke_config(arch)
    params, opt, met = _port_step(
        arch, next(packed_batches(cfg.vocab_size, 2, 16, seed=0)))
    assert np.isfinite(float(met["loss"])) and int(opt.step) == 1
    for m in leaves(opt.mu):
        assert torch.isfinite(m).all()


def test_loss_decreases():
    cfg = get_smoke_config("llama3-8b")
    tm = Model(cfg, device="cpu")
    params, opt = init_train_state(tm, torch.Generator().manual_seed(0))
    step = build_train_step(tm, OptimizerConfig(lr=1e-3, warmup_steps=5,
                                                total_steps=50))
    it = packed_batches(cfg.vocab_size, 8, 64, seed=0)
    losses = []
    for _ in range(50):
        params, opt, met = step(params, opt, _torch_batch(next(it)))
        losses.append(float(met["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 1.0


def test_launcher_runs_on_cpu(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    ck = tmp_path / "ck.npz"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "3", "--batch", "2", "--seq", "32", "--log-every", "1",
         "--device", "cpu", "--checkpoint", str(ck)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 3 and "device=cpu" in res.stdout
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines)
    assert int(np.load(ck)["__step__"]) == 3
