"""``Model.loss`` and its gradients against the JAX reference, per kind.

Bridged weights of each family's smoke config (a few layers, narrow
widths) and one batch made with numpy (tokens, next-token labels with
some set to -1, frames for an encoder-decoder, patch embeddings for a
vlm, as ``tests/test_arch_smoke.py:make_batch``) go through
``jax.value_and_grad(Model.loss)`` and through the port's ``Model.loss``
differentiated by torch autograd (``training.value_and_grad``), on the CPU in f32. ``ce_chunk`` is
smaller than S, so several cross-entropy chunks run, and remat is on in
both, so every layer and chunk is checkpointed (``jax.checkpoint`` /
``torch.utils.checkpoint``). The reference's ssm and hybrid models use
their sequential scan (``scan_impl="ref"``), the port's CPU path.

Tolerances: the loss within rel 1e-5 and every gradient within atol 2e-5
/ rtol 2e-4 — ``tests/test_training.py:61-62``'s bounds for one train
step's params.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import Model as JModel
from repro_torch.bridge import from_numpy, to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.training import value_and_grad

torch.set_num_threads(1)
B, S, CE_CHUNK = 2, 16, 4
ARCHS = ["llama3-8b", "granite-3-2b", "qwen1.5-4b", "qwen2-moe-a2.7b",
         "falcon-mamba-7b", "zamba2-2.7b", "seamless-m4t-medium",
         "pixtral-12b"]
SCAN_KINDS = ("ssm", "hybrid")


def make_batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[0, :3] = -1
    labels[1, -1] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.kind in ("encdec", "audio"):
        batch["frames"] = (rng.normal(size=(B, S, cfg.d_model))
                           * 0.1).astype(np.float32)
    if cfg.kind == "vlm":
        batch["patch_embeds"] = (rng.normal(size=(B, 4, cfg.d_model))
                                 * 0.1).astype(np.float32)
    return batch


def _pairs(x, y, path=""):
    if isinstance(x, dict):
        for k in x:
            yield from _pairs(x[k], y[k], f"{path}/{k}")
    else:
        yield path, x, y


def port_loss_and_grads(arch, jp, batch, *, remat=True, ce_chunk=CE_CHUNK):
    tm = Model(get_smoke_config(arch), remat=remat, device="cpu")
    tm.loss = functools.partial(tm.loss, ce_chunk=ce_chunk)
    loss, grads = value_and_grad(
        tm, from_numpy(jax.tree.map(np.asarray, jp), device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), to_numpy(grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg = j_smoke(arch)
    jm = JModel(cfg, remat=True,
                **({"scan_impl": "ref"} if cfg.kind in SCAN_KINDS else {}))
    jp = jm.init(jax.random.PRNGKey(0))
    batch = make_batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, ce_chunk=CE_CHUNK)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = port_loss_and_grads(arch, jp, batch)
    assert tloss == pytest.approx(float(jloss), rel=1e-5)
    for path, a, e in _pairs(tgrads, jax.tree.map(np.asarray, jgrads)):
        np.testing.assert_allclose(a, e, atol=2e-5, rtol=2e-4, err_msg=path)
    if cfg.kind == "moe":
        # the load-balance loss is part of the objective and differentiable
        assert np.abs(tgrads["blocks"]["moe"]["router"]).max() > 0


def test_one_chunk_without_remat_equals_chunked_with_remat():
    """ce_chunk and remat change the schedule, not the value."""
    arch = "llama3-8b"
    jp = JModel(j_smoke(arch)).init(jax.random.PRNGKey(0))
    batch = make_batch(j_smoke(arch), seed=3)
    l1, g1 = port_loss_and_grads(arch, jp, batch, remat=False, ce_chunk=1024)
    l2, g2 = port_loss_and_grads(arch, jp, batch, remat=True, ce_chunk=4)
    assert l1 == pytest.approx(l2, rel=1e-6)
    for path, a, e in _pairs(g1, g2):
        np.testing.assert_allclose(a, e, atol=1e-6, rtol=1e-5, err_msg=path)
