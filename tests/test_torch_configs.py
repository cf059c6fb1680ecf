"""The port's four remaining dense configs against the JAX reference (CPU, f32).

``qwen1.5-4b`` (QKV bias), ``granite-3-2b`` (tied embeddings, GQA 8/2),
``opt-66b`` (non-gated GeLU MLP) and ``llama3-405b`` at their smoke sizes
(2 layers, d 256): bridged weights go through ``repro.models.Model(cfg,
impl="ref")`` and ``repro_torch.models.Model``, prefill over right-padded
rows with ``lengths`` and one decode step over the contiguous cache.
``opt-66b``'s smoke config keeps the default ``gated_mlp=True``, so both
sides replace it with ``False``: the GeLU branch is what makes it a
variant. Tolerance: 1e-4 absolute on logits and caches, as the llama3
model test.

Also: ``bridge.init_params`` (the seeded weights the port's entry points
build) gives the same parameter tree, leaf for leaf in shape, as the
reference's initialiser, and each variant's own leaves are there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import Model as JModel
from repro_torch.bridge import from_numpy, init_params
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import Model

torch.set_num_threads(1)
TOL = 1e-4
S = 40                                    # cache depth
LENS = np.array([17, 30, 6], np.int32)    # right-padded rows
SEQ = 32                                  # padded prompt bucket
ARCHS = ["qwen1.5-4b", "granite-3-2b", "opt-66b", "llama3-405b"]


def _cfgs(arch):
    jc, tc = j_smoke(arch), get_smoke_config(arch)
    if arch == "opt-66b":
        jc = dataclasses.replace(jc, gated_mlp=False)
        tc = dataclasses.replace(tc, gated_mlp=False)
    return jc, tc


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b):
    np.testing.assert_allclose(_np(a), _np(b), atol=TOL, rtol=0)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    from repro.configs import get_config as j_config
    assert arch in ARCH_IDS
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(j_smoke(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jm = JModel(jcfg, impl="ref")
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg, device="cpu")
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    tokens = np.zeros((len(LENS), SEQ), np.int32)
    for i, n in enumerate(LENS):
        tokens[i, :n] = rng.integers(0, jcfg.vocab_size, n)

    jlog, jc = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(tokens), "lengths": jnp.asarray(LENS)},
        jm.init_cache(len(LENS), S))
    tlog, tc = tm.prefill(
        tp, {"tokens": torch.from_numpy(tokens),
             "lengths": torch.from_numpy(LENS)},
        tm.init_cache(len(LENS), S))
    _close(tlog, jlog)
    for key in ("k", "v"):
        _close(tc[key], jc[key])

    nxt = rng.integers(0, jcfg.vocab_size, len(LENS)).astype(np.int32)
    jlog, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
    tlog, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
    _close(tlog, jlog)
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    np.testing.assert_array_equal(_np(tc["length"]), LENS + 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = JModel(jcfg, impl="ref").init(jax.random.PRNGKey(0))
    tp = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    want = _shapes(jax.tree.map(np.asarray, jp))
    got = _shapes(tp)
    assert got == want
    assert ("/lm_head/kernel" in got) != tcfg.tie_embeddings
    assert any(k.endswith("/attn/bq") for k in got) == tcfg.qkv_bias
    assert any(k.endswith("/mlp/gate") for k in got) == tcfg.gated_mlp
