"""Weight bridge between the JAX reference and the port (CPU).

The JAX params pytree (as numpy) round-trips through the port's dict of
tensors exactly, and the port's own ``init_params`` builds the same tree
(paths, shapes, dtypes) as the reference's init, with the reference's
scales.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import Model as JModel
from repro_torch import bridge
from repro_torch.configs import get_smoke_config

torch.set_num_threads(1)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def jax_params():
    cfg = j_smoke("llama3-8b")
    return jax.tree.map(np.asarray, JModel(cfg).init(jax.random.PRNGKey(0)))


def test_round_trip_is_exact(jax_params):
    tparams = bridge.from_numpy(jax_params, device="cpu")
    back = bridge.to_numpy(tparams)
    a, b = dict(_paths(jax_params)), dict(_paths(back))
    assert a.keys() == b.keys()
    for path in a:
        assert a[path].dtype == b[path].dtype, path
        np.testing.assert_array_equal(a[path], b[path], err_msg=str(path))


def test_bf16_bridge_rounds_only():
    x = {"w": np.linspace(-3, 3, 64, dtype=np.float32).reshape(8, 8)}
    t = bridge.from_numpy(x, device="cpu", dtype=torch.bfloat16)
    assert t["w"].dtype == torch.bfloat16
    back = bridge.to_numpy(t)["w"]
    np.testing.assert_allclose(back, x["w"], rtol=2 ** -8)


def test_init_params_matches_reference_tree(jax_params):
    cfg = get_smoke_config("llama3-8b")
    tparams = bridge.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    a = {p: x.shape for p, x in _paths(jax_params)}
    b = {p: tuple(x.shape) for p, x in _paths(tparams)}
    assert a == b
    for p, x in _paths(tparams):
        assert x.dtype == torch.float32, p
    # the reference's scales: embed std 1, projections std 0.02, norms 1
    assert abs(float(tparams["embed"]["table"].std()) - 1.0) < 0.05
    assert abs(float(tparams["blocks"]["attn"]["wq"].std()) - 0.02) < 0.002
    assert torch.equal(tparams["blocks"]["attn_norm_scale"],
                       torch.ones_like(tparams["blocks"]["attn_norm_scale"]))
    # seeded: the same generator seed gives the same weights
    again = bridge.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    assert torch.equal(again["blocks"]["mlp"]["gate"],
                       tparams["blocks"]["mlp"]["gate"])


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.from_numpy({"w": np.zeros(2, np.float32)})
