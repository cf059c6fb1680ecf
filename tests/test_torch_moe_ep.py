"""The port's expert-parallel MoE against ``moe_apply`` and the JAX
reference (CPU, f32, spawned gloo groups).

The cases of the reference's ``tests/test_moe_ep.py``, with
``CAPACITY_FACTOR = 8.0`` (nothing drops), run on one spawned 4-rank
gloo group:

- ``div``: the smoke qwen2-moe layer (4 experts, 1 shared, top-2) on a
  (2, 2) ``("data", "model")`` mesh, experts divisible;
- ``pad``: 6 experts on a (1, 4) mesh (2 pad experts, the last rank's
  both) with a ragged ``valid``;
- both with gradients of ``sum(y**2) + aux``: each rank's loss is
  ``n_data * sum(y_shard**2) + aux``, so the mean over data shards is
  the global loss, and each leaf's gradient averaged over the data axis
  (a rank's own expert rows, the replicated leaves' whole) must equal
  the gradient of ``moe_apply`` on all the tokens;
- ``model``: one smoke qwen2-moe ``Model.loss`` with ``moe_ep_mesh`` on
  the (2, 2) mesh, each rank on its data shard of the batch, and on a
  (1, 4) mesh (``model_tp``); the mean of the shards' losses against
  the plain ``Model.loss`` (on the whole batch for (1, 4); the mean of
  its losses on the data shards for (2, 2), since the aux loss's load
  statistics are per shard), and the gradients averaged over the data
  axis against its gradients.

y and aux within 1e-5 of the port's ``moe_apply`` and of the reference's
on the same weights (``bridge.from_numpy``), gradients within 1e-4 (also
against ``jax.grad`` of the reference's ``moe_apply``), the loss within
1e-5. Each model rank of a data shard must hold the same outputs and the
same replicated-leaf gradients, and zero gradients on the expert rows it
does not own. The group runs once (module fixture) under a timeout; it is
in the slow tier, as the reference's EP test is.
"""
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.models.moe as jmoe
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import Model as JModel
from repro_torch.bridge import from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import Model
from repro_torch.models import moe as tmoe
from test_torch_sharding import init_group, run_ranks

torch.set_num_threads(1)
CAPACITY_FACTOR = 8.0
TOL, GRAD_TOL = 1e-5, 1e-4
WORLD = 4
MESHES = {"div": (2, 2), "pad": (1, 4), "model": (2, 2), "model_tp": (1, 4)}


def _pad_cfg(cls, moe_cls):
    return cls(name="padtest", kind="moe", num_layers=2, d_model=64,
               num_heads=4, num_kv_heads=4, d_ff=32, vocab_size=128,
               moe=moe_cls(num_experts=6, num_shared_experts=1, top_k=2,
                           d_expert=32))


def _torch_cfg(case):
    if case == "pad":
        return _pad_cfg(ModelConfig, MoEConfig)
    return get_smoke_config("qwen2-moe-a2.7b")


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"|".join(path): tree}


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        *head, last = key.split("|")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _inputs():
    """numpy weights (the reference's init) and inputs of every case."""
    rng = np.random.default_rng(0)
    out = {}
    jcfg = j_smoke("qwen2-moe-a2.7b")
    layer = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    out["div"] = dict(params=jax.tree.map(np.asarray, layer),
                      x=(rng.normal(size=(4, 16, jcfg.d_model)) * 0.3
                         ).astype(np.float32), valid=None)
    pcfg = _pad_cfg(JModelConfig, JMoEConfig)
    layer = jmoe.init_moe(jax.random.PRNGKey(2), pcfg, jnp.float32)
    out["pad"] = dict(params=jax.tree.map(np.asarray, layer),
                      x=(rng.normal(size=(4, 8, pcfg.d_model)) * 0.3
                         ).astype(np.float32),
                      valid=np.arange(8)[None] < np.array([8, 4, 8, 2])[:, None])
    params = JModel(jcfg).init(jax.random.PRNGKey(1))
    out["model"] = dict(
        params=jax.tree.map(np.asarray, params),
        tokens=rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32),
        labels=rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32))
    out["model_tp"] = out["model"]
    return out


def _save_inputs(path, inputs):
    arrays = {}
    for case, d in inputs.items():
        for k, v in _flat(d["params"]).items():
            arrays[f"{case}/params|{k}"] = v
        for k in ("x", "valid", "tokens", "labels"):
            if d.get(k) is not None:
                arrays[f"{case}/{k}"] = d[k]
    np.savez(path, **arrays)


def _load_case(data, case):
    pre = f"{case}/"
    flat = {k[len(pre):]: torch.from_numpy(data[k]) for k in data.files
            if k.startswith(pre)}
    params = _unflat({k[len("params|"):]: v for k, v in flat.items()
                      if k.startswith("params|")})
    return params, {k: v for k, v in flat.items() if "|" not in k}


def _worker(rank, world, store_path, inputs_path, out_dir):
    from repro_torch.distributed.moe_ep import moe_apply_ep
    from repro_torch.launch.mesh import make_debug_mesh
    init_group(rank, world, store_path)
    tmoe.CAPACITY_FACTOR = CAPACITY_FACTOR
    try:
        data = np.load(inputs_path)
        res = {}
        for case, (dp, tp) in MESHES.items():
            mesh = make_debug_mesh(dp, tp, device_type="cpu")
            dc, mc = mesh.get_coordinate()
            res[f"{case}/coord"] = np.array([dc, mc])
            params, arr = _load_case(data, case)
            for v in _flat(params).values():
                v.requires_grad_(True)
            cfg = _torch_cfg(case)
            if case.startswith("model"):
                b = arr["tokens"].shape[0] // dp
                rows = slice(dc * b, (dc + 1) * b)
                model = Model(cfg, device="cpu", moe_ep_mesh=mesh)
                loss = model.loss(params, {"tokens": arr["tokens"][rows],
                                           "labels": arr["labels"][rows]})
                res[f"{case}/loss"] = loss.detach().numpy()
            else:
                b = arr["x"].shape[0] // dp
                rows = slice(dc * b, (dc + 1) * b)
                valid = arr.get("valid")
                y, aux = moe_apply_ep(params, arr["x"][rows], cfg, mesh,
                                      valid=None if valid is None
                                      else valid[rows])
                res[f"{case}/y"] = y.detach().numpy()
                res[f"{case}/aux"] = aux.detach().numpy()
                loss = dp * torch.sum(y ** 2) + aux
            loss.backward()
            for k, v in _flat(params).items():
                res[f"{case}/grad|{k}"] = v.grad.numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    inputs = _inputs()
    _save_inputs(tmp / "inputs.npz", inputs)
    run_ranks(_worker, WORLD, tmp, str(tmp / "inputs.npz"), str(tmp))
    return inputs, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


@contextlib.contextmanager
def _no_drop():
    """Both packages' capacity factor at CAPACITY_FACTOR for the
    duration."""
    old = (jmoe.CAPACITY_FACTOR, tmoe.CAPACITY_FACTOR)
    jmoe.CAPACITY_FACTOR = tmoe.CAPACITY_FACTOR = CAPACITY_FACTOR
    try:
        yield
    finally:
        jmoe.CAPACITY_FACTOR, tmoe.CAPACITY_FACTOR = old


@pytest.fixture
def capacity_factor():
    with _no_drop():
        yield


@pytest.fixture(scope="module")
def layers(ranks):
    """{case: {"port": ..., "reference": ...}}: (y, aux, gradients) of
    the port's and the reference's moe_apply on all the tokens."""
    inputs, _ = ranks
    with _no_drop():
        return {case: {"port": _plain_layer(inputs, case),
                       "reference": _reference_layer(inputs, case)}
                for case in ("div", "pad")}


def _by_coord(results, case):
    return {tuple(int(c) for c in r[f"{case}/coord"]): r for r in results}


def _mean_over_data(ranks_, case, key, dp, tp):
    """Per model rank: the rank gradients of `key` averaged over data."""
    return [np.mean([ranks_[(d, m)][f"{case}/grad|{key}"]
                     for d in range(dp)], axis=0) for m in range(tp)]


def _assemble_grads(results, case, params):
    """The EP gradients as one tree: replicated leaves averaged over data
    (equal on every model rank), expert stacks from each model rank's
    own rows (zero elsewhere)."""
    dp, tp = MESHES[case]
    by = _by_coord(results, case)
    out = {}
    for key, leaf in _flat(params).items():
        per_model = _mean_over_data(by, case, key, dp, tp)
        if "experts|" in key:       # (..., E, d, f): experts on axis -3
            e = leaf.shape[-3]
            e_local = -(-e // tp)
            full = np.zeros_like(per_model[0])
            for m, g in enumerate(per_model):
                own = slice(m * e_local, min((m + 1) * e_local, e))
                rest = np.ones(e, bool)
                rest[own] = False
                assert not np.any(g[..., rest, :, :]), (case, key, m)
                full[..., own, :, :] = g[..., own, :, :]
            out[key] = full
        else:
            for g in per_model[1:]:
                np.testing.assert_allclose(g, per_model[0], rtol=0,
                                           atol=1e-7, err_msg=key)
            out[key] = per_model[0]
    return out


def _plain_layer(inputs, case):
    """The port's moe_apply on all tokens: y, aux and its gradients."""
    d = inputs[case]
    params = from_numpy(d["params"], device="cpu")
    for v in _flat(params).values():
        v.requires_grad_(True)
    valid = None if d["valid"] is None else torch.from_numpy(d["valid"])
    y, aux = tmoe.moe_apply(params, torch.from_numpy(d["x"]),
                            _torch_cfg(case), valid=valid)
    (torch.sum(y ** 2) + aux).backward()
    return (y.detach().numpy(), aux.item(),
            {k: v.grad.numpy() for k, v in _flat(params).items()})


def _reference_layer(inputs, case):
    d = inputs[case]
    cfg = j_smoke("qwen2-moe-a2.7b") if case == "div" else \
        _pad_cfg(JModelConfig, JMoEConfig)
    valid = None if d["valid"] is None else jnp.asarray(d["valid"])
    x = jnp.asarray(d["x"])

    def loss(p):
        y, aux = jmoe.moe_apply(p, x, cfg, valid=valid)
        return jnp.sum(y ** 2) + aux, (y, aux)

    p = jax.tree.map(jnp.asarray, d["params"])
    (_, (y, aux)), g = jax.value_and_grad(loss, has_aux=True)(p)
    return np.asarray(y), float(aux), {k: np.asarray(v)
                                       for k, v in _flat(g).items()}


def _ep_outputs(results, case):
    dp, tp = MESHES[case]
    by = _by_coord(results, case)
    for d in range(dp):
        for m in range(1, tp):
            np.testing.assert_array_equal(by[(d, m)][f"{case}/y"],
                                          by[(d, 0)][f"{case}/y"])
    auxes = {float(r[f"{case}/aux"]) for r in results}
    assert len(auxes) == 1, auxes
    y = np.concatenate([by[(d, 0)][f"{case}/y"] for d in range(dp)])
    return y, auxes.pop()


@pytest.mark.slow
@pytest.mark.parametrize("case", ["div", "pad"])
def test_ep_forward_equals_moe_apply(ranks, layers, case):
    y, aux = _ep_outputs(ranks[1], case)
    for name, (y_want, aux_want, _) in layers[case].items():
        assert np.max(np.abs(y - y_want)) < TOL, name
        assert abs(aux - aux_want) < TOL, name


@pytest.mark.slow
@pytest.mark.parametrize("case", ["div", "pad"])
def test_ep_gradients_equal_moe_apply(ranks, layers, case):
    inputs, results = ranks
    got = _assemble_grads(results, case, inputs[case]["params"])
    for name, (_, _, want) in layers[case].items():
        assert got.keys() == want.keys()
        for k in want:
            err = np.max(np.abs(got[k] - want[k]))
            assert err < GRAD_TOL, (name, k, err)


def _plain_model(d, dp):
    """The plain Model.loss on each of dp data shards of the batch: the
    mean of the losses and of the gradients."""
    model = Model(get_smoke_config("qwen2-moe-a2.7b"), device="cpu")
    b = d["tokens"].shape[0] // dp
    losses, grads = [], []
    for dc in range(dp):
        params = from_numpy(d["params"], device="cpu")
        for v in _flat(params).values():
            v.requires_grad_(True)
        rows = slice(dc * b, (dc + 1) * b)
        loss = model.loss(params, {
            "tokens": torch.from_numpy(d["tokens"][rows]),
            "labels": torch.from_numpy(d["labels"][rows])})
        loss.backward()
        losses.append(loss.item())
        grads.append({k: v.grad.numpy() for k, v in _flat(params).items()})
    return np.mean(losses), {k: np.mean([g[k] for g in grads], axis=0)
                             for k in grads[0]}


@pytest.mark.slow
@pytest.mark.parametrize("case", ["model", "model_tp"])
def test_ep_model_loss_equals_plain(ranks, capacity_factor, case):
    """The aux loss's load statistics are per data shard (averaged over
    the shards, as the reference's pmean), so the plain counterpart of a
    (2, 2) mesh is the mean of the plain loss on each data shard; on the
    (1, 4) mesh it is the plain loss of the whole batch."""
    inputs, results = ranks
    d = inputs[case]
    dp, _ = MESHES[case]
    by = _by_coord(results, case)
    for (dc, mc), r in by.items():
        assert float(r[f"{case}/loss"]) == float(by[(dc, 0)][f"{case}/loss"])
    ep_loss = np.mean([float(by[(dc, 0)][f"{case}/loss"])
                       for dc in range(dp)])
    loss, want = _plain_model(d, dp)
    assert abs(ep_loss - loss) < TOL
    got = _assemble_grads(results, case, d["params"])
    assert got.keys() == want.keys()
    for k in want:
        err = np.max(np.abs(got[k] - want[k]))
        assert err < GRAD_TOL, (k, err)


def test_ep_on_one_rank_is_moe_apply(tmp_path, capacity_factor):
    """On a (1, 1) mesh nothing is split: moe_apply_ep is bitwise
    moe_apply (the same routing, buffer and combine order), y, aux and
    gradients."""
    from repro_torch.distributed.moe_ep import moe_apply_ep
    from repro_torch.launch.mesh import make_debug_mesh
    inputs = _inputs()
    cfg = _torch_cfg("pad")
    valid = torch.from_numpy(inputs["pad"]["valid"])
    x = torch.from_numpy(inputs["pad"]["x"])
    init_group(0, 1, str(tmp_path / "store"))
    try:
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        outs = []
        for ep in (False, True):
            p = from_numpy(inputs["pad"]["params"], device="cpu")
            for v in _flat(p).values():
                v.requires_grad_(True)
            y, aux = (moe_apply_ep(p, x, cfg, mesh, valid=valid) if ep
                      else tmoe.moe_apply(p, x, cfg, valid=valid))
            (torch.sum(y ** 2) + aux).backward()
            outs.append((y, aux, {k: v.grad for k, v in _flat(p).items()}))
    finally:
        dist.destroy_process_group()
    (y0, a0, g0), (y1, a1, g1) = outs
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
