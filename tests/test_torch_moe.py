"""The port's MoE layer and MoE models against the JAX reference (CPU, f32).

``repro_torch.models.moe`` against ``repro.models.moe`` on the same numpy
inputs and the same carried weights (``bridge.from_numpy``), at the
``qwen2-moe-a2.7b`` smoke size (4 routed experts, 1 shared, top-2):

- generous capacity (factor 16, nothing drops) equals an explicit dense
  top-k mixture and the reference, 1e-5 absolute;
- tight capacity (factor 0.25) drops exactly the reference's slots: the
  port's keep mask equals the mask the reference's arithmetic gives
  (integer equality), and the outputs agree to 1e-5;
- padding (``valid`` false) consumes no capacity: masked rows equal the
  unpadded call, as in the reference, and the port equals the reference
  on the padded call, including its off-range expert ids;
- the sequence-chunked form equals the global one when nothing drops,
  and the reference's chunked form;
- the load-balance loss equals the reference's, and a uniform router
  gives the Switch minimum (the coefficient).

Beyond the layer: ``bridge.init_params`` gives the reference's tree
(keys and shapes) for both MoE configs, and ``Model`` forward (prefill
with ``lengths``, chunked and not) and decode logits agree with the JAX
``Model`` to 1e-4 for the ``qwen2-moe-a2.7b`` and ``phi3.5-moe`` smoke
configs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.models import Model as JModel
from repro_torch.bridge import from_numpy, init_params
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import Model
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)
ARCH = "qwen2-moe-a2.7b"
ARCHS = ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"]
TOL = 1e-5          # the layer, f32
MODEL_TOL = 1e-4    # logits and caches, as the dense model tests


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def layer():
    jcfg = j_smoke(ARCH)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, get_smoke_config(ARCH), jp, tp


def _x(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 0.3
            ).astype(np.float32)


@pytest.fixture
def capacity_factor():
    """Set the capacity factor of both packages for one test."""
    old = (jmoe.CAPACITY_FACTOR, tmoe.CAPACITY_FACTOR)

    def set_(f):
        jmoe.CAPACITY_FACTOR = tmoe.CAPACITY_FACTOR = f
    yield set_
    jmoe.CAPACITY_FACTOR, tmoe.CAPACITY_FACTOR = old


def _both(layer, x, valid=None):
    jcfg, tcfg, jp, tp = layer
    yj, aj = jmoe.moe_apply(jp, jnp.asarray(x), jcfg,
                            valid=None if valid is None
                            else jnp.asarray(valid))
    yt, at = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg,
                            valid=None if valid is None
                            else torch.from_numpy(valid))
    return _np(yj), float(aj), _np(yt), float(at)


def _reference_keep(jp, x, cfg, valid=None):
    """The reference's capacity mask (`keep`), by its own arithmetic."""
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    xt = jnp.asarray(x).reshape(t, -1)
    probs = jax.nn.softmax((xt @ jp["router"]).astype(jnp.float32), -1)
    _, top_e = jax.lax.top_k(probs, m.top_k)
    if valid is not None:
        top_e = jnp.where(jnp.asarray(valid).reshape(t)[:, None], top_e,
                          m.num_experts)
    cap = min(int(jmoe.CAPACITY_FACTOR * t * m.top_k / m.num_experts) + 1, t)
    oh = jax.nn.one_hot(top_e, m.num_experts).reshape(t * m.top_k, -1)
    pos = jnp.sum((jnp.cumsum(oh, axis=0) - 1.0) * oh, axis=-1)
    return np.asarray(pos.astype(jnp.int32) < cap), cap


def test_moe_configs_match_reference():
    for arch in ARCHS:
        assert arch in ARCH_IDS
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(j_config(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(j_smoke(arch))


def test_generous_capacity_matches_dense_topk(layer, capacity_factor):
    capacity_factor(16.0)
    jcfg, tcfg, _, tp = layer
    x = _x((1, 16, jcfg.d_model), 2)
    yj, _, yt, _ = _both(layer, x)
    np.testing.assert_allclose(yt, yj, atol=TOL, rtol=0)
    # dense top-k mixture: every expert on every token, weighted
    xt = torch.from_numpy(x).reshape(-1, jcfg.d_model)
    probs = torch.softmax(xt @ tp["router"], -1)
    tw, te = torch.topk(probs, tcfg.moe.top_k)
    tw = tw / tw.sum(-1, keepdim=True)
    ref = torch.zeros_like(xt)
    ex = tp["experts"]
    for e in range(tcfg.moe.num_experts):
        h = torch.nn.functional.silu(xt @ ex["gate"][e]) * (xt @ ex["up"][e])
        w = torch.where(te == e, tw, 0.0).sum(-1)
        ref = ref + (h @ ex["down"][e]) * w[:, None]
    sh = tp["shared"]
    ref = ref + (torch.nn.functional.silu(xt @ sh["gate"]) * (xt @ sh["up"])
                 ) @ sh["down"]
    np.testing.assert_allclose(yt.reshape(-1, jcfg.d_model), _np(ref),
                               atol=1e-4, rtol=1e-4)


def test_tight_capacity_drops_the_reference_slots(layer, capacity_factor):
    capacity_factor(0.25)
    jcfg, tcfg, jp, tp = layer
    x = _x((2, 64, jcfg.d_model), 3)
    want, cap = _reference_keep(jp, x, jcfg)
    plan = tmoe.route(tp["router"], torch.from_numpy(x).reshape(128, -1),
                      tcfg)
    assert plan["cap"] == cap
    np.testing.assert_array_equal(_np(plan["keep"]), want)
    assert 0 < int((~want).sum()) < len(want), "the capacity must drop some"
    yj, _, yt, _ = _both(layer, x)
    assert np.isfinite(yt).all()
    np.testing.assert_allclose(yt, yj, atol=TOL, rtol=0)


def test_padding_consumes_no_capacity(layer):
    jcfg = layer[0]
    x = _x((1, 32, jcfg.d_model), 4)
    valid = np.arange(32)[None] < 16
    yj, _, yt, _ = _both(layer, x, valid)
    np.testing.assert_allclose(yt, yj, atol=TOL, rtol=0)
    _, _, y_short, _ = _both(layer, np.ascontiguousarray(x[:, :16]))
    np.testing.assert_allclose(yt[:, :16], y_short, atol=2e-4, rtol=2e-3)


def test_off_range_expert_ids_are_masked(layer, capacity_factor):
    """Padding tokens carry the off-range expert id E: no dispatch row,
    a clamped gather with weight 0 — the reference's result, no raise,
    at a capacity where real slots drop too."""
    capacity_factor(0.5)
    jcfg, tcfg, jp, tp = layer
    x = _x((2, 24, jcfg.d_model), 5)
    valid = np.arange(24)[None] < np.array([[24], [9]])
    plan = tmoe.route(tp["router"], torch.from_numpy(x).reshape(48, -1),
                      tcfg, valid=torch.from_numpy(valid))
    off = _np(plan["top_e"]) == tcfg.moe.num_experts
    assert off.sum() == 15 * tcfg.moe.top_k
    want, _ = _reference_keep(jp, x, jcfg, valid)
    np.testing.assert_array_equal(_np(plan["keep"]), want)
    yj, aj, yt, at = _both(layer, x, valid)
    np.testing.assert_allclose(yt, yj, atol=TOL, rtol=0)
    assert at == pytest.approx(aj, rel=1e-6)
    # a padding row gets the shared experts only
    xt = torch.from_numpy(x[1, 9:])
    sh = tp["shared"]
    shared = (torch.nn.functional.silu(xt @ sh["gate"]) * (xt @ sh["up"])
              ) @ sh["down"]
    np.testing.assert_allclose(yt[1, 9:], _np(shared), atol=TOL, rtol=0)


@pytest.mark.parametrize("seq,seed", [(8, 0), (24, 1), (40, 2), (64, 3)])
def test_chunked_equals_global_no_drop(layer, capacity_factor, seq, seed):
    capacity_factor(16.0)
    jcfg, tcfg, jp, tp = layer
    x = _x((1, seq, jcfg.d_model), 10 + seed)
    y1, _ = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    y2, a2 = tmoe.moe_apply_chunked(tp, torch.from_numpy(x), tcfg,
                                    seq_chunk=8)
    np.testing.assert_allclose(_np(y2), _np(y1), atol=1e-4, rtol=1e-3)
    yj, aj = jmoe.moe_apply_chunked(jp, jnp.asarray(x), jcfg, seq_chunk=8)
    np.testing.assert_allclose(_np(y2), _np(yj), atol=TOL, rtol=0)
    assert float(a2) == pytest.approx(float(aj), rel=1e-6)


def test_aux_loss_matches_reference(layer):
    jcfg, tcfg, jp, tp = layer
    x = _x((2, 64, jcfg.d_model), 6)
    _, aj, _, at = _both(layer, x)
    assert at > 0 and at == pytest.approx(aj, rel=1e-6)
    uniform = dict(tp, router=torch.zeros_like(tp["router"]))
    _, a_uniform = tmoe.moe_apply(uniform, torch.from_numpy(x), tcfg)
    assert float(a_uniform) == pytest.approx(
        tcfg.moe.router_aux_loss_coef, rel=0.05)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    jp = JModel(j_smoke(arch)).init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config(arch)
    tp = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    got = _shapes(tp)
    assert got == _shapes(jax.tree.map(np.asarray, jp))
    assert "/blocks/moe/router" in got and not any("/mlp/" in k for k in got)
    assert ("/blocks/moe/shared/gate" in got) == \
        bool(tcfg.moe.num_shared_experts)


@pytest.mark.parametrize("chunk", [0, 8], ids=["global", "chunked8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_and_decode_match_reference(arch, chunk):
    jcfg = j_smoke(arch)
    jm = JModel(jcfg, moe_seq_chunk=chunk)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config(arch), moe_seq_chunk=chunk, device="cpu")
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(1)
    lens = np.array([24, 10, 17], np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (3, 24)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)},
                        jm.init_cache(3, 40))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "lengths": torch.from_numpy(lens)},
                        tm.init_cache(3, 40))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=MODEL_TOL, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]),
                                   atol=MODEL_TOL, rtol=0)
    for _ in range(2):
        nxt = rng.integers(0, jcfg.vocab_size, 3).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=MODEL_TOL, rtol=0)
    np.testing.assert_array_equal(_np(tc["length"]), lens + 2)


def test_forward_aux_matches_reference():
    """The full-sequence forward's logits and summed aux loss."""
    jcfg = j_smoke(ARCH)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config(ARCH), device="cpu")
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    from repro_torch.models import transformer as tfm
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jl, ja = jm.forward_train(jp, {"tokens": jnp.asarray(toks)})
    tl, ta = tfm.forward(tp, tm.cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), atol=MODEL_TOL, rtol=0)
    assert float(ta) == pytest.approx(float(ja), rel=1e-5)
