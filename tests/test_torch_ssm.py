"""The port's Mamba-1 path against the JAX reference (CPU, f32).

The same numpy inputs go through the reference and the port:

- the plain selective scan against the reference's Pallas kernel (interpret
  mode) and its sequential oracle, at the reference's own Pallas-vs-ref
  bound (max error / max |y| < 1e-5, ``tests/test_kernels.py:120``);
- the plain scan with state against ``ssm._scan_with_state`` (y and h);
- the decode-step recurrence and ``mamba1_decode``;
- ``mamba1_apply`` against the reference's apply with ``impl="pallas"``, so
  the kernel's own JAX counterpart is held;
- ``mamba1_prefill`` with right-padded rows, including lengths shorter
  than d_conv - 1 (``_gather_last``'s zero fill);
- the falcon-mamba smoke ``Model``: prefill logits, ``ssm_h`` /
  ``ssm_conv`` and decode steps under bridged weights, at the f32
  tolerance of ``tests/test_torch_model.py`` (1e-4 absolute).

Also: the scan dispatch sends CPU tensors to the plain versions, the CUDA
wrapper refuses CPU tensors, the cache helpers work on a cache without
``k`` and the port's ``init_params`` builds the reference's SSM tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels import ref as jref
from repro.kernels.selective_scan import selective_scan as j_pallas_scan
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.bridge import from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import cuda as tcuda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import Model
from repro_torch.models import cache as tcache
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.models.transformer import layer_params

torch.set_num_threads(1)
REL = 1e-5       # scan, relative to max |y|: tests/test_kernels.py:120
TOL = 1e-4       # model, absolute: tests/test_torch_model.py
S = 40           # cache depth
SEQ = 24         # padded prompt bucket
LENS = np.array([24, 13, 2, 1], np.int32)   # two rows under d_conv - 1


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=0)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-6))


def _scan_inputs(seed, b, s, d, n):
    """x, dt (softplus'd), A (negative), B, C, D as the reference's
    kernel sweep draws them, from numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(b, s, d)).astype(f)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, d)) - 1)).astype(f)
    A = -np.exp(rng.normal(size=(d, n)) * 0.5).astype(f)
    B = rng.normal(size=(b, s, n)).astype(f)
    C = rng.normal(size=(b, s, n)).astype(f)
    D = np.full((d,), 0.3, f)
    return x, dt, A, B, C, D


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

def test_plain_scan_matches_pallas_and_oracle():
    args = _scan_inputs(0, 1, 128, 64, 16)
    ja = [jnp.asarray(a) for a in args]
    pallas = j_pallas_scan(*ja, chunk=64, block_d=64, interpret=True)
    oracle = jref.selective_scan_ref(*ja)
    out = tref.selective_scan_ref(*[_t(a) for a in args])
    assert out.dtype == torch.float32 and out.shape == (1, 128, 64)
    assert _rel(out, pallas) < REL
    assert _rel(out, oracle) < REL


def test_plain_scan_with_state_matches_reference():
    args = _scan_inputs(1, 2, 50, 40, 8)        # ragged S and D
    y_j, h_j = jssm._scan_with_state(*[jnp.asarray(a) for a in args],
                                     None, None)
    y, h = tref.selective_scan_with_state_ref(*[_t(a) for a in args])
    assert h.dtype == torch.float32 and h.shape == (2, 40, 8)
    assert _rel(y, y_j) < REL
    assert _rel(h, h_j) < REL
    # the y-only form is the same computation
    assert torch.equal(tref.selective_scan_ref(*[_t(a) for a in args]), y)


def test_plain_step_matches_reference():
    x, dt, A, B, C, D = _scan_inputs(2, 3, 1, 32, 16)
    h0 = np.random.default_rng(3).normal(size=(3, 32, 16)).astype(np.float32)
    step = (h0, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D)
    hj, yj = jref.selective_scan_step_ref(*[jnp.asarray(a) for a in step])
    ht, yt = tops.selective_scan_step(*[_t(a) for a in step])
    assert _rel(ht, hj) < REL
    assert _rel(yt, yj) < REL


def test_scan_dispatch_sends_cpu_tensors_to_plain_versions():
    args = [_t(a) for a in _scan_inputs(4, 2, 16, 32, 16)]
    tcuda.reset_launches()
    assert torch.equal(tops.selective_scan(*args),
                       tref.selective_scan_ref(*args))
    y, h = tops.selective_scan_with_state(*args)
    y_r, h_r = tref.selective_scan_with_state_ref(*args)
    assert torch.equal(y, y_r) and torch.equal(h, h_r)
    assert all(n == 0 for n in tcuda.launches.values())


def test_scan_cuda_wrapper_refuses_cpu_tensors():
    """No silent fallback: the scan kernel's wrapper takes CUDA tensors
    only, and refuses a state size it has no instantiation for."""
    args = [_t(a) for a in _scan_inputs(5, 1, 8, 32, 16)]
    with pytest.raises(ValueError, match="CUDA"):
        tcuda.selective_scan(*args)
    with pytest.raises(ValueError, match="CUDA"):
        tcuda.selective_scan(*args, return_state=True)
    odd = [_t(a) for a in _scan_inputs(5, 1, 8, 32, 12)]
    with pytest.raises(ValueError, match="d_state"):
        tcuda.selective_scan(*odd)
    assert tcuda.launches["selective_scan"] == 0


# ---------------------------------------------------------------------------
# the Mamba-1 block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = j_smoke("falcon-mamba-7b")
    jm = JModel(cfg, impl="ref")
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config("falcon-mamba-7b"), device="cpu")
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jl = jax.tree.map(lambda t: t[0], jp["blocks"]["mamba"])
    tl = layer_params(tp["blocks"]["mamba"], 0)
    rng = np.random.default_rng(0)
    tokens = np.zeros((len(LENS), SEQ), np.int32)
    for i, n in enumerate(LENS):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)
    jlog, jc = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(tokens), "lengths": jnp.asarray(LENS)},
        jm.init_cache(len(LENS), S, dtype=jnp.float32))
    tlog, tc = tm.prefill(tp, {"tokens": _t(tokens), "lengths": _t(LENS)},
                          tm.init_cache(len(LENS), S))
    return dict(cfg=cfg, jm=jm, jp=jp, tm=tm, tp=tp, jl=jl, tl=tl,
                tokens=tokens, jlog=jlog, jc=jc, tlog=tlog, tc=tc)


def _x(cfg, seed, *shape):
    return (np.random.default_rng(seed).normal(size=(*shape, cfg.d_model))
            * 0.5).astype(np.float32)


def test_mamba1_apply_matches_pallas_path(setup):
    s = setup
    x = _x(s["cfg"], 10, 2, SEQ)
    expect = jssm.mamba1_apply(s["jl"], jnp.asarray(x), s["cfg"],
                               impl="pallas")
    out = tssm.mamba1_apply(s["tl"], _t(x), s["tm"].cfg)
    _close(out, expect)


def test_mamba1_prefill_matches_reference(setup):
    s = setup
    x = _x(s["cfg"], 11, len(LENS), SEQ)
    yj, stj = jssm.mamba1_prefill(s["jl"], jnp.asarray(x), s["cfg"],
                                  jnp.asarray(LENS))
    yt, stt = tssm.mamba1_prefill(s["tl"], _t(x), s["tm"].cfg, _t(LENS))
    _close(yt, yj)
    _close(stt["h"], stj["h"])
    _close(stt["conv"], stj["conv"])
    assert stt["h"].dtype == torch.float32
    # rows shorter than d_conv - 1 = 3: the missing lookback is zeros
    assert not stt["conv"][2, 0].any() and not stt["conv"][3, :2].any()
    # without lengths: the full row, dt untouched
    yj, stj = jssm.mamba1_prefill(s["jl"], jnp.asarray(x), s["cfg"], None)
    yt, stt = tssm.mamba1_prefill(s["tl"], _t(x), s["tm"].cfg, None)
    _close(yt, yj)
    _close(stt["h"], stj["h"])
    _close(stt["conv"], stj["conv"])


def test_mamba1_decode_matches_reference(setup):
    s = setup
    cfg = s["cfg"]
    rng = np.random.default_rng(12)
    x = _x(cfg, 13, 3)
    st = {"h": rng.normal(size=(3, cfg.d_inner, cfg.ssm.d_state)),
          "conv": rng.normal(size=(3, cfg.ssm.d_conv - 1, cfg.d_inner))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    yj, stj = jssm.mamba1_decode(s["jl"], jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in st.items()},
                                 cfg)
    yt, stt = tssm.mamba1_decode(s["tl"], _t(x),
                                 {k: _t(v) for k, v in st.items()},
                                 s["tm"].cfg)
    _close(yt, yj)
    _close(stt["h"], stj["h"])
    _close(stt["conv"], stj["conv"])


def test_softplus_is_jax_softplus():
    x = np.array([-30.0, -2.0, 0.0, 1.5, 19.0, 21.0, 40.0], np.float32)
    np.testing.assert_allclose(_np(tssm.softplus(_t(x))),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_model_prefill_logits_and_state(setup):
    s = setup
    _close(s["tlog"], s["jlog"])
    assert set(s["tc"]) == {"length", "ssm_h", "ssm_conv"}
    for key in ("ssm_h", "ssm_conv"):
        assert s["tc"][key].shape == s["jc"][key].shape, key
        _close(s["tc"][key], s["jc"][key])
    assert s["tc"]["ssm_h"].dtype == torch.float32
    np.testing.assert_array_equal(_np(s["tc"]["length"]), LENS)


def test_model_decode_steps(setup):
    s = setup
    tc = {k: v.clone() for k, v in s["tc"].items()}
    jc = s["jc"]
    for step, nxt in enumerate(([5, 9, 77, 3], [1, 2, 3, 4], [8, 8, 8, 8])):
        nxt = np.array(nxt, np.int32)
        jlog, jc = s["jm"].decode_step(s["jp"], jnp.asarray(nxt), jc)
        tlog, tc = s["tm"].decode_step(s["tp"], _t(nxt), tc)
        _close(tlog, jlog)
        for key in ("ssm_h", "ssm_conv"):
            _close(tc[key], jc[key])
        np.testing.assert_array_equal(_np(tc["length"]), LENS + step + 1)


def test_model_decode_multi_block(setup):
    s = setup
    nxt = np.array([11, 12, 13, 14], np.int32)
    jids, jc = s["jm"].decode_multi(s["jp"], jnp.asarray(nxt), s["jc"], j=4)
    tids, tc = s["tm"].decode_multi(
        s["tp"], _t(nxt), {k: v.clone() for k, v in s["tc"].items()}, 4)
    np.testing.assert_array_equal(_np(tids), _np(jids))
    _close(tc["ssm_h"], jc["ssm_h"])


def test_model_forward_without_cache_uses_apply(setup):
    """forward without collect_cache is the full-sequence apply path."""
    s = setup
    toks = s["tokens"][:2]
    jlog, _ = jtfm.forward(s["jp"], s["cfg"], {"tokens": jnp.asarray(toks)},
                           scan_impl="pallas")
    tlog, aux = ttfm.forward(s["tp"], s["tm"].cfg, {"tokens": _t(toks)})
    _close(tlog, jlog)
    assert float(aux) == 0.0


# ---------------------------------------------------------------------------
# caches without k, and the tree
# ---------------------------------------------------------------------------

def test_cache_helpers_take_the_device_from_length():
    """An SSM cache has no k: re-pinning lengths (every decode iteration)
    and block tables must not read it."""
    cache = {"length": torch.zeros((3,), dtype=torch.int32),
             "ssm_h": torch.zeros((2, 3, 8, 16))}
    out = tcache.with_lengths(cache, [4, 0, 9])
    assert out["length"].dtype == torch.int32
    assert out["length"].tolist() == [4, 0, 9]
    assert out["ssm_h"] is cache["ssm_h"]
    out = tcache.with_block_tables(cache, np.zeros((3, 2), np.int32))
    assert out["block_tables"].device == cache["length"].device
    cfg = get_smoke_config("falcon-mamba-7b")
    cache = tcache.init_cache(cfg, 3, 16, dtype=torch.bfloat16, device="cpu")
    assert set(cache) == {"length", "ssm_h", "ssm_conv"}
    assert cache["ssm_h"].dtype == torch.float32
    assert cache["ssm_conv"].dtype == torch.bfloat16
    assert tuple(cache["ssm_conv"].shape) == (2, 3, 3, cfg.d_inner)
    assert not tcache.supports_physical_paging(cfg)
    assert not tcache.supports_length_rollback(cfg)


def test_init_params_matches_reference_ssm_tree(setup):
    def paths(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from paths(v, prefix + (k,))
        else:
            yield prefix, tree

    cfg = get_smoke_config("falcon-mamba-7b")
    tp = bridge.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    jp = setup["jp"]
    ref = {p: tuple(x.shape) for p, x in paths(jp)}
    assert {p: tuple(x.shape) for p, x in paths(tp)} == ref
    m, jm = tp["blocks"]["mamba"], jp["blocks"]["mamba"]
    for key in ("conv_b", "dt_bias", "D"):             # deterministic leaves
        np.testing.assert_array_equal(_np(m[key]), np.asarray(jm[key]))
    np.testing.assert_allclose(_np(m["A_log"]), np.asarray(jm["A_log"]),
                               rtol=1e-6)       # log(1..N), to the last ulp
    assert abs(float(m["conv_w"].std()) - 0.1) < 0.01
    r = max(cfg.d_model // 16, 1)
    assert abs(float(m["dt_proj"].std()) - r ** -0.5) < 0.1 * r ** -0.5
