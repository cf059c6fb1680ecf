"""The port's hybrid path (Mamba-2 + weight-shared attention) against the
JAX reference (CPU, f32, the zamba2 smoke config, bridged weights).

The same numpy inputs go through the reference and the port:

- the plain Mamba-2 recurrence (``ssd_ref``, ``ssd_with_state_ref``,
  ``ssd_step_ref``) against the reference's ``ssd_ref``,
  ``ssm._ssd_with_state`` and ``ssd_step_ref``, relative to max |y| at the
  reference's Pallas-vs-ref scan bound (1e-5, ``tests/test_kernels.py:120``);
- ``ops.ssd_channel_args`` — exactly what the CUDA path feeds the
  selective-scan kernel — through the plain selective scan
  (``selective_scan_with_state_ref``) against ``ssd_with_state_ref``,
  with B and C as strided column slices and dt zeroed past ragged lengths;
- ``mamba2_apply`` against the reference's ``ops.ssd(impl="chunked")``
  path, within the reference's own chunked-vs-sequential tolerance
  (atol 2e-4, rtol 2e-3, ``tests/test_kernels.py:139-151``);
- ``mamba2_prefill`` with ragged lengths (rows shorter than d_conv - 1
  included) and ``mamba2_decode``, state and conv buffer;
- the smoke ``Model``: prefill logits and every cache leaf, decode steps,
  ``decode_multi`` and the forward without a cache, at the f32 tolerance
  of ``tests/test_torch_model.py`` (1e-4 absolute; the chunked forward at
  the chunked tolerance);
- ``init_params``' tree and ``init_cache``'s shapes against the
  reference's.

Also: the Mamba-2 dispatch sends CPU tensors to the plain versions, the
CUDA path refuses CPU tensors, and the engine refuses a physical page pool
for a hybrid, as the reference does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels import ref as jref
from repro.models import Model as JModel
from repro.models import cache as jcache
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.bridge import from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core import TPU_V5E, LatencyModel, make_scheduler
from repro_torch.kernels import cuda as tcuda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import Model
from repro_torch.models import cache as tcache
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.models.transformer import layer_params
from repro_torch.serving import ServingEngine

torch.set_num_threads(1)
ARCH = "zamba2-2.7b"
REL = 1e-5               # scan, relative to max |y|: tests/test_kernels.py:120
TOL = 1e-4               # model, absolute: tests/test_torch_model.py
CHUNKED = dict(atol=2e-4, rtol=2e-3)   # chunked SSD: tests/test_kernels.py:151
S = 40                   # cache depth
SEQ = 24                 # padded prompt bucket
LENS = np.array([24, 13, 2, 1], np.int32)   # two rows under d_conv - 1


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=0)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-6))


def _ssd_inputs(seed, b, s, nh, hd, n, lengths=None):
    """x, dt (softplus'd, zero past `lengths`), A (negative), B, C, D as
    the reference's SSD test draws them, from numpy. B and C are column
    slices of one (b, s, 3 + 2n) array, as the conv output hands them
    over."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(b, s, nh, hd)).astype(f)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, nh)) - 1)).astype(f)
    if lengths is not None:
        dt[np.arange(s)[None, :] >= np.asarray(lengths)[:, None]] = 0.0
    A = -np.exp(rng.normal(size=(nh,)) * 0.5).astype(f)
    bc = rng.normal(size=(b, s, 3 + 2 * n)).astype(f)
    D = np.full((nh,), 0.3, f)
    return x, dt, A, bc[..., 3:3 + n], bc[..., 3 + n:], D


def _torch_args(args):
    """Torch tensors of `_ssd_inputs`, B and C kept as strided slices."""
    x, dt, A, B, C, D = args
    bc = _t(np.concatenate([np.zeros_like(B[..., :3]), B, C], axis=-1))
    n = B.shape[-1]
    return _t(x), _t(dt), _t(A), bc[..., 3:3 + n], bc[..., 3 + n:], _t(D)


# ---------------------------------------------------------------------------
# the Mamba-2 recurrence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 50, 4, 32, 16), (1, 33, 3, 64, 64)])
def test_plain_ssd_matches_reference(shape):
    args = _ssd_inputs(0, *shape)
    ja = [jnp.asarray(a) for a in args]
    y_j, h_j = jssm._ssd_with_state(*ja)
    oracle = jref.ssd_ref(*ja)
    y, h = tref.ssd_with_state_ref(*_torch_args(args))
    b, s, nh, hd, n = shape
    assert y.shape == (b, s, nh, hd) and y.dtype == torch.float32
    assert h.shape == (b, nh, hd, n) and h.dtype == torch.float32
    assert _rel(y, y_j) < REL and _rel(y, oracle) < REL
    assert _rel(h, h_j) < REL
    # the y-only form is the same computation
    assert torch.equal(tref.ssd_ref(*_torch_args(args)), y)


def test_plain_ssd_step_matches_reference():
    x, dt, A, B, C, D = _ssd_inputs(1, 3, 1, 4, 32, 16)
    h0 = np.random.default_rng(2).normal(size=(3, 4, 32, 16)).astype(
        np.float32)
    step = (h0, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D)
    hj, yj = jref.ssd_step_ref(*[jnp.asarray(a) for a in step])
    ht, yt = tops.ssd_step(*[_t(a) for a in step])
    assert _rel(ht, hj) < REL
    assert _rel(yt, yj) < REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 40, 4, 32, 16), (2, 19, 5, 64, 64)])
def test_ssd_scan_mapping_matches_plain_ssd(shape, dtype):
    """The arguments the CUDA path hands the selective-scan kernel, run
    through the kernel's plain version, give the Mamba-2 recurrence: the
    kernel's input contract (x and dt contiguous in x's dtype, B and C
    with a unit last stride, A and D (D,)) and the y / h_last
    layouts."""
    b, s, nh, hd, n = shape
    lens = [s] + [max(1, s - 7 * i) for i in range(1, b)]
    x, dt, A, B, C, D = _torch_args(_ssd_inputs(3, *shape, lengths=lens))
    # x, B and C as the model hands them over: column slices of the conv
    # output, x as a head view of its slice
    xbc = torch.cat([x.reshape(b, s, nh * hd), B, C], dim=-1).to(dtype)
    di = nh * hd
    x = xbc[..., :di].reshape(b, s, nh, hd)
    B, C, dt = xbc[..., di:di + n], xbc[..., di + n:], dt.to(dtype)
    assert not x.is_contiguous()
    args = tops.ssd_channel_args(x, dt, A, B, C, D)
    xs, dts, As, Bs, Cs, Ds = args
    assert xs.is_contiguous() and dts.is_contiguous()
    assert xs.shape == dts.shape == (b, s, nh * hd)
    assert dts.dtype == dtype and xs.dtype == dtype
    assert As.shape == Ds.shape == (nh * hd,)
    assert Bs.stride(2) == 1 and Cs.stride(2) == 1
    assert not Bs.is_contiguous()
    y_s, h_s = tref.selective_scan_with_state_ref(*args)
    y, h = tref.ssd_with_state_ref(x, dt, A, B, C, D)
    tol = REL if dtype == torch.float32 else 2e-2
    assert _rel(y_s.view(x.shape), y) <= tol
    assert _rel(h_s.view(b, nh, hd, n), h) <= REL


def test_ssd_dispatch_sends_cpu_tensors_to_plain_versions():
    args = _torch_args(_ssd_inputs(4, 2, 16, 4, 32, 16))
    tcuda.reset_launches()
    assert torch.equal(tops.ssd(*args), tref.ssd_ref(*args))
    y, h = tops.ssd_with_state(*args)
    y_r, h_r = tref.ssd_with_state_ref(*args)
    assert torch.equal(y, y_r) and torch.equal(h, h_r)
    assert all(n == 0 for n in tcuda.launches.values())


def test_ssd_cuda_path_refuses_cpu_tensors():
    """No silent fallback: the kernel's wrapper takes the mapped arguments
    on a CUDA device only."""
    args = tops.ssd_channel_args(
        *_torch_args(_ssd_inputs(5, 1, 8, 2, 32, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        tcuda.selective_scan(*args, return_state=True)
    assert tcuda.launches["selective_scan"] == 0


# ---------------------------------------------------------------------------
# the Mamba-2 block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = j_smoke(ARCH)
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config(ARCH), device="cpu")
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jl = jax.tree.map(lambda t: t[0, 0], jp["rounds"]["mamba"])
    tl = layer_params(layer_params(tp["rounds"]["mamba"], 0), 0)
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


def test_mamba2_apply_matches_chunked_path(setup):
    s = setup
    x = _x(s["cfg"], 10, 2, SEQ)
    expect = jssm.mamba2_apply(s["jl"], jnp.asarray(x), s["cfg"],
                               impl="chunked")
    out = tssm.mamba2_apply(s["tl"], _t(x), s["tm"].cfg)
    np.testing.assert_allclose(_np(out), np.asarray(expect), **CHUNKED)


def test_mamba2_prefill_matches_reference(setup):
    s = setup
    x = _x(s["cfg"], 11, len(LENS), SEQ)
    yj, stj = jssm.mamba2_prefill(s["jl"], jnp.asarray(x), s["cfg"],
                                  jnp.asarray(LENS))
    yt, stt = tssm.mamba2_prefill(s["tl"], _t(x), s["tm"].cfg, _t(LENS))
    _close(yt, yj)
    _close(stt["h"], stj["h"])
    _close(stt["conv"], stj["conv"])
    cfg = s["cfg"]
    nh = cfg.d_inner // cfg.ssm.headdim
    assert stt["h"].dtype == torch.float32
    assert stt["h"].shape == (len(LENS), nh, cfg.ssm.headdim,
                              cfg.ssm.d_state)
    assert stt["conv"].shape == (len(LENS), cfg.ssm.d_conv - 1,
                                 cfg.d_inner + 2 * cfg.ssm.d_state)
    # rows shorter than d_conv - 1 = 3: the missing lookback is zeros
    assert not stt["conv"][2, 0].any() and not stt["conv"][3, :2].any()
    # without lengths: the full row, dt untouched
    yj, stj = jssm.mamba2_prefill(s["jl"], jnp.asarray(x), s["cfg"], None)
    yt, stt = tssm.mamba2_prefill(s["tl"], _t(x), s["tm"].cfg, None)
    _close(yt, yj)
    _close(stt["h"], stj["h"])
    _close(stt["conv"], stj["conv"])


def test_mamba2_decode_matches_reference(setup):
    s = setup
    cfg = s["cfg"]
    nh = cfg.d_inner // cfg.ssm.headdim
    rng = np.random.default_rng(12)
    x = _x(cfg, 13, 3)
    st = {"h": rng.normal(size=(3, nh, cfg.ssm.headdim, cfg.ssm.d_state)),
          "conv": rng.normal(size=(3, cfg.ssm.d_conv - 1,
                                   cfg.d_inner + 2 * cfg.ssm.d_state))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    yj, stj = jssm.mamba2_decode(s["jl"], jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in st.items()},
                                 cfg)
    yt, stt = tssm.mamba2_decode(s["tl"], _t(x),
                                 {k: _t(v) for k, v in st.items()},
                                 s["tm"].cfg)
    _close(yt, yj)
    _close(stt["h"], stj["h"])
    _close(stt["conv"], stj["conv"])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_model_prefill_logits_and_every_cache_leaf(setup):
    s = setup
    _close(s["tlog"], s["jlog"])
    assert set(s["tc"]) == set(s["jc"]) == {"length", "k", "v", "ssm_h",
                                            "ssm_conv"}
    for key in ("k", "v", "ssm_h", "ssm_conv"):
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
        for key in ("k", "v", "ssm_h", "ssm_conv"):
            _close(tc[key], jc[key])
        np.testing.assert_array_equal(_np(tc["length"]), LENS + step + 1)


def test_model_decode_multi_block(setup):
    s = setup
    nxt = np.array([11, 12, 13, 14], np.int32)
    jids, jc = s["jm"].decode_multi(s["jp"], jnp.asarray(nxt), s["jc"], j=4)
    tids, tc = s["tm"].decode_multi(
        s["tp"], _t(nxt), {k: v.clone() for k, v in s["tc"].items()}, 4)
    np.testing.assert_array_equal(_np(tids), _np(jids))
    for key in ("k", "v", "ssm_h", "ssm_conv"):
        _close(tc[key], jc[key])


def test_model_forward_without_cache_uses_apply(setup):
    """forward without collect_cache is the full-sequence apply path (the
    reference's chunked SSD by default)."""
    s = setup
    toks = s["tokens"][:2]
    jlog, _ = jtfm.forward(s["jp"], s["cfg"], {"tokens": jnp.asarray(toks)})
    tlog, aux = ttfm.forward(s["tp"], s["tm"].cfg, {"tokens": _t(toks)})
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **CHUNKED)
    assert float(aux) == 0.0


# ---------------------------------------------------------------------------
# the tree, the cache and the engine's refusal
# ---------------------------------------------------------------------------

def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def test_init_params_matches_reference_hybrid_tree(setup):
    cfg = get_smoke_config(ARCH)
    tp = bridge.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    jp = setup["jp"]
    ref = {p: tuple(x.shape) for p, x in _paths(jp)}
    assert {p: tuple(x.shape) for p, x in _paths(tp)} == ref
    m, jm = tp["rounds"]["mamba"], jp["rounds"]["mamba"]
    for key in ("conv_b", "dt_bias", "D", "norm_scale"):   # deterministic
        np.testing.assert_array_equal(_np(m[key]), np.asarray(jm[key]))
    np.testing.assert_allclose(_np(m["A_log"]), np.asarray(jm["A_log"]),
                               rtol=1e-6)       # log(1..NH), to the last ulp
    assert abs(float(m["conv_w"].std()) - 0.1) < 0.01
    assert abs(float(m["in_proj"].std()) - 0.02) < 0.002
    for key in ("attn_norm_scale", "mlp_norm_scale"):
        np.testing.assert_array_equal(_np(tp["shared"][key]),
                                      np.asarray(jp["shared"][key]))


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "falcon-mamba-7b",
                                  "llama3-8b"])
@pytest.mark.parametrize("full", [False, True])
def test_init_cache_shapes_match_reference(arch, full):
    """The hybrid layout beside the two earlier ones, at the smoke and the
    full config (shapes only: the reference builds the full one
    abstractly)."""
    from repro.configs import get_config as j_config
    from repro_torch.configs import get_config
    jcfg = j_config(arch) if full else j_smoke(arch)
    cfg = get_config(arch) if full else get_smoke_config(arch)
    expect = jcache.init_cache(jcfg, 2, 32, dtype=jnp.bfloat16,
                               abstract=True)
    got = tcache.init_cache(cfg, 2, 32, dtype=torch.bfloat16, device="meta")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in expect.items()}
    if "ssm_h" in got:
        assert got["ssm_h"].dtype == torch.float32
    if cfg.kind == "hybrid":
        assert not tcache.supports_physical_paging(cfg)
        assert not tcache.supports_length_rollback(cfg)


def test_engine_refuses_physical_pages_for_hybrid(setup):
    """The hybrid's recurrent state has no positional gate to page
    against: asking for the physical pool raises, as in the reference;
    the default falls back to accounting-only paging."""
    tm, tp = setup["tm"], setup["tp"]
    lat = LatencyModel(tm.cfg, TPU_V5E)
    with pytest.raises(ValueError, match="physically paged"):
        ServingEngine(tm, tp, make_scheduler("andes", 100, lat), lat,
                      num_slots=4, max_seq=64, page_size=16,
                      physical_pages=True, device="cpu")
    eng = ServingEngine(tm, tp, make_scheduler("andes", 100, lat), lat,
                        num_slots=4, max_seq=64, page_size=16, device="cpu")
    assert not eng.physical_pages
    assert eng.kv.paged
    assert set(eng.cache) == {"length", "k", "v", "ssm_h", "ssm_conv"}
