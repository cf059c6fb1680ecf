"""The port's encoder-decoder and vision-language models against the JAX
reference (CPU, f32).

Bridged weights of the ``seamless-m4t-medium`` smoke config (audio: no
RoPE), an ``encdec`` variant of it (the same config with
``kind="encdec"``, so RoPE on; the repo has no config of that kind) and
the ``pixtral-12b`` smoke config (vlm) go through
``repro.models.Model(cfg, impl="ref")`` and ``repro_torch.models.Model``:
the encoder, cross-attention's k/v and its application (over a prompt
and at Sq = 1), the full forward, prefill with frames (enc_lengths
defaulted and given) or with a patch prefix, and three decode steps.
Frames and patches are the reference's own ``synthetic_frames`` /
``synthetic_patches``. Tolerance: 1e-4 absolute on logits and cache
planes, as the dense model test (two f32 layers whose matmuls and
softmaxes reduce in another order in each framework).

Also, inside the port: padded, lengths-masked prefill equals the
exact-length prefill row for row (the reference's bucketed-prefill
property, ``tests/test_hotpath.py``), for both kinds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.serving.modality import synthetic_frames as j_frames
from repro.serving.modality import synthetic_patches as j_patches
from repro_torch.bridge import from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.models.transformer import layer_params

torch.set_num_threads(1)
TOL = 1e-4
S = 48                                     # decoder cache depth
SE = 12                                    # encoder frames
NP = 6                                     # vision patches
LENS = np.array([20, 33, 7, 1], np.int32)  # right-padded prompt rows
ENC_LENS = np.array([12, 9, 5, 12], np.int32)
SEQ = 40                                   # padded prompt bucket
ENCDEC = ["seamless-m4t-medium", "encdec"]


def _cfgs(arch):
    if arch == "encdec":
        base = "seamless-m4t-medium"
        return (dataclasses.replace(j_smoke(base), kind="encdec"),
                dataclasses.replace(get_smoke_config(base), kind="encdec"))
    return j_smoke(arch), get_smoke_config(arch)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=0)


_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        jcfg, tcfg = _cfgs(arch)
        jm = JModel(jcfg, impl="ref")
        jp = jm.init(jax.random.PRNGKey(0))
        tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[arch] = (jcfg, jm, jp, Model(tcfg, device="cpu"), tp)
    return _MODELS[arch]


def tcfg_of(arch):
    return _models(arch)[3].cfg


def _tokens(cfg, lens=LENS, seq=SEQ, seed=0):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(lens), seq), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return tokens


def _frames(cfg, n=len(LENS)):
    return np.asarray(j_frames(cfg, jnp.arange(n), SE))


def _patches(cfg, n=len(LENS)):
    return np.asarray(j_patches(cfg, jnp.arange(n) + 3, NP))


@pytest.mark.parametrize("arch", ENCDEC)
@pytest.mark.parametrize("enc_lens", [None, ENC_LENS], ids=["full", "lens"])
def test_encode_matches_reference(arch, enc_lens):
    cfg, _, jp, _, tp = _models(arch)
    frames = _frames(cfg)
    jl = None if enc_lens is None else jnp.asarray(enc_lens)
    tl = None if enc_lens is None else _t(enc_lens)
    want = jtfm.encode(jp, cfg, jnp.asarray(frames), jl)
    got = ttfm.encode(tp, tcfg_of(arch), _t(frames), tl)
    assert got.shape == (len(LENS), SE, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("arch", ENCDEC)
@pytest.mark.parametrize("sq", [5, 1], ids=["prompt", "decode"])
def test_cross_attention_matches_reference(arch, sq):
    cfg, _, jp, _, tp = _models(arch)
    rng = np.random.default_rng(1)
    enc = rng.standard_normal((len(LENS), SE, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((len(LENS), sq, cfg.d_model)).astype(np.float32)
    jcp = jax.tree.map(lambda a: a[1], jp["dec_blocks"]["cross_attn"])
    tcp = layer_params(tp["dec_blocks"]["cross_attn"], 1)
    jk, jv = jattn.cross_attn_kv(jcp, jnp.asarray(enc), cfg)
    tk, tv = tattn.cross_attn_kv(tcp, _t(enc), tcfg_of(arch))
    _close(tk, jk)
    _close(tv, jv)
    want = jattn.cross_attn_apply(jcp, jnp.asarray(x), jk, jv,
                                  jnp.asarray(ENC_LENS), cfg)
    got = tattn.cross_attn_apply(tcp, _t(x), tk, tv, _t(ENC_LENS),
                                 tcfg_of(arch))
    assert got.shape == (len(LENS), sq, cfg.d_model)
    _close(got, want)


def _batch(arch, cfg, lens=LENS, seq=SEQ, enc_lens=None):
    """The numpy batch both sides prefill."""
    batch = {"tokens": _tokens(cfg, lens, seq), "lengths": np.asarray(lens)}
    if cfg.kind == "vlm":
        batch["patch_embeds"] = _patches(cfg, len(lens))
    else:
        batch["frames"] = _frames(cfg, len(lens))
        if enc_lens is not None:
            batch["enc_lengths"] = enc_lens
    return batch


@pytest.mark.parametrize("arch", ENCDEC + ["pixtral-12b"])
def test_forward_matches_reference(arch):
    cfg, _, jp, _, tp = _models(arch)
    batch = _batch(arch, cfg, enc_lens=None if cfg.kind == "vlm"
                   else ENC_LENS)
    lens = LENS + (NP if cfg.kind == "vlm" else 0)
    jlog, _ = jtfm.forward(jp, cfg, jax.tree.map(jnp.asarray, batch),
                           lengths=jnp.asarray(lens))
    tlog, _ = ttfm.forward(tp, tcfg_of(arch),
                           {k: _t(v) for k, v in batch.items()},
                           lengths=_t(lens))
    assert tlog.shape == (len(LENS), SEQ, cfg.vocab_size)
    _close(tlog, jlog)


@pytest.mark.parametrize("arch,enc_lens", [
    ("seamless-m4t-medium", None), ("seamless-m4t-medium", ENC_LENS),
    ("encdec", None), ("encdec", ENC_LENS), ("pixtral-12b", None)],
    ids=["seamless", "seamless-enc_lengths", "encdec", "encdec-enc_lengths",
         "pixtral-patches"])
def test_prefill_and_decode_match_reference(arch, enc_lens):
    cfg, jm, jp, tm, tp = _models(arch)
    batch = _batch(arch, cfg, enc_lens=enc_lens)
    se = jm.enc_seq(S) and SE
    jlog, jc = jax.jit(jm.prefill)(jp, jax.tree.map(jnp.asarray, batch),
                                   jm.init_cache(len(LENS), S, enc_seq=se))
    tlog, tc = tm.prefill(tp, {k: _t(v) for k, v in batch.items()},
                          tm.init_cache(len(LENS), S, enc_seq=se))
    _close(tlog, jlog)
    ctx = LENS + (NP if cfg.kind == "vlm" else 0)
    np.testing.assert_array_equal(_np(tc["length"]), ctx)
    np.testing.assert_array_equal(_np(tc["length"]), _np(jc["length"]))
    assert set(tc) == set(jc)
    for key in tc:
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        _close(tc[key], jc[key])
    if cfg.kind != "vlm":
        np.testing.assert_array_equal(
            _np(tc["enc_length"]),
            np.full(len(LENS), SE) if enc_lens is None else enc_lens)
    rng = np.random.default_rng(2)
    for step in range(3):
        nxt = rng.integers(0, cfg.vocab_size, len(LENS)).astype(np.int32)
        jlog, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        tlog, tc = tm.decode_step(tp, _t(nxt), tc)
        _close(tlog, jlog)
        for key in ("k", "v"):
            _close(tc[key], jc[key])
        np.testing.assert_array_equal(_np(tc["length"]), ctx + step + 1)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "pixtral-12b"])
def test_bucketed_prefill_matches_exact_length(arch):
    """Padded to a 32 bucket and lengths-masked, several rows at once,
    equals each row prefilled alone at its exact length (the engine's
    bucketed prefill against its eager path)."""
    cfg, _, _, tm, tp = _models(arch)
    lens = [5, 17, 29]
    batch = _batch(arch, cfg, lens=lens, seq=32)
    se = tm.enc_seq(48)
    padded, _ = tm.prefill(tp, {k: _t(v) for k, v in batch.items()},
                           tm.init_cache(len(lens), 48, enc_seq=se))
    for i, n in enumerate(lens):
        one = {"tokens": _t(batch["tokens"][i:i + 1, :n])}
        for key in ("frames", "patch_embeds"):
            if key in batch:
                one[key] = _t(batch[key][i:i + 1])
        exact, _ = tm.prefill(tp, one, tm.init_cache(1, 48, enc_seq=se))
        _close(padded[i], exact[0], tol=1e-5)
        assert int(padded[i].argmax()) == int(exact[0].argmax()), n


def test_ported_kinds_and_enc_seq():
    assert {"vlm", "audio", "encdec"} <= set(ttfm.PORTED_KINDS)
    for arch in ENCDEC + ["pixtral-12b"]:
        _, jm, _, tm, _ = _models(arch)
        for max_seq in (64, 1024, 1030):
            assert tm.enc_seq(max_seq) == jm.enc_seq(max_seq)
    _, _, _, tm, _ = _models("seamless-m4t-medium")
    cache = tm.init_cache(3, 16, enc_seq=4)
    assert tuple(cache["cross_k"].shape) == (2, 3, 4, 4, 64)
    assert cache["enc_length"].dtype == torch.int32
    assert not tm.supports_physical_paging()
