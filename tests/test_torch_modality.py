"""The port's modality stubs (``repro_torch.serving.modality``) against the
reference's (``repro.serving.modality``), CPU.

Frames and patches from the same ids equal the reference's: atol 1e-6
at the engine tests' shapes (ids 0-11, 16 frames); where the sinusoid's
f32 argument pos * freq + 0.7 * id grows large (full width, 256 frames,
or id 250) the two libraries' ``exp`` differ by an ulp in some
frequencies, the argument then rounds one ulp apart, and the tolerance
is 0.1 x 2 ulp of the largest argument (3.05e-6 is seen at 256 frames,
one such ulp). The shape stand-ins (tensors on the ``meta`` device) have
the shapes and dtypes of the reference's ``Model.input_specs`` and of
the port's caches; frames and patches reach the port's models (other
ids, other logits); and the deprecated ``frontend`` alias re-exports the
stubs and warns.
"""
import importlib
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_shape
from repro.models import Model as JModel
from repro.serving import modality as jmod
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import Model
from repro_torch.serving import modality

torch.set_num_threads(1)
ATOL = 1e-6


CASES = [  # (config, frames, ids)
    ("smoke", 16, list(range(12))),           # the engine tests' frames
    ("smoke", 37, [0, 3, 11, 250]),
    ("full", 256, list(range(12))),           # chip_smoke.py's frames
]


@pytest.mark.parametrize("kind", ["frames", "patches"])
@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "pixtral-12b"])
@pytest.mark.parametrize("size,n,ids", CASES, ids=["engine", "ids", "full"])
def test_embeddings_match_reference(arch, kind, size, n, ids):
    cfg = get_smoke_config(arch) if size == "smoke" else get_config(arch)
    fn = getattr(modality, f"synthetic_{kind}")
    got = fn(cfg, torch.as_tensor(ids), n)
    want = np.asarray(getattr(jmod, f"synthetic_{kind}")(
        cfg, jnp.asarray(ids), n))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == (len(ids), n, cfg.d_model)
    max_arg = (n - 1) + 0.7 * max(ids)
    tol = max(ATOL, 0.1 * 2 * np.finfo(np.float32).eps * max_arg)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    # a list of ids and an explicit device give the same tensor
    np.testing.assert_array_equal(
        fn(cfg, list(ids), n, device="cpu").numpy(), got.numpy())


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_specs_match_reference_input_specs(shape):
    audio, vision = j_config("seamless-m4t-medium"), j_config("pixtral-12b")
    sh = get_shape(shape)
    want_f = JModel(audio).input_specs(sh)["frames"]
    got_f = modality.audio_frame_specs(get_config("seamless-m4t-medium"),
                                       sh.global_batch, sh.seq_len)
    want_p = JModel(vision).input_specs(sh)["patch_embeds"]
    got_p = modality.vision_patch_specs(get_config("pixtral-12b"),
                                        sh.global_batch, want_p.shape[1])
    for got, want in ((got_f, want_f), (got_p, want_p)):
        assert got.device.type == "meta"
        assert tuple(got.shape) == tuple(want.shape)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16


def test_frame_specs_match_the_serving_cache():
    cfg = get_smoke_config("seamless-m4t-medium")
    m = Model(cfg, device="cpu")
    enc_seq = m.enc_seq(64)
    spec = modality.audio_frame_specs(cfg, 3, enc_seq, dtype=torch.float32)
    cache = m.init_cache(3, 64, enc_seq=enc_seq)
    assert tuple(spec.shape) == (3, enc_seq, cfg.d_model)
    assert tuple(cache["cross_k"].shape[1:3]) == tuple(spec.shape[:2])


def test_frames_and_patches_condition_the_models():
    """Other ids give other logits: the encoder memory and the image
    prefix both reach the decoder."""
    gen = torch.Generator().manual_seed(0)
    cfg = get_smoke_config("seamless-m4t-medium")
    m = Model(cfg, device="cpu")
    p = m.init(gen)
    toks = torch.zeros((2, 1), dtype=torch.int32)
    frames = modality.synthetic_frames(cfg, [0, 7], 8)
    logits, cache = m.prefill(p, {"tokens": toks, "frames": frames},
                              m.init_cache(2, 16, enc_seq=8))
    assert tuple(logits.shape) == (2, cfg.vocab_size)
    assert float((logits[0] - logits[1]).abs().max()) > 1e-5
    assert cache["enc_length"].tolist() == [8, 8]

    cfg = get_smoke_config("pixtral-12b")
    m = Model(cfg, device="cpu")
    p = m.init(gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 6), generator=gen,
                         dtype=torch.int32)
    out = []
    for ids in ([1, 2], [6, 7]):
        patches = modality.synthetic_patches(cfg, ids, 4)
        logits, cache = m.prefill(p, {"tokens": toks, "patch_embeds": patches},
                                  m.init_cache(2, 16))
        assert cache["length"].tolist() == [10, 10]   # 4 patches + 6 text
        out.append(logits)
    assert float((out[0] - out[1]).abs().max()) > 1e-5


def test_frontend_alias_reexports_and_warns():
    sys.modules.pop("repro_torch.serving.frontend", None)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        legacy = importlib.import_module("repro_torch.serving.frontend")
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    for name in ("synthetic_frames", "synthetic_patches",
                 "audio_frame_specs", "vision_patch_specs"):
        assert getattr(legacy, name) is getattr(modality, name)
