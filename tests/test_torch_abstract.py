"""The port's abstract model surface against the JAX reference (CPU).

``Model.abstract_params``, ``Model.input_specs`` and
``init_cache`` / ``init_paged_cache(abstract=True)`` return tensors on
the ``meta`` device; the reference returns ``jax.eval_shape`` trees and
ShapeDtypeStructs. For all 11 archs at their full configs, leaf for leaf:
the same paths, shapes and dtypes — params in f32 and bf16, the inputs of
every ``INPUT_SHAPES`` entry (train, prefill and decode; the
encoder-decoder, audio and vlm branches), and both caches at a decode
shape. At smoke size the meta shapes equal those of the port's real
``init`` and ``init_cache``. The reference's own checks are ported: the
full configs' param count within 12% of ``cfg.param_count()``
(``tests/test_arch_smoke.py``) and the audio frames' spec against
``audio_frame_specs`` (``tests/test_modality.py``). Nothing is
allocated: llama3-405b's 405 B params are meta tensors in this process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.models import Model as JModel
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,
                                 get_smoke_config)
from repro_torch.models import Model
from repro_torch.serving import audio_frame_specs, vision_patch_specs

torch.set_num_threads(1)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
DECODE = dict(batch=8, max_seq=1024)
PAGED = dict(batch=8, num_pages=128, page_size=16, max_seq=1024)


def _port(tree, path=()):
    """{path: (shape, dtype name)} of a tree of meta tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port(v, path + (k,)))
        return out
    assert tree.device.type == "meta", path
    return {"|".join(path): (tuple(tree.shape),
                             str(tree.dtype).removeprefix("torch."))}


def _ref(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "|".join(str(p.key) for p in path)
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_equal_reference(arch, dtype):
    tdt, jdt = DTYPES[dtype]
    got = _port(Model(get_config(arch), device="cpu").abstract_params(tdt))
    want = _ref(JModel(j_config(arch), param_dtype=jdt).abstract_params())
    assert got == want


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_reference(arch, shape):
    got = _port(Model(get_config(arch), device="cpu").input_specs(
        INPUT_SHAPES[shape]))
    want = _ref(JModel(j_config(arch)).input_specs(INPUT_SHAPES[shape]))
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_caches_equal_reference(arch):
    tm = Model(get_config(arch), device="cpu")
    jm = JModel(j_config(arch))
    enc = tm.enc_seq(DECODE["max_seq"])
    got = _port(tm.init_cache(DECODE["batch"], DECODE["max_seq"],
                              enc_seq=enc, dtype=torch.bfloat16,
                              abstract=True))
    want = _ref(jm.init_cache(DECODE["batch"], DECODE["max_seq"],
                              enc_seq=enc, dtype=jnp.bfloat16,
                              abstract=True))
    assert got == want
    assert tm.supports_physical_paging() == jm.supports_physical_paging()
    if tm.supports_physical_paging():
        p = PAGED
        got = _port(tm.init_paged_cache(p["batch"], p["num_pages"],
                                        p["page_size"], p["max_seq"],
                                        abstract=True))
        want = _ref(jm.init_paged_cache(p["batch"], p["num_pages"],
                                        p["page_size"], p["max_seq"],
                                        abstract=True))
        assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_meta_shapes_equal_real(arch):
    m = Model(get_smoke_config(arch), device="cpu")
    real = m.init(torch.Generator().manual_seed(0), torch.bfloat16)
    assert _port(m.abstract_params(torch.bfloat16)) == _port(_to_meta(real))
    enc = m.enc_seq(32)
    assert _port(m.init_cache(2, 32, enc_seq=enc, abstract=True)) == \
        _port(_to_meta(m.init_cache(2, 32, enc_seq=enc)))
    if m.supports_physical_paging():
        assert _port(m.init_paged_cache(2, 8, 4, 32, abstract=True)) == \
            _port(_to_meta(m.init_paged_cache(2, 8, 4, 32)))


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    return tree.to("meta")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_count_near_analytic(arch):
    """No allocation at full size (llama3-405b included); the count is
    within 12% of the analytic one (which misses small extras)."""
    cfg = get_config(arch)
    params = Model(cfg, device="cpu").abstract_params(torch.bfloat16)
    n = sum(int(np.prod(shape)) for shape, _ in _port(params).values())
    assert abs(n - cfg.param_count()) / cfg.param_count() < 0.12


def test_modality_specs_match_input_specs():
    cfg = get_config("seamless-m4t-medium")
    specs = Model(cfg, device="cpu").input_specs(INPUT_SHAPES["prefill_32k"])
    want = audio_frame_specs(cfg, 32, 32768)
    assert specs["frames"].shape == want.shape
    assert specs["frames"].dtype == want.dtype
    cfg = get_config("pixtral-12b")
    specs = Model(cfg, device="cpu").input_specs(INPUT_SHAPES["prefill_32k"])
    want = vision_patch_specs(cfg, 32, 1024)
    assert specs["patch_embeds"].shape == want.shape
    assert specs["patch_embeds"].dtype == want.dtype
