"""Weights between the reference and the port, and the port's own init.

The reference keeps params as a nested dict (pytree) of arrays with
per-layer leaves stacked on a leading layer axis and projections in
``x @ W`` orientation; the port keeps exactly that tree as a dict of
tensors, so a leaf's path and shape are the same on both sides.

- ``from_numpy``: the reference's tree with numpy leaves (``np.asarray``
  of each JAX array) -> the port's dict of tensors on `device`.
- ``to_numpy``: back (bf16 leaves widen to float32, numpy has no bf16).
- ``opt_state_from_numpy`` / ``opt_state_to_numpy``: the optimizer state
  (step, first and second moments) the same way, so a test can start
  both packages' training from one state.
- ``init_params``: fresh weights for every family, following the
  reference's init
  (``src/repro/models/transformer.py:39-121``, ``models/moe.py:init_moe``
  and ``models/ssm.py:init_mamba1`` / ``init_mamba2``): normal with std
  0.02, the embedding with std 1.0, norm scales one, biases zero; Mamba-1's
  conv with std 0.1, dt_proj with std dt_rank^-0.5, dt_bias -2,
  A_log = log(1..N), D one; Mamba-2's conv with std 0.1, dt_bias -2,
  A_log = log(1..NH), D and the gated norm's scale one. The hybrid tree is
  ``rounds`` (norm_scale and mamba leaves on (rounds, per_round) axes)
  and one ``shared`` attention+MLP block with no layer axis. A moe block
  holds ``moe`` in place of ``mlp``: ``router`` (L, d, E), ``experts``
  ``gate``/``up`` (L, E, d, d_expert) and ``down`` (L, E, d_expert, d),
  and with shared experts a gated ``shared`` MLP of width
  num_shared_experts x d_expert. A vlm adds ``vision_proj`` {kernel
  (d, d)}; an encoder-decoder (encdec, audio) holds ``enc_blocks``
  (attention + MLP, num_encoder_layers deep), ``enc_norm`` and
  ``dec_blocks`` (``self_attn``, ``cross_attn``, ``mlp`` and their
  ``self_norm_scale``, ``cross_norm_scale``, ``mlp_norm_scale``) in
  place of ``blocks``.
  A torch generator cannot reproduce ``jax.random``, so tests that
  compare the two frameworks bridge the reference's weights instead.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


def from_numpy(tree, device="cuda", dtype=None):
    """Nested dict of numpy arrays -> nested dict of tensors."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_numpy(v, dev, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(dev)


def to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def opt_state_from_numpy(opt, device="cuda"):
    """The reference's optimizer state with numpy leaves (its
    ``OptState(step, mu, nu)``, e.g. ``jax.tree.map(np.asarray, state)``)
    -> the port's ``training.OptState`` on `device` (step int32, moments
    f32)."""
    from repro_torch.training.optimizer import OptState
    dev = resolve_device(device)
    return OptState(torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                                 device=dev),
                    from_numpy(opt.mu, dev, torch.float32),
                    from_numpy(opt.nu, dev, torch.float32))


def opt_state_to_numpy(opt):
    """The port's ``OptState`` -> the same NamedTuple with numpy leaves
    (step an int32 scalar), whose fields unpack in the reference's order:
    ``repro.training.OptState(*opt_state_to_numpy(state))``."""
    return type(opt)(np.asarray(int(opt.step), dtype=np.int32),
                     to_numpy(opt.mu), to_numpy(opt.nu))


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=torch.float32):
    """Random params of a model of any kind in the reference's tree
    layout.

    Draws on the generator's device in f32 (one layer at a time, so a
    full-width 7-12B config never holds a whole f32 stack) and stores in
    `dtype` on `device`."""
    dev = resolve_device(device)
    gdev = generator.device

    def normal(shape, std=0.02):
        x = torch.randn(shape, generator=generator, device=gdev,
                        dtype=torch.float32) * std
        return x.to(device=dev, dtype=dtype)

    def stacked(n, shape, std=0.02):
        out = torch.empty((n, *shape), dtype=dtype, device=dev)
        for i in range(n):
            out[i] = normal(shape, std)
        return out

    L, d = cfg.num_layers, cfg.d_model
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ones = lambda *s: torch.ones(s, dtype=dtype, device=dev)     # noqa: E731
    full = lambda v, *s: torch.full(s, v, dtype=dtype, device=dev)  # noqa: E731

    def draw_fn(n):
        return normal if n is None else (lambda shape: stacked(n, shape))

    def attn_leaves(n):
        """One attention block's leaves, stacked n deep (None: no axis)."""
        lead = () if n is None else (n,)
        draw = draw_fn(n)
        attn = {"wq": draw((d, h * hd)), "wk": draw((d, kv * hd)),
                "wv": draw((d, kv * hd)), "wo": draw((h * hd, d))}
        if cfg.qkv_bias:
            attn.update(bq=full(0.0, *lead, h * hd),
                        bk=full(0.0, *lead, kv * hd),
                        bv=full(0.0, *lead, kv * hd))
        return attn

    def mlp_leaves(n):
        draw = draw_fn(n)
        mlp = {"up": draw((d, cfg.d_ff)), "down": draw((cfg.d_ff, d))}
        if cfg.gated_mlp:
            mlp["gate"] = draw((d, cfg.d_ff))
        return mlp

    def attn_mlp(n):
        """Attention and MLP leaves, stacked n deep (n=None: no axis)."""
        lead = () if n is None else (n,)
        out = {"attn_norm_scale": ones(*lead, d), "attn": attn_leaves(n),
               "mlp_norm_scale": ones(*lead, d)}
        if cfg.kind == "moe":
            out["moe"] = moe(n)
        else:
            out["mlp"] = mlp_leaves(n)
        return out

    def moe(n):
        """Router, stacked experts and shared experts, n layers deep."""
        m = cfg.moe
        e, f = m.num_experts, m.d_expert
        p = {"router": stacked(n, (d, e)),
             "experts": {"gate": stacked(n, (e, d, f)),
                         "up": stacked(n, (e, d, f)),
                         "down": stacked(n, (e, f, d))}}
        if m.num_shared_experts:
            fs = m.num_shared_experts * f
            p["shared"] = {"up": stacked(n, (d, fs)),
                           "down": stacked(n, (fs, d)),
                           "gate": stacked(n, (d, fs))}
        return p

    params = {
        "embed": {"table": normal((cfg.vocab_size, d), std=1.0)},
        "final_norm": {"scale": ones(d)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": normal((d, cfg.vocab_size))}
    if cfg.kind == "ssm":
        di, n, k = cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
        r = max(d // 16, 1)
        a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32))
        params["blocks"] = {
            "norm_scale": ones(L, d),
            "mamba": {
                "in_proj": stacked(L, (d, 2 * di)),
                "conv_w": stacked(L, (k, di), std=0.1),
                "conv_b": full(0.0, L, di),
                "x_proj": stacked(L, (di, r + 2 * n)),
                "dt_proj": stacked(L, (r, di), std=r ** -0.5),
                "dt_bias": full(-2.0, L, di),
                # a copy: an expanded view would alias one row across
                # the stack and refuse in-place updates (AdamW)
                "A_log": a_log.expand(L, di, n).to(device=dev, dtype=dtype,
                                                   copy=True),
                "D": ones(L, di),
                "out_proj": stacked(L, (di, d)),
            },
        }
        return params
    if cfg.kind == "hybrid":
        s = cfg.ssm
        di, n, k = cfg.d_inner, s.d_state, s.d_conv
        nh = di // s.headdim
        every = cfg.hybrid_attn_every
        assert L % every == 0, (L, every)
        rounds, per = L // every, every - 1
        m = rounds * per

        def grid(t):            # (rounds * per_round, ...) -> (R, P, ...)
            return t.view(rounds, per, *t.shape[1:])

        a_log = torch.log(torch.arange(1, nh + 1, dtype=torch.float32))
        params["rounds"] = {
            "norm_scale": ones(rounds, per, d),
            "mamba": {key: grid(t) for key, t in {
                "in_proj": stacked(m, (d, 2 * di + 2 * n + nh)),
                "conv_w": stacked(m, (k, di + 2 * n), std=0.1),
                "conv_b": full(0.0, m, di + 2 * n),
                "dt_bias": full(-2.0, m, nh),
                "A_log": a_log.expand(m, nh).to(device=dev, dtype=dtype,
                                                copy=True),
                "D": ones(m, nh),
                "norm_scale": ones(m, di),
                "out_proj": stacked(m, (di, d)),
            }.items()},
        }
        params["shared"] = attn_mlp(None)
        return params
    if cfg.kind in ("encdec", "audio"):
        params["enc_blocks"] = attn_mlp(cfg.num_encoder_layers)
        params["enc_norm"] = {"scale": ones(d)}
        params["dec_blocks"] = {
            "self_norm_scale": ones(L, d), "self_attn": attn_leaves(L),
            "cross_norm_scale": ones(L, d), "cross_attn": attn_leaves(L),
            "mlp_norm_scale": ones(L, d), "mlp": mlp_leaves(L)}
        return params
    params["blocks"] = attn_mlp(L)
    if cfg.kind == "vlm":
        params["vision_proj"] = {"kernel": normal((d, d))}
    return params
