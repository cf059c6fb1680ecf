"""Modality stubs: the audio frames an encoder-decoder consumes and the
vision patches a vlm decoder prefixes.

The counterpart of ``src/repro/serving/modality.py``. The configs name
the transformer backbone only; the audio codec (SeamlessM4T's mel and
conv front end) and the ViT tower (Pixtral's) are stubs that give
deterministic embeddings of the right shape:

  * shapes:  `audio_frame_specs` / `vision_patch_specs` -> tensors on the
             ``meta`` device (the stand-in for a ShapeDtypeStruct);
  * runtime: `synthetic_frames` / `synthetic_patches` -> smooth, bounded
             f32 embeddings (sinusoids of a per-sample id), so the engine
             and the tests run the real cross-attention and prefix paths.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def audio_frame_specs(cfg: ModelConfig, batch: int, frames: int,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """Precomputed mel+conv frame embeddings the encoder consumes."""
    return torch.empty((batch, frames, cfg.d_model), dtype=dtype,
                       device="meta")


def vision_patch_specs(cfg: ModelConfig, batch: int, patches: int,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """Precomputed ViT patch embeddings the decoder prefixes."""
    return torch.empty((batch, patches, cfg.d_model), dtype=dtype,
                       device="meta")


def _sinusoid_embed(ids, length: int, d_model: int,
                    device="cpu") -> torch.Tensor:
    """Deterministic smooth embeddings (B, length, d_model) f32 keyed by
    per-sample ids (B,), the reference's formula."""
    ids = torch.as_tensor(ids).to(device)
    pos = torch.arange(length, dtype=torch.float32, device=device)
    freq = torch.exp(-torch.arange(d_model, dtype=torch.float32,
                                   device=device) / d_model * 4.0)
    phase = ids.to(torch.float32) * 0.7
    return 0.1 * torch.sin(pos[None, :, None] * freq[None, None, :]
                           + phase[:, None, None])


def synthetic_frames(cfg: ModelConfig, ids, frames: int,
                     device="cpu") -> torch.Tensor:
    """(B,) sample ids -> (B, frames, d_model) f32 audio-frame embeddings
    on `device`."""
    return _sinusoid_embed(ids, frames, cfg.d_model, device)


def synthetic_patches(cfg: ModelConfig, ids, patches: int,
                      device="cpu") -> torch.Tensor:
    """(B,) sample ids -> (B, patches, d_model) f32 vision-patch embeddings
    on `device`."""
    return _sinusoid_embed(ids, patches, cfg.d_model, device)
