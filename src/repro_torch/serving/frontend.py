"""Deprecated alias of ``repro_torch.serving.modality`` (the `frontend`
name belongs to the client-facing serving API in ``repro_torch.api``).
Re-exports the modality stubs and warns once, on import."""
import warnings

from repro_torch.serving.modality import (  # noqa: F401
    audio_frame_specs,
    synthetic_frames,
    synthetic_patches,
    vision_patch_specs,
)

warnings.warn(
    "repro_torch.serving.frontend moved to repro_torch.serving.modality; "
    "the client-facing serving API lives in repro_torch.api",
    DeprecationWarning,
    stacklevel=2,
)

__all__ = ["audio_frame_specs", "vision_patch_specs",
           "synthetic_frames", "synthetic_patches"]
