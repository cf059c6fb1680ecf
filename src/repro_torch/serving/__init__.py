from repro_torch.core.request import Request, ReqState
from repro_torch.serving.engine import (BucketedPrefill, HotpathConfig,
                                        ServingEngine)
from repro_torch.serving.kv_manager import KVSlotManager
from repro_torch.serving.lossless import (FLIP_TOL, all_flips_documented,
                                          audit_flips, classify_flip,
                                          engine_margin, exact_margin,
                                          fingerprint,
                                          first_divergence,
                                          timing_fingerprint)
from repro_torch.serving.modality import (audio_frame_specs,
                                         synthetic_frames,
                                         synthetic_patches,
                                         vision_patch_specs)
from repro_torch.serving.simulator import (ServingSimulator, SimConfig,
                                           SimResult)
from repro_torch.serving.speculative import (DraftProposer,
                                             check_speculation_compatible)
from repro_torch.serving.tolerance import (Tolerance, ToleranceReport,
                                           ToleranceSpec, compare_requests)

__all__ = [
    "Request", "ReqState", "KVSlotManager", "ServingEngine",
    "HotpathConfig", "BucketedPrefill",
    "ServingSimulator", "SimConfig", "SimResult",
    "DraftProposer", "check_speculation_compatible",
    "FLIP_TOL", "fingerprint", "timing_fingerprint", "first_divergence",
    "exact_margin", "engine_margin", "classify_flip", "audit_flips",
    "all_flips_documented",
    "Tolerance", "ToleranceSpec", "ToleranceReport", "compare_requests",
    "audio_frame_specs", "vision_patch_specs", "synthetic_frames",
    "synthetic_patches",
]
