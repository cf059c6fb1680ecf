"""repro_torch.api — the unified client-facing serving surface.

One submit/stream API over every backend the repo can serve with
(discrete-event simulator, real-model engine, speculative engine, or a
whole multi-replica cluster), built on the user-timeline abstraction the
paper defines QoE over:

  ServingClient  — client sessions: submit(prompt, SubmitOptions) over
                   any steppable backend.
  StreamHandle   — a response as the user sees it: an iterator of
                   TokenEvents re-smoothed by the §5 client pacing
                   buffer, with lifecycle callbacks.
  SubmitOptions  — tenant, priority class, QoE expectation, and the
                   per-tenant SLOContract that admission/autoscaling
                   price with (repro_torch.core.pricing).
"""
from repro_torch.core.pricing import SLOContract
from repro_torch.core.qoe import QoESpec
from repro_torch.api.client import DEFAULT_SPEC, ServingClient, SubmitOptions
from repro_torch.api.stream import StreamHandle, TokenEvent

__all__ = [
    "ServingClient", "SubmitOptions", "StreamHandle", "TokenEvent",
    "SLOContract", "QoESpec", "DEFAULT_SPEC",
]
