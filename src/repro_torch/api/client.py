"""ServingClient: one submit/stream surface over ANY Andes backend.

The paper's QoE machinery is defined on the user's interaction timeline,
but until this module every consumer hand-drove a backend through its own
low-level loop (submit-all + step-to-drain for the simulator, the same
again for the engine, a third variant for the cluster). `ServingClient`
is the single user-facing surface:

    client = ServingClient(backend)          # sim | engine | spec engine
                                             # | whole ClusterSimulator
    h = client.submit(prompt_or_len, SubmitOptions(spec=..., contract=...))
    for ev in h:                             # drives the backend on demand
        ...                                  # ev.visible_time is §5-paced
    h.qoe(), h.ttft()                        # Eq. 1 on the user timeline

Anything exposing the steppable protocol (`submit/step/result/now` —
`ServingSimulator`, `ServingEngine` with or without speculation, and the
steppable `ClusterSimulator`) plugs in unchanged; the client attaches one
`repro_torch.obs.Observer` to the backend and fans lifecycle events out to
per-request `StreamHandle`s (backends predating the observer protocol get
the legacy `event_sink` callable instead). Attaching — rather than
setting — means client streaming composes with any tracing/metrics
observers the caller installed: no private sink plumbing.
Driving a backend through the client is bit-identical to driving it
directly (tests/test_api.py: emit timestamps, preemptions, and final QoE
per request) — the client adds an API, never a behavior.

`SubmitOptions` carries the request's identity in the serving economy:
its QoE expectation (`spec`), tenant, priority class, and `SLOContract`
(core.pricing) — the contract's weight is what the admission controller
and autoscaler price with, replacing a uniform threshold.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.core.pricing import SLOContract
from repro_torch.core.qoe import QoESpec
from repro_torch.core.request import Request
from repro_torch.api.stream import StreamHandle
from repro_torch.obs import Observer

# reading-speed default: 1 s to first token, 4.8 tokens/s thereafter
# (the paper's expected human reading pace, Table 1)
DEFAULT_SPEC = QoESpec(ttft=1.0, tds=4.8)


@dataclasses.dataclass(frozen=True)
class SubmitOptions:
    """Per-request serving options.

    spec      — expected delivery timeline (TTFT + TDS), the Eq. 1 QoE
                reference curve.
    max_tokens— response length bound (ground-truth length in simulation).
    tenant    — tenant id for per-tenant accounting (cluster layer).
    priority  — priority class; class p prices (1+p)x in the scheduler
                knapsack, router, and admission (core.pricing).
    contract  — per-tenant SLOContract (attainment targets + pricing
                weight). None = uniform behavior.
    arrival   — absolute submission time; None = the backend's clock now
                (trace replays pass explicit arrivals).
    """
    spec: QoESpec = DEFAULT_SPEC
    max_tokens: int = 64
    tenant: int = 0
    priority: int = 0
    contract: Optional[SLOContract] = None
    arrival: Optional[float] = None


class _ClientObserver(Observer):
    """Fans backend lifecycle hooks out to the client's StreamHandles.

    Only the stream-visible kinds are forwarded; every other hook
    inherits the null base. Handles are looked up by object identity, so
    a backend shared with other submitters never cross-talks."""

    def __init__(self, client: "ServingClient"):
        self._client = client

    def _fwd(self, kind: str, req: Request, t: float, k: int = 0) -> None:
        h = self._client._handles.get(id(req))
        if h is not None:
            h._event(kind, t, k)

    def emit(self, req, t, k=1, *, replica=-1):
        self._fwd("emit", req, t, k)

    def preempt(self, req, t, mode="swap", *, replica=-1):
        self._fwd("preempt", req, t)

    def finish(self, req, t, *, replica=-1):
        self._fwd("finish", req, t)

    def shed(self, req, t, *, replica=-1):
        self._fwd("shed", req, t)

    def defer(self, req, t, *, replica=-1):
        self._fwd("defer", req, t)

    def cancel(self, req, t, *, replica=-1):
        self._fwd("cancel", req, t)


class ServingClient:
    """Client sessions over one backend (see module docstring)."""

    def __init__(self, backend):
        self.backend = backend
        self._handles: Dict[int, StreamHandle] = {}     # id(request) -> h
        self._rids: set = set()                         # every rid in use
        self._next_rid = 0
        # one observer for the whole backend; the cluster propagates it to
        # every replica backend, including autoscaler-provisioned ones.
        self._observer = _ClientObserver(self)
        if hasattr(backend, "attach_observer"):
            backend.attach_observer(self._observer)
        else:  # foreign backend predating repro_torch.obs: legacy callable sink
            backend.event_sink = self._on_event

    # ------------------------------------------------------------- plumbing
    def _on_event(self, kind: str, req: Request, t: float, k: int) -> None:
        h = self._handles.get(id(req))
        if h is not None:
            h._event(kind, t, k)

    # --------------------------------------------------------------- submit
    def submit(
        self,
        prompt_or_len: Union[int, "np.ndarray", List[int]],
        options: Optional[SubmitOptions] = None,
        *,
        on_first_token=None,
        on_emit=None,
        on_preempt=None,
        on_finish=None,
    ) -> StreamHandle:
        """Submit a prompt (token ids for real engines, or just a length
        for simulation) and get back its live token stream."""
        opts = options if options is not None else SubmitOptions()
        if isinstance(prompt_or_len, (int, np.integer)):
            prompt_len, prompt_tokens = int(prompt_or_len), None
        else:
            prompt_tokens = np.asarray(prompt_or_len, np.int32)
            prompt_len = int(prompt_tokens.size)
        arrival = (float(opts.arrival) if opts.arrival is not None
                   else float(self.backend.now))
        while self._next_rid in self._rids:    # skip rids trace replays took
            self._next_rid += 1
        req = Request(
            rid=self._next_rid,
            arrival=arrival,
            prompt_len=prompt_len,
            output_len=int(opts.max_tokens),
            spec=opts.spec,
            prompt_tokens=prompt_tokens,
            tenant=opts.tenant,
            priority=opts.priority,
            contract=opts.contract,
        )
        self._next_rid += 1
        return self.submit_request(
            req, on_first_token=on_first_token, on_emit=on_emit,
            on_preempt=on_preempt, on_finish=on_finish,
        )

    def submit_request(
        self,
        req: Request,
        *,
        on_first_token=None,
        on_emit=None,
        on_preempt=None,
        on_finish=None,
    ) -> StreamHandle:
        """Submit a pre-built Request (e.g. from the repro_torch.workload trace
        generators) — the migration path for benchmark/trace replays."""
        if req.rid in self._rids:
            # per-rid reporting (and admission's defer bookkeeping) keys on
            # rid; a silent duplicate would conflate two live requests
            raise ValueError(f"rid {req.rid} is already in use on this "
                             "client session")
        h = StreamHandle(self, req)
        h.on_first_token = on_first_token
        h.on_emit = on_emit
        h.on_preempt = on_preempt
        h.on_finish = on_finish
        self._handles[id(req)] = h
        self._rids.add(req.rid)
        self.backend.submit(req)
        return h

    def cancel(self, handle_or_rid) -> bool:
        """Abort a submitted stream (a StreamHandle or its rid). Only
        meaningful on backends exposing `cancel(rid)` (ServingSimulator /
        ServingEngine); returns False when unsupported, unknown, or the
        request already finished."""
        rid = getattr(handle_or_rid, "rid", handle_or_rid)
        backend_cancel = getattr(self.backend, "cancel", None)
        if backend_cancel is None:
            return False
        return bool(backend_cancel(int(rid)))

    # -------------------------------------------------------------- driving
    def step(self, until: Optional[float] = None) -> bool:
        """Advance the backend by one event/iteration (False = drained).

        `until`: forwarded to backends that support it (the hot-path
        engine bounds its multi-step decode block so the clock crosses
        `until` at a single indivisible iteration — see
        ServingEngine.step). Requests already submitted need no bound:
        the engine stops fused blocks at its own pending queue. Pass it
        only when you plan to submit a request with an explicit future
        `arrival` AFTER stepping past it — without the bound, a fused
        block commits several iterations per call, so the clock (and the
        admission boundary of that later submit) can land further along
        than a baseline engine driven by the same call sequence."""
        if until is None:
            return self.backend.step()
        return self.backend.step(until=until)

    def drain(self) -> List[StreamHandle]:
        """Serve everything submitted so far to completion."""
        while self.backend.step():
            pass
        return self.handles()

    def serve(self, workload: List[Request]):
        """Trace replay as a one-liner: submit a pre-built workload (in
        arrival order, matching the backends' own run() semantics), drain,
        and return the backend's native result. What the benchmarks and
        cluster examples drive with."""
        for r in sorted(workload, key=lambda r: r.arrival):
            self.submit_request(r)
        self.drain()
        return self.result()

    # ------------------------------------------------------------ reporting
    def handles(self) -> List[StreamHandle]:
        return list(self._handles.values())

    @property
    def now(self) -> float:
        return float(self.backend.now)

    def result(self):
        """The backend's native result snapshot (SimResult for single
        backends, ClusterResult for a cluster)."""
        return self.backend.result()

    def avg_qoe(self) -> float:
        """Mean Eq. 1 QoE across every stream (shed streams count 0)."""
        hs = self.handles()
        return float(np.mean([h.qoe() for h in hs])) if hs else 1.0


__all__ = ["ServingClient", "SubmitOptions", "DEFAULT_SPEC"]
