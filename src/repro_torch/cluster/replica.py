"""Replica: one serving engine behind a uniform submit/step/drain API.

Extends the paper's single-engine scope (§4–§6 run ONE continuous-batching
instance) to the fleet: a `Replica` wraps a backend with its own scheduler,
KV capacity, and fluid QoE state, and exposes exactly what the cluster
layer needs — enqueue a routed request, advance the replica's clock, and
report load/QoE snapshots for routing decisions.

The default backend is the discrete-event `ServingSimulator`; anything
satisfying `SteppableBackend` (notably a stepped `ServingEngine` running
the port's PyTorch model) plugs in unchanged, because the cluster layer only ever
talks through this protocol.
"""
from __future__ import annotations

from typing import List, Optional, Protocol, runtime_checkable

from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.qoe import FluidQoE
from repro_torch.core.request import Request
from repro_torch.core.scheduler import Scheduler
from repro_torch.serving.simulator import ServingSimulator, SimResult


@runtime_checkable
class SteppableBackend(Protocol):
    """Minimal engine surface the cluster layer depends on.

    Satisfied structurally by both `ServingSimulator` (discrete-event) and
    `ServingEngine` (the port's PyTorch model, virtual clock) — see
    `repro_torch.cluster.backends` for the factories that build either per
    replica. runtime_checkable so tests can assert conformance with
    isinstance (presence-of-members check)."""
    sched: Scheduler
    fluid: FluidQoE
    live: List[Request]
    pending: List[Request]       # submitted, not yet admitted to the batch
    seen: List[Request]          # every request ever submitted
    now: float
    has_work: bool

    def submit(self, req: Request) -> None: ...
    def step(self, until: Optional[float] = None) -> bool: ...
    def result(self) -> SimResult: ...

    # Observability (repro_torch.obs): assignable effective-observer slot. Both
    # shipped backends also expose `observer`/`event_sink` properties and
    # `attach_observer`; the cluster layer only *assigns* `observer`, so a
    # minimal third-party backend may accept it as a plain attribute and
    # simply never call the hooks (observability degrades to silence, not
    # to a crash).
    observer: object


class Replica:
    """One engine instance in the fleet."""

    def __init__(
        self,
        replica_id: int,
        backend: SteppableBackend,
        lat: LatencyModel,
        *,
        launched_at: float = 0.0,
    ):
        self.id = replica_id
        self.backend = backend
        self.lat = lat
        self.launched_at = launched_at
        self.draining = False
        self.drained_at: Optional[float] = None
        self.n_routed = 0

    # -------------------------------------------------------------- lifecycle
    def submit(self, req: Request) -> None:
        if self.draining:
            raise RuntimeError(f"replica {self.id} is draining")
        self.n_routed += 1
        self.backend.submit(req)

    def step(self, until: Optional[float] = None) -> bool:
        return self.backend.step(until=until)

    def advance_to(self, t: float) -> None:
        """Run iterations until the replica's clock reaches t (or idle).
        Iterations are indivisible (continuous batching), so the clock may
        overshoot t — identical to how a single engine admits arrivals at
        the next iteration boundary. `t` is passed down as the backend's
        `until` bound so an engine's multi-step decode never fuses past
        the upcoming routed arrival: the crossing remains one indivisible
        iteration, keeping routed timelines bit-identical to
        submit-everything-upfront runs."""
        while self.backend.has_work and self.backend.now < t:
            if not self.step(until=t):
                break

    def drain(self) -> None:
        """Stop accepting new requests; in-flight requests finish."""
        self.draining = True

    @property
    def drained(self) -> bool:
        return self.draining and not self.backend.has_work

    # ------------------------------------------------------------------ views
    @property
    def clock(self) -> float:
        return self.backend.now

    @property
    def has_work(self) -> bool:
        return self.backend.has_work

    @property
    def live(self) -> List[Request]:
        return self.backend.live

    @property
    def pending(self) -> List[Request]:
        return self.backend.pending

    def committed(self) -> List[Request]:
        """Live + pending: every request this replica is on the hook for.
        Routing decisions during a burst happen faster than the replica
        steps, so load views must count work that was just routed here even
        though the engine has not admitted it yet (otherwise every policy
        herds the whole burst onto one replica)."""
        return self.backend.live + self.backend.pending

    @property
    def fluid(self) -> FluidQoE:
        return self.backend.fluid

    @property
    def kv_capacity(self) -> int:
        return self.backend.sched.M

    def kv_demand(self) -> int:
        st = self.backend.sched.cfg.state_equiv_tokens
        return sum(r.kv_tokens(st) for r in self.committed())

    def result(self) -> SimResult:
        return self.backend.result()

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        flag = " draining" if self.draining else ""
        return (f"Replica({self.id}, t={self.clock:.2f}, "
                f"live={len(self.live)}{flag})")
