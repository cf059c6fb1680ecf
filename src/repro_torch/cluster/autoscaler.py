"""QoE-SLO autoscaler: grow/shrink the replica fleet with demand.

The paper fixes the deployment (one engine, §6.1) and asks how much QoE a
scheduler can extract from it; the ROADMAP's production north star also
needs the converse knob — how much hardware does a QoE target cost? The
autoscaler closes that loop with the fleet-level SLO-attainment signal
(repro_torch.core.objectives.fleet_slo_attainment, §6.1's capacity metric):

  * scale UP   when windowed SLO attainment drops below `slo_low` or the
    fleet KV overcommit exceeds `util_high` — new replicas come from a
    bounded capacity pool after `provision_delay` (model load, cache warm).
  * scale DOWN when attainment sits above `slo_high` with KV utilization
    under `util_low` — the chosen replica *drains*: the router stops
    sending it traffic, its in-flight requests finish, then it returns to
    the pool (no QoE is sacrificed to shrink).

Decisions are rate-limited by `cooldown` to avoid thrash on bursty
arrivals (gamma cv=3 traces whipsaw instantaneous signals).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.pricing import weighted_attainment
from repro_torch.cluster.replica import Replica

SCALE_UP, SCALE_DOWN, REAP = "scale_up", "scale_down", "reap"


@dataclasses.dataclass
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 8
    slo_threshold: float = 0.9     # per-request QoE counted as "good" (§6.1)
    slo_low: float = 0.8           # attainment below this -> scale up
    slo_high: float = 0.98         # attainment above this (and idle) -> down
    util_high: float = 1.1         # fleet KV demand/capacity overcommit
    util_low: float = 0.45
    window: float = 30.0           # signal window (s)
    provision_delay: float = 15.0  # replica spin-up time (s)
    cooldown: float = 30.0         # min gap between scale decisions (s)


@dataclasses.dataclass
class ScaleEvent:
    t: float
    action: str                    # scale_up | scale_down | reap
    replica_id: int                # -1 for scale_up (id assigned on ready)
    signal: Optional[dict] = None  # attainment/utilization snapshot that
                                   # drove the decision (None for reaps —
                                   # those are consequences, not decisions)


class Autoscaler:
    """Emits scale decisions; the ClusterSimulator applies them."""

    def __init__(self, cfg: Optional[AutoscalerConfig] = None):
        self.cfg = cfg or AutoscalerConfig()
        self._last_decision = -np.inf
        self.events: List[ScaleEvent] = []
        self.pending_provisions: List[float] = []   # ready times

    # ---------------------------------------------------------------- signal
    def signal(self, now: float, replicas: Sequence[Replica]) -> dict:
        """Windowed fleet SLO attainment + instantaneous KV utilization.

        Attainment is the contract-weighted fraction of recently finished
        requests meeting their SLOContract (core.pricing.weighted_attainment
        — the same pricing surface the scheduler/router/admission use);
        `slo_threshold` is the QoE floor for uncontracted requests. With no
        contracts this is exactly the uniform §6.1 attainment signal."""
        lo = now - self.cfg.window
        finished = []
        for rep in replicas:
            for r in rep.backend.seen:
                if not r.is_live and lo <= r.finish_time <= now:
                    finished.append(r)
        attain = weighted_attainment(finished, self.cfg.slo_threshold)
        demand = sum(rep.kv_demand() for rep in replicas if not rep.draining)
        capacity = sum(rep.kv_capacity for rep in replicas if not rep.draining)
        return {
            "slo_attainment": attain,
            "kv_utilization": demand / max(capacity, 1),
            "n_finished": len(finished),
        }

    # -------------------------------------------------------------- decision
    def evaluate(self, now: float, replicas: Sequence[Replica]) -> List[ScaleEvent]:
        """Returns the scale actions to apply at `now` (may be empty)."""
        cfg = self.cfg
        out: List[ScaleEvent] = []

        active = [r for r in replicas if not r.draining]
        n_effective = len(active) + len(self.pending_provisions)
        if now - self._last_decision < cfg.cooldown:
            self.events.extend(out)
            return out

        sig = self.signal(now, replicas)
        overloaded = (sig["slo_attainment"] < cfg.slo_low
                      or sig["kv_utilization"] > cfg.util_high)
        idle = (sig["slo_attainment"] > cfg.slo_high
                and sig["kv_utilization"] < cfg.util_low)

        if overloaded and n_effective < cfg.max_replicas:
            self.pending_provisions.append(now + cfg.provision_delay)
            self._last_decision = now
            out.append(ScaleEvent(now, SCALE_UP, -1, signal=sig))
        elif idle and len(active) > cfg.min_replicas:
            # drain the least-loaded active replica (cheapest to finish)
            victim = min(active, key=lambda r: (r.kv_demand(), -r.id))
            victim.drain()
            self._last_decision = now
            out.append(ScaleEvent(now, SCALE_DOWN, victim.id, signal=sig))

        self.events.extend(out)
        return out

    def record_reap(self, now: float, replica: Replica) -> None:
        """A drained replica returns to the capacity pool (called by the
        ClusterSimulator at the moment of retirement — draining can finish
        at any point of the event loop, including inside the very decision
        that started it when the victim was already idle)."""
        replica.drained_at = now
        self.events.append(ScaleEvent(now, REAP, replica.id))

    def take_ready_provisions(self, now: float) -> int:
        """Number of provisioned replicas ready by `now` (consumed)."""
        ready = [t for t in self.pending_provisions if t <= now]
        self.pending_provisions = [t for t in self.pending_provisions
                                   if t > now]
        return len(ready)
