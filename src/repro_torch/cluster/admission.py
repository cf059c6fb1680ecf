"""Admission control: shed or defer requests the fleet cannot serve well.

Paper §6.4 shows single-engine Andes degrading gracefully under surge by
favoring salvageable requests; fleet-wide the same logic argues some
requests should not be admitted at all — admitting a request whose own
achievable QoE is lower than the QoE it destroys across the chosen
replica's batch makes the *fleet total* worse (TokenFlow, arXiv
2510.02758, makes the matching observation for burst preemption). The
controller prices admission through the one QoEPricer surface
(repro_torch.core.pricing — the same implementation the scheduler knapsack and
the router consume), contract-weighted per tenant:

  gain = weight · Q̂_new − Σ degradation of live requests

  gain > min_gain           → admit
  gain ≤ min_gain, defer    → retry `defer_delay`s later (bounded retries;
                              the user keeps waiting, so their QoE clock —
                              Request.arrival — keeps running)
  gain ≤ min_gain, shed     → reject now (QoE 0, counted in fleet metrics)

`weight` is the request's SLOContract/priority pricing weight
(core.pricing.request_weight): a weight-2 tenant's achievable QoE counts
double against the harm its admission does, so under surge the fleet
sheds the low-weight tail first. Uncontracted traffic weighs 1.0, which
reproduces the uniform `min_gain` threshold bit-for-bit
(the reference's tests/test_api.py pins the reduction).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.request import Request
from repro_torch.cluster.router import RouteDecision, RouterConfig, marginal_qoe_gain

ADMIT, SHED, DEFER = "admit", "shed", "defer"


@dataclasses.dataclass
class AdmissionConfig:
    policy: str = "none"          # "none" | "shed" | "defer"
    min_gain: float = 0.0         # admit iff marginal fleet QoE gain > this
    defer_delay: float = 2.0      # seconds between retries
    max_defers: int = 3           # retries before a deferred request sheds


class AdmissionController:
    def __init__(self, cfg: Optional[AdmissionConfig] = None,
                 router_cfg: Optional[RouterConfig] = None):
        self.cfg = cfg or AdmissionConfig()
        self.router_cfg = router_cfg or RouterConfig()
        self._defers: Dict[int, int] = {}     # rid -> retry count
        self.n_shed = 0
        self.n_defer_events = 0

    def counters(self) -> Dict[str, int]:
        """Decision tallies for observability (metrics gauges / reports)."""
        return {
            "shed": self.n_shed,
            "defer_events": self.n_defer_events,
            "deferred_requests": len(self._defers),
        }

    def decide(self, req: Request, decision: RouteDecision,
               now: float) -> str:
        """ADMIT/SHED/DEFER for `req` given the router's chosen placement."""
        if self.cfg.policy == "none":
            return ADMIT
        gain = decision.gain
        if gain is None:   # router didn't price the placement (rr/jsq)
            gain = marginal_qoe_gain(decision.replica, req, now,
                                     self.router_cfg)
        if gain > self.cfg.min_gain:
            return ADMIT
        if (self.cfg.policy == "defer"
                and self._defers.get(req.rid, 0) < self.cfg.max_defers):
            self._defers[req.rid] = self._defers.get(req.rid, 0) + 1
            self.n_defer_events += 1
            return DEFER
        self.n_shed += 1
        return SHED
