"""Fleet routers: which replica does a request land on?

Extends the paper's intra-engine QoE scheduling (§4, Eq. 2 gains) one
level up, in the spirit of DiSCo's dispatching across endpoints
(PAPERS.md, arXiv 2502.11417): the same fluid QoE machinery that prices a
*batch slot* inside one engine prices a *placement* across engines.

Policies:
  * round_robin — classic stateless spreading.
  * jsq         — join-shortest-queue on committed request count
                  (deterministic tie-break: lowest replica id).
  * qoe         — two-level decision. The *predicted marginal fleet QoE
                  gain* of the placement (marginal_qoe_gain: the
                  newcomer's own achievable QoE after KV-overcommit and
                  prefill-backlog delays, minus the fluid-predicted
                  degradation of the replica's live requests) decides
                  whenever replicas diverge by more than `gain_quantum` —
                  a saturated or memory-full replica loses here. Within a
                  gain tie, load balances on the *capability-normalized*
                  queue (committed count over the replica's roofline token
                  rate): on a heterogeneous fleet an A40 with the same
                  queue as an A100 is ~2.5x busier, which count-based JSQ
                  cannot see.

An empirical note that shaped this design (the reference's
benchmarks/cluster_qoe.py):
with the QoE-aware Andes scheduler *inside* each replica absorbing
placement imperfections (preempting lenient requests under pressure), the
fleet's average QoE is remarkably insensitive to spatial routing among
equally-capable replicas — fancy open-loop placement models lose to plain
queue feedback. The router's edge comes from pricing what feedback cannot
see: replica capability (LatencyModel) and imminent saturation
(FluidQoE-predicted gains).

Every policy sees only `Replica` snapshots/state; none mutate replica
fluid state (the QoE policy queries a clone), preserving the 1-replica
bit-for-bit invariance with the single-node simulator.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.core import pricing
from repro_torch.core.pricing import request_weight, shared_token_rate  # noqa: F401
from repro_torch.core.request import Request
from repro_torch.cluster.replica import Replica

# `shared_token_rate` moved to repro_torch.core.pricing (the one QoEPricer
# surface); re-exported above for existing callers.


@dataclasses.dataclass
class RouterConfig:
    horizon: float = 30.0           # prediction horizon Δt (s), fleet scale
    min_remaining_est: float = 64.0  # floor on l̂ − emitted (as scheduler)
    gain_quantum: float = 0.25      # gains within this are considered tied
                                    # and fall through to the normalized-
                                    # queue tiebreak. Gains are decisive
                                    # only for genuine saturation gaps; a
                                    # small quantum would let model noise
                                    # override load feedback (and below
                                    # saturation every replica predicts
                                    # gain 1.0, so with no tiebreak the
                                    # argmax herds onto one replica)


@dataclasses.dataclass
class RouteDecision:
    replica: Replica
    gain: Optional[float] = None    # predicted marginal fleet QoE gain
    scores: Optional[dict] = None   # replica id -> score (qoe policy)


def marginal_qoe_gain(
    replica: Replica,
    req: Request,
    now: float,
    cfg: RouterConfig,
) -> float:
    """Predicted fleet QoE change of placing `req` on `replica` now:

      gain = weight · Q̂_new  −  Σ_live (Q̂_without − Q̂_with)

    The math lives in repro_torch.core.pricing.placement_gain — the same
    implementation the scheduler knapsack and admission controller price
    with. `weight` is the request's contract/priority pricing weight
    (1.0 for uncontracted traffic — the uniform gain, bit-for-bit). On an
    idle replica gain ≈ weight (full QoE, nobody hurt); on a saturated
    one it goes negative — the admission controller's shed signal.
    """
    return pricing.placement_gain(
        replica, req, now,
        horizon=cfg.horizon,
        min_remaining_est=cfg.min_remaining_est,
        weight=request_weight(req),
    )


class Router:
    """Base router. `route` never returns a draining replica."""

    name = "base"

    def __init__(self, cfg: Optional[RouterConfig] = None):
        self.cfg = cfg or RouterConfig()

    def route(self, req: Request, replicas: Sequence[Replica],
              now: float) -> RouteDecision:
        raise NotImplementedError


class RoundRobinRouter(Router):
    name = "round_robin"

    def __init__(self, cfg: Optional[RouterConfig] = None):
        super().__init__(cfg)
        self._next = 0

    def route(self, req, replicas, now):
        rep = replicas[self._next % len(replicas)]
        self._next += 1
        return RouteDecision(rep)


class JSQRouter(Router):
    """Join-shortest-queue on committed (live + pending) request count;
    ties go to the lowest replica id (deterministic)."""

    name = "jsq"

    def route(self, req, replicas, now):
        rep = min(replicas, key=lambda r: (len(r.committed()), r.id))
        # scores = the queue depths the decision was taken on, so route
        # trace events are explainable for every policy, not just "qoe".
        return RouteDecision(
            rep, scores={r.id: float(len(r.committed())) for r in replicas})


REFERENCE_BATCH = 16


def capability(replica: Replica) -> float:
    """Roofline token supply (tokens/s) of the replica's hardware at a
    fixed reference batch — a pure per-replica constant, independent of
    current load. Used to normalize queue depth across a heterogeneous
    fleet (4xA100 vs 4xA40 differ ~2.5x)."""
    return REFERENCE_BATCH * replica.lat.token_rate(REFERENCE_BATCH)


def normalized_queue(replica: Replica) -> float:
    """Committed request count over hardware capability: the queue depth
    in units of 'seconds of work per expected token', comparable across
    replicas of different speed."""
    return len(replica.committed()) / max(capability(replica), 1e-9)


class QoEAwareRouter(Router):
    name = "qoe"

    def route(self, req, replicas, now):
        gains = {r.id: marginal_qoe_gain(r, req, now, self.cfg)
                 for r in replicas}
        # lexicographic: quantized gain first; near-ties fall through to
        # the capability-normalized queue, then to the lowest replica id.
        # An additive load penalty would override genuine gain differences
        # under saturation — exactly when the gain signal matters most.
        quantum = max(self.cfg.gain_quantum, 1e-9)
        key = {
            r.id: (round(gains[r.id] / quantum),
                   -normalized_queue(r),
                   -r.id)
            for r in replicas
        }
        best = max(replicas, key=lambda r: key[r.id])
        return RouteDecision(best, gain=gains[best.id], scores=gains)


ROUTERS = {
    "round_robin": RoundRobinRouter,
    "jsq": JSQRouter,
    "qoe": QoEAwareRouter,
}


def make_router(name: str, cfg: Optional[RouterConfig] = None) -> Router:
    return ROUTERS[name](cfg)
