"""Per-tenant fairness policies: VTC and FAIRSERVE-style weighted WSC.

**VTC (virtual token counter).** Each tenant carries a counter of the
service it has received — `w_p` per prompt token at first admission,
`w_q` per decode token served. Every iteration the scheduler serves the
tenants with the *smallest* counters first, so a tenant that monopolized
the engine accumulates counter and yields to starved tenants; a newly
active tenant's counter is lifted to the minimum of the active counters
so idling can't bank credit. For continuously backlogged tenants the
counter gap stays bounded by one max-cost request — the fairness
invariant the property tests pin.

**WSC (weighted service counter).** The FAIRSERVE generalization: each
tenant is entitled to a *share* proportional to its contract weight
(`SLOContract.weight`, the same weight fleet pricing uses), and the
counter accumulates `cost / weight`. Under saturating load the served
token shares converge to the contract weights.

Both policies run greedy lowest-counter packing: running state earns no
priority, so an over-served tenant's requests are preempted for a
starved tenant's queue whenever memory is short — fairness is bought
with preemption churn, and the arena scoreboard prices that trade.
Service accounting is observational: the scheduler charges
`Request.generated` deltas between its own calls (plus the prompt at
first admission), which works identically on the simulator and the real
engine with no extra backend hooks.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.policies.base import Scheduler
from repro_torch.core.request import Request


class VTCScheduler(Scheduler):
    """Virtual-token-counter fair scheduler (per-tenant)."""

    name = "vtc"

    def __init__(self, kv_capacity, lat, cfg=None, *,
                 w_p: float = 1.0, w_q: float = 1.0,
                 counter_lift: bool = True):
        self.w_p = w_p
        self.w_q = w_q
        self.counter_lift = counter_lift
        super().__init__(kv_capacity, lat, cfg)

    def reset(self):
        super().reset()
        self.counters: Dict[int, float] = {}
        self._seen_tokens: Dict[int, int] = {}   # rid -> charged decode tokens
        self._prefill_charged: set = set()       # rids charged w_p * prompt

    # -- service accounting --------------------------------------------------
    def _tenant_weight(self, req: Request) -> float:
        """Service entitlement of the request's tenant (1.0 for VTC; WSC
        overrides with the contract weight)."""
        return 1.0

    def _charge(self, req: Request, cost: float) -> None:
        t = req.tenant
        self.counters[t] = self.counters.get(t, 0.0) \
            + cost / self._tenant_weight(req)

    def _settle(self, live: List[Request]) -> None:
        """Charge decode tokens served since the last call (observational:
        `generated` grew between schedule() calls / before finish)."""
        for r in live:
            seen = self._seen_tokens.get(r.rid, 0)
            if r.generated > seen:
                self._charge(r, self.w_q * (r.generated - seen))
                self._seen_tokens[r.rid] = r.generated

    def on_request_arrival(self, req: Request) -> None:
        super().on_request_arrival(req)
        if self.counter_lift and self.counters:
            floor = min(self.counters.values())
            self.counters[req.tenant] = max(
                self.counters.get(req.tenant, 0.0), floor)
        else:
            self.counters.setdefault(req.tenant, 0.0)

    def on_request_finish(self, req: Request) -> None:
        super().on_request_finish(req)
        # the final token is emitted after our last schedule() sighting
        seen = self._seen_tokens.pop(req.rid, 0)
        if req.generated > seen:
            self._charge(req, self.w_q * (req.generated - seen))
        self._prefill_charged.discard(req.rid)

    # -- the decision --------------------------------------------------------
    def schedule(self, now, live, fluid):
        """Greedy lowest-counter packing (the VTC discipline).

        Repeatedly admit the head-of-line request of the tenant with the
        smallest *live* counter until memory is full; prefill charges
        land the moment a request is admitted, so the very next pick
        already sees them. That mid-call visibility is what keeps the
        backlogged-tenant counter gap bounded by ONE max-cost request
        (the property test's invariant) — batching all of a tenant's
        admissions at one stale counter value would let the gap grow by
        several prompts per iteration. Running state earns no priority:
        an over-served tenant's running requests sort behind a starved
        tenant's queue and get preempted when memory is short — the
        fairness-vs-churn trade the arena measures."""
        self.iteration += 1
        self._settle(live)
        st = self.cfg.state_equiv_tokens
        heads: dict = {}                 # tenant -> FIFO of live requests
        for r in sorted(live, key=lambda q: (q.arrival, q.rid)):
            heads.setdefault(r.tenant, []).append(r)
        used = 0
        keep: List[Request] = []
        while heads:
            t = min(heads, key=lambda k: (self.counters.get(k, 0.0),
                                          heads[k][0].arrival,
                                          heads[k][0].rid))
            r = heads[t].pop(0)
            if not heads[t]:
                del heads[t]
            w = r.kv_tokens(st)
            if used + w > self.M:
                continue                 # skip; tenant's next may still fit
            keep.append(r)
            used += w
            if not r.prefilled and r.rid not in self._prefill_charged:
                self._charge(r, self.w_p * r.prompt_len)
                self._prefill_charged.add(r.rid)
        if self.obs is not None:
            active = [self.counters[t] for t in
                      sorted({r.tenant for r in live})
                      if t in self.counters]
            self._record_decision(now, live, keep, {
                "counter_min": min(active) if active else 0.0,
                "counter_max": max(active) if active else 0.0,
                "counter_gap": (max(active) - min(active)) if active else 0.0,
                "n_tenants": len(active),
            })
        return keep


class WSCScheduler(VTCScheduler):
    """FAIRSERVE-style weighted-service-counter scheduler.

    Identical machinery to VTC, but service is normalized by each
    tenant's contract weight: a weight-3 tenant's counter grows 3x slower
    per served token, so under saturation it receives ~3x the service of
    a weight-1 tenant — the max-min weighted fair share the SLO contracts
    promise. Tenant weights are learned from the requests themselves
    (first contract seen per tenant; default 1.0)."""

    name = "wsc"

    def reset(self):
        super().reset()
        self.tenant_weights: Dict[int, float] = {}

    def on_request_arrival(self, req: Request) -> None:
        w = req.contract.weight if req.contract is not None else 1.0
        self.tenant_weights.setdefault(req.tenant, max(w, 1e-9))
        super().on_request_arrival(req)

    def _tenant_weight(self, req: Request) -> float:
        return self.tenant_weights.get(req.tenant, 1.0)
