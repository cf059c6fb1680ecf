"""QoE pricing: ONE implementation of the paper's marginal-gain math.

Before this module existed, the Eq. 2 vocabulary — "what is the QoE value
of serving request i (at rate r, after delay d), against letting it wait?"
— was re-derived in four places: the scheduler knapsack (§4, per-batch
gains), the fleet router (per-placement gains), admission control
(gain-vs-threshold), and the autoscaler (SLO-attainment signal). Each
carried its own copy of the response-length estimator l̂ and the
serve-delay model, which is exactly how the copies drift apart.

Now every consumer prices through this module:

  * `QoEPricer` — bound to one scheduler (its LatencyModel, KV capacity
    M, and running l̂ estimate). The scheduler's knapsack calls
    `batch_pricing`/`serve_gains`; the router and admission controller
    call `placement_gain` for the fleet-level marginal gain of placing a
    request on a replica. Speculative replicas need no special-casing:
    the pricer asks the scheduler's LatencyModel for every pacing
    quantity, and a `SpeculativeLatencyModel` answers with expected
    1..k+1-token bursts folded in.
  * `SLOContract` — a per-tenant service contract (TTFT/TDS targets, the
    QoE floor that counts as "attained", and an attainment weight).
    Replaces the uniform admission threshold: admission prices the
    newcomer's QoE at `weight ×` its fleet value, and the autoscaler's
    attainment signal weighs each finished request by its contract.
    A request without a contract prices exactly as before (weight 1.0,
    fleet-default floor) — the uniform-threshold behavior is the
    `DEFAULT_CONTRACT` special case, bit-for-bit (tests/test_api.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.qoe import predict_request_qoe
from repro_torch.core.request import Request, ReqState


# ---------------------------------------------------------------------------
# Per-tenant SLO contracts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLOContract:
    """A tenant's service contract, priced fleet-wide.

    ttft_target / tds_target: hard attainment targets layered on top of
    the QoE floor (None = only the floor counts). qoe_floor: per-request
    QoE at or above which the request counts as attained (None = the
    fleet default, e.g. AutoscalerConfig.slo_threshold). weight: how much
    this tenant's QoE is worth in fleet pricing — admission admits a
    weight-w request iff  w·Q̂_new − Σ degradation > min_gain, and the
    autoscaler's attainment signal is the weight-w mean. weight=1.0 with
    no targets reproduces the pre-contract uniform behavior exactly.
    """
    ttft_target: Optional[float] = None   # seconds (None = not contracted)
    tds_target: Optional[float] = None    # tokens/s (None = not contracted)
    qoe_floor: Optional[float] = None     # None = fleet default threshold
    weight: float = 1.0                   # attainment / pricing weight


DEFAULT_CONTRACT = SLOContract()


def request_weight(req: Request) -> float:
    """Pricing weight of a request: its contract weight scaled by the
    priority class (class p counts (1+p)×; the default class 0 is the
    exact identity, so uncontracted traffic prices as before)."""
    w = req.contract.weight if req.contract is not None else 1.0
    return w * (1 + req.priority)


def request_weights(reqs: Sequence[Request]) -> np.ndarray:
    return np.array([request_weight(r) for r in reqs], np.float64)


def slo_attained(req: Request, default_floor: float) -> bool:
    """Did a finished request meet its contract (or the fleet default)?"""
    c = req.contract
    floor = default_floor if c is None or c.qoe_floor is None else c.qoe_floor
    ok = req.final_qoe() >= floor
    if c is not None and c.ttft_target is not None:
        ok = ok and req.final_ttft() <= c.ttft_target
    if c is not None and c.tds_target is not None:
        ok = ok and req.final_tds() >= c.tds_target
    return bool(ok)


def weighted_attainment(reqs: Sequence[Request], default_floor: float) -> float:
    """Contract-weighted SLO attainment (the autoscaler's feedback signal,
    §6.1 fleet-wide). With no contracts every weight is 1.0 and this is
    the plain fraction of requests at or above `default_floor`."""
    if not reqs:
        return 1.0
    w = request_weights(reqs)
    att = np.array([slo_attained(r, default_floor) for r in reqs], np.float64)
    return float((w * att).sum() / w.sum())


# ---------------------------------------------------------------------------
# Shared estimators (the formulas that used to be copy-pasted)
# ---------------------------------------------------------------------------

def expected_len(emitted: np.ndarray, mean_out: float,
                 min_remaining: float) -> np.ndarray:
    """l̂ per live request: emitted + max(E[len] − emitted, floor).
    (Eq. 1 caps the expected curve at l; the true l is unknown online.)"""
    return emitted + np.maximum(mean_out - emitted, min_remaining)


def expected_new_len(mean_out: float, min_remaining: float) -> float:
    """Scalar l̂ for a request that has not emitted anything yet."""
    return max(mean_out, min_remaining)


def shared_token_rate(
    lat,
    n_live: int,
    total_ctx: float,
    kv_capacity: int,
    state_equiv_tokens: int = 0,
) -> float:
    """Memory-capped, time-shared per-request decode rate (tokens/s).

    A replica with more live requests than fit in KV memory cannot decode
    them concurrently — the scheduler time-shares. The sustainable batch is
    capped by memory (b_mem = M / avg KV weight); the aggregate token rate
    at that batch is then split across *all* live requests. This is what
    makes the marginal cost of one more request real on a saturated
    replica (naive rate(b) vs rate(b+1) is near-zero at large b, which
    would admit forever — the tragedy of the commons the admission
    controller exists to prevent).
    """
    if n_live <= 0:
        return 0.0
    avg_ctx = total_ctx / n_live
    avg_w = state_equiv_tokens if state_equiv_tokens else avg_ctx
    b_mem = max(int(kv_capacity / max(avg_w, 1.0)), 1)
    b_eff = min(n_live, b_mem)
    agg = b_eff / lat.iter_latency(b_eff, int(b_eff * avg_ctx))
    return agg / n_live


# ---------------------------------------------------------------------------
# Fleet-level placement pricing (router + admission)
# ---------------------------------------------------------------------------

def placement_components(
    replica,
    req: Request,
    now: float,
    *,
    horizon: float,
    min_remaining_est: float,
) -> Tuple[float, float]:
    """(Q̂_new, degradation) of placing `req` on `replica` now.

    Q̂_new is the newcomer's predicted fluid QoE over the horizon and the
    degradation is Σ_live w_i·(Q̂_without − Q̂_with) across the replica's
    live requests — each victim's loss priced at its own contract weight
    (the same fleet objective serve_gains and weighted_attainment use;
    all-default weights multiply by exactly 1.0). Two harm channels are
    priced:

      * rate sharing — one more mouth shares the memory-capped token
        supply (shared_token_rate). Thanks to the paper's central slack
        (generation speed ≫ digest speed) this alone rarely hurts;
      * queueing — the newcomer's KV footprint pushes back the start time
        of every *waiting* request. Per-request the extra delay is tiny,
        but summed over a deep queue it outweighs the newcomer's own
        achievable QoE. This is the term that turns the gain negative
        under surge and makes admission control bite.
    """
    lat = replica.lat
    live = replica.live
    committed = replica.committed()      # live + routed-but-not-yet-admitted
    b = len(committed)
    ctx = sum(r.context_len for r in committed)
    t = max(now, replica.clock)
    dt = horizon
    mean_out = replica.backend.sched.mean_output_len
    st = replica.backend.sched.cfg.state_equiv_tokens
    M = replica.kv_capacity

    exp_new = expected_new_len(mean_out, min_remaining_est)
    demand = replica.kv_demand()
    footprint = req.kv_tokens(st) + (0 if st else int(exp_new))

    rate1 = shared_token_rate(lat, b + 1, ctx + req.prompt_len, M, st)
    # KV-overcommit queueing delay before a waiting request starts: excess
    # demand has to drain (at the aggregate token rate) before its KV fits
    wait1 = max(demand + footprint - M, 0) / max(rate1 * (b + 1), 1e-9)
    # prefill serialization: every committed-but-unprefilled request blocks
    # the engine for its prefill before the newcomer's can run (§2.2; on a
    # chunked-prefill engine the blocking is per chunk rather than per
    # prompt, but the total backlog drained ahead of the newcomer is the
    # same order — the monolithic sum stays the routing-level estimate).
    # During a burst this is the *leading* congestion
    # signal — KV and rate terms only move once damage is already done —
    # and it is hardware-aware (slow chips prefill slower).
    prefill_backlog = sum(
        lat.prefill_latency(r.context_len)
        for r in committed if not r.prefilled
    )

    # -- degradation of the replica's live requests -------------------------
    # (pending requests contribute to load above but have no fluid slot yet,
    # so only live requests enter the degradation sum)
    degradation = 0.0
    if live:
        rate0 = shared_token_rate(lat, b, ctx, M, st)
        wait0 = max(demand - M, 0) / max(rate0 * b, 1e-9)
        # compact copy of just the live slots (slots are grow-only; cloning
        # the full state would make routing O(total requests) per query)
        idx = np.array([r.fluid_idx for r in live])
        fluid = replica.fluid.clone_slots(idx)
        waiting = np.array([r.state != ReqState.RUNNING for r in live])
        e_len = expected_len(fluid.emitted, mean_out, min_remaining_est)
        d0 = np.where(waiting, wait0, 0.0)
        d1 = np.where(waiting, wait1, 0.0)
        q0 = fluid.predict_qoe(t, dt, rate0, delay=d0, exp_len=e_len)
        q1 = fluid.predict_qoe(t, dt, rate1, delay=d1, exp_len=e_len)
        degradation = float(np.sum(request_weights(live) * (q0 - q1)))

    # -- the newcomer's own predicted QoE -----------------------------------
    # The request's QoE clock runs from its *arrival* (Eq. 1), not from
    # this routing instant: a deferred request re-enters with dead time on
    # the clock, which must lower its achievable QoE here — otherwise every
    # retry would be re-scored as fresh and over-admitted. Shifting both
    # the delay and the horizon by `age` evaluates the same Eq. 1 window
    # [arrival, arrival + age + Δt] with delivery starting at age + delay.
    age = max(t - req.arrival, 0.0)
    delay = wait1 + prefill_backlog + lat.prefill_latency(req.prompt_len)
    q_new = predict_request_qoe(req.spec, age + delay, rate1, age + dt,
                                exp_new)
    return q_new, degradation


def placement_gain(
    replica,
    req: Request,
    now: float,
    *,
    horizon: float,
    min_remaining_est: float,
    weight: float = 1.0,
) -> float:
    """Predicted fleet QoE change of placing `req` on `replica` now:

      gain = weight · Q̂_new  −  Σ_live w_i · degradation_i

    On an idle replica gain ≈ weight (full QoE, nobody hurt); on a
    saturated one it goes negative — the admission controller's shed
    signal. `weight` is the request's contract/priority pricing weight
    (request_weight); 1.0 — the no-contract default — reproduces the
    uniform gain exactly.
    """
    q_new, degradation = placement_components(
        replica, req, now, horizon=horizon,
        min_remaining_est=min_remaining_est,
    )
    return weight * q_new - degradation


# ---------------------------------------------------------------------------
# Batch pricing (the scheduler knapsack's face of the pricer)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchPricing:
    """Per-iteration pricing state shared across candidate batch sizes."""
    idx: np.ndarray          # live -> fluid slot indices
    exp_len: np.ndarray      # l̂ per fluid slot
    q_wait: np.ndarray       # Q_wait per live request (rate 0)
    q_now: np.ndarray        # current fluid QoE per live request
    delays_slot: np.ndarray  # serve delay per fluid slot
    weights: np.ndarray      # contract/priority pricing weight per live req
    mean_ctx: float          # mean context length across live requests

    def summary(self) -> dict:
        """Compact JSON-able view of the iteration's pricing inputs — the
        payload the scheduler attaches to its `schedule` observability
        events (repro.obs), so a trace records *why* a knapsack decision
        was taken without carrying full per-request arrays."""
        return {
            "q_wait_mean": float(self.q_wait.mean()) if self.q_wait.size
            else 0.0,
            "q_now_mean": float(self.q_now.mean()) if self.q_now.size
            else 0.0,
            "mean_ctx": float(self.mean_ctx),
            "total_weight": float(self.weights.sum()),
        }


class QoEPricer:
    """The one QoE-pricing surface, bound to a scheduler.

    Reads the scheduler's LatencyModel, KV capacity and running l̂
    estimate *through* the scheduler (live references — backend factories
    legitimately re-point `sched.lat`/`sched.M` after construction, e.g.
    `speculative_backend` installs a SpeculativeLatencyModel; the pricer
    must follow). Consumers:

      scheduler  — batch_pricing() once per iteration + serve_gains()
                   per candidate batch size B (the knapsack item values)
      router     — placement_gain() per (replica, request) placement
      admission  — the same placement_gain(), contract-weighted
      autoscaler — weighted_attainment() over finished requests
    """

    def __init__(self, sched):
        self.sched = sched

    # live views through the owning scheduler
    @property
    def lat(self):
        return self.sched.lat

    @property
    def kv_capacity(self) -> int:
        return self.sched.M

    @property
    def mean_output_len(self) -> float:
        return self.sched.mean_output_len

    def serve_delay(self, r: Request) -> float:
        """Time before tokens start flowing if we serve this request.
        On a chunked-prefill backend (cfg.prefill_chunk) a partially
        prefilled resident is priced like any other request: by the
        chunks it still owes before its first token can flow — the
        knapsack sees an honest TTFT, not the RUNNING-state zero."""
        chunk = self.sched.cfg.prefill_chunk
        if r.state == ReqState.RUNNING:
            if chunk and r.prefill_cursor:
                return self.lat.chunked_prefill_latency(
                    r.context_len, chunk, start=r.prefill_cursor)
            return 0.0
        if r.state == ReqState.SWAPPED:
            d = self.lat.swap_latency(r.context_len)
            if chunk and r.prefill_cursor:
                d += self.lat.chunked_prefill_latency(
                    r.context_len, chunk, start=r.prefill_cursor)
            return d
        if chunk:
            return self.lat.chunked_prefill_latency(r.context_len, chunk)
        return self.lat.prefill_latency(r.prompt_len)

    def batch_pricing(self, now: float, live: List[Request],
                      fluid) -> BatchPricing:
        """Everything the knapsack needs that does not depend on B."""
        cfg = self.sched.cfg
        idx = np.array([r.fluid_idx for r in live])
        e_len = expected_len(fluid.emitted, self.mean_output_len,
                             cfg.min_remaining_est)
        q_wait = fluid.predict_qoe(now, cfg.delta_t, 0.0, exp_len=e_len)[idx]
        q_now = fluid.qoe_now(now, exp_len=e_len)[idx]
        delays_slot = np.zeros(fluid.arrival.size)
        delays_slot[idx] = [self.serve_delay(r) for r in live]
        return BatchPricing(
            idx=idx, exp_len=e_len, q_wait=q_wait, q_now=q_now,
            delays_slot=delays_slot, weights=request_weights(live),
            mean_ctx=float(np.mean([r.context_len for r in live])),
        )

    def serve_gains(self, now: float, fluid, bp: BatchPricing, b: int,
                    gain_fn) -> np.ndarray:
        """Knapsack item values at candidate batch size B: the objective
        over (Q_serve(B), Q_wait, Q_now), contract/priority-weighted
        (all-default weights are exactly 1.0 — bit-identical to the
        unweighted gains)."""
        return self.serve_gains_grid(now, fluid, bp, [int(b)], gain_fn)[0]

    def serve_gains_grid(self, now: float, fluid, bp: BatchPricing,
                         bs, gain_fn) -> np.ndarray:
        """Knapsack item values for a whole grid of candidate batch sizes
        in ONE vectorized pricing pass — the §4.2 #2/#3 hot path.

        The per-request terms (fluid state, serve delays, l̂, Q_wait,
        Q_now, contract weights) do not depend on B; only the hypothetical
        serving rate does. Pricing each of the ~12 candidates separately
        re-derived all of them per candidate; here the B axis is one numpy
        broadcast through `FluidQoE.predict_qoe_grid` (elementwise ⇒ each
        row bit-identical to the old per-B call, so the chosen batch — and
        every downstream emit timestamp — is unchanged). Returns
        (len(bs), n_live); gain_fn is applied per row because some
        objectives (max_min_qoe) reduce over the live axis internally."""
        cfg = self.sched.cfg
        rates = np.array([self.lat.token_rate(int(b), int(b * bp.mean_ctx))
                          for b in bs], np.float64)
        q_serve = fluid.predict_qoe_grid(
            now, cfg.delta_t, rates, bp.delays_slot, bp.exp_len
        )[:, bp.idx]
        return np.stack([
            gain_fn(q_serve[i], bp.q_wait, bp.q_now) * bp.weights
            for i in range(len(bs))
        ])


__all__ = [
    "SLOContract", "DEFAULT_CONTRACT",
    "request_weight", "request_weights",
    "slo_attained", "weighted_attainment",
    "expected_len", "expected_new_len", "shared_token_rate",
    "placement_components", "placement_gain",
    "BatchPricing", "QoEPricer",
]
