"""The scheduling-policy arena's shared foundation.

`SchedulingPolicy` is the formal protocol extracted from what the
backends (simulator / engine / speculative engine / cluster replicas)
actually consume of `AndesScheduler`: candidate set in (`schedule(now,
live, fluid)`), batch out — the victim set is implicit as "running
requests not in the returned batch" — with all QoE math priced through
the policy's bound `QoEPricer`. Any object satisfying the protocol can
drive every backend unchanged; `Scheduler` below is the concrete base
class all in-repo policies share (bookkeeping, pricing surface,
observability, the §4.2 #4 preemption-cap enforcement, and `reset()`
for rerun reproducibility).

The concrete policies live beside this module:

  baselines.py   FCFS (vLLM-style) and Round-Robin (paper §6.1)
  andes.py       the paper's QoE knapsack (greedy Algorithm 1 + DP)
  fair.py        VTC virtual-token-counter and FAIRSERVE-style weighted-
                 service-counter per-tenant fairness
  burst.py       TokenFlow-style burst-preemptive buffer-slack policy
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.pricing import QoEPricer
from repro_torch.core.qoe import FluidQoE
from repro_torch.core.request import Request, ReqState


@dataclasses.dataclass
class SchedulerConfig:
    delta_t: float = 50.0            # prediction horizon Δt (s) (§6.5: insensitive >50)
    preemption_cap: float = 1.0      # P: avg preemptions per request (§4.2 #4)
    memory_watermark: float = 0.9    # high-memory trigger (§4.2 #1)
    objective: str = "avg_qoe"
    num_batch_candidates: int = 12   # B grid size within [B_min, B_max]
    state_equiv_tokens: int = 0      # SSM archs: constant weight per request
    page_size: int = 0               # paged KV: knapsack weights / capacity
                                     # views round up to page multiples so
                                     # the memory trigger and packing see
                                     # what admission will actually charge
                                     # (0 = token-granular, the legacy view)
    prefill_chunk: int = 0           # chunked prefill: serve-delay pricing
                                     # charges per-chunk costs instead of one
                                     # monolithic prefill (0 = unchunked)
    min_remaining_est: float = 64.0  # floor on l̂ − emitted (length estimator)
    stickiness: float = 0.02         # priority bonus for running requests
                                     # (hysteresis: suppresses preemption churn
                                     # when gains are near-tied)


@runtime_checkable
class SchedulingPolicy(Protocol):
    """What a backend requires of a scheduler — the arena contract.

    Every member below is consumed by at least one backend: `schedule`
    each iteration (the decision), `idle_steps`/`skip_iterations` by the
    engine's multi-step fast path, the `on_*`/`record_preemptions` hooks
    by the serving loops, `pricer`/`lat`/`M`/`cfg`/`mean_output_len` by
    the fleet router/admission/autoscaler, `obs` by the observability
    rewiring, and `reset()` by backend `reset()` (rerun reproducibility).
    """

    name: str
    M: int
    lat: LatencyModel
    cfg: SchedulerConfig
    pricer: QoEPricer
    obs: Optional[object]
    iteration: int
    total_preemptions: int
    total_requests: int

    def schedule(self, now: float, live: List[Request],
                 fluid: FluidQoE) -> List[Request]: ...

    def idle_steps(self, live: List[Request], max_steps: int) -> int: ...

    def skip_iterations(self, k: int) -> None: ...

    def on_request_arrival(self, req: Request) -> None: ...

    def on_request_finish(self, req: Request) -> None: ...

    def record_preemptions(self, n: int) -> None: ...

    def reset(self) -> None: ...

    @property
    def mean_output_len(self) -> float: ...


class Scheduler:
    """Base: subclasses return the set of requests that should run next."""

    name = "base"
    # True when the policy bounds avg preemptions/request by
    # cfg.preemption_cap via `_apply_preemption_cap` (§4.2 #4). Counter/
    # rotation policies preempt by design (VTC reorders on every counter
    # crossing, round-robin on every rotation) and do not take the cap;
    # the conformance suite reads this flag to know what to pin.
    enforces_preemption_cap = False

    def __init__(self, kv_capacity: int, lat: LatencyModel,
                 cfg: Optional[SchedulerConfig] = None):
        self.M = kv_capacity
        self.lat = lat
        self.cfg = cfg or SchedulerConfig()
        # the single QoE-pricing surface (core.pricing): the knapsack,
        # the fleet router, admission control, and the autoscaler all price
        # marginal QoE through this object. Bound to the scheduler so later
        # re-pointing of self.lat / self.M (backend factories do both) is
        # seen by every consumer.
        self.pricer = QoEPricer(self)
        # observability (repro.obs): wired by the owning backend's
        # `_rewire_obs`; None = off. Decision events are emitted through
        # `_record_decision` so the payload is only built when observed.
        self.obs = None
        self.reset()

    def reset(self) -> None:
        """Return to the just-constructed state (policy state included —
        subclasses clear their own counters/queues and call super()).
        Backends call this from their own `reset()` so a rerun on the
        same backend reproduces the first run bit-for-bit."""
        self.iteration = 0
        self.total_preemptions = 0
        self.total_requests = 0
        # running estimate of the response length l̂ (Eq. 1 cap; the true l
        # is unknown online — paper §2.3(a))
        self._len_sum = 0.0
        self._len_n = 0

    def on_request_finish(self, req: Request) -> None:
        self._len_sum += req.generated
        self._len_n += 1

    @property
    def mean_output_len(self) -> float:
        return (self._len_sum / self._len_n) if self._len_n >= 10 else 256.0

    # -- bookkeeping helpers -------------------------------------------------
    def _kv_weight(self, r: Request) -> int:
        """One request's KV footprint as the capacity view prices it:
        token-granular by default; rounded up to whole pages when the
        backend's KV manager is paged (cfg.page_size), so the knapsack /
        memory trigger charge what allocation will actually take from the
        pool. page_size=0 reproduces the legacy integers bit-for-bit."""
        w = r.kv_tokens(self.cfg.state_equiv_tokens)
        p = self.cfg.page_size
        if p > 1:
            return -(-w // p) * p
        return w

    def _weights(self, reqs: Sequence[Request]) -> np.ndarray:
        return np.array([self._kv_weight(r) for r in reqs], np.int64)

    def on_request_arrival(self, req: Request) -> None:
        self.total_requests += 1

    def record_preemptions(self, n: int) -> None:
        self.total_preemptions += n

    def _record_decision(self, now: float, live: Sequence[Request],
                         chosen: Sequence[Request],
                         info: Optional[dict] = None) -> None:
        """Emit one `schedule` observability event (no-op when
        unobserved): which requests were chosen, which running requests
        became victims, plus any policy-specific pricing payload."""
        obs = self.obs
        if obs is None:
            return
        chosen_ids = {id(r) for r in chosen}
        victims = [r.rid for r in live
                   if r.state == ReqState.RUNNING
                   and id(r) not in chosen_ids]
        payload = {
            "policy": self.name,
            "iteration": int(self.iteration),
            "n_live": len(live),
            "n_chosen": len(chosen),
            "chosen": [r.rid for r in chosen],
            "victims": victims,
        }
        if info:
            payload.update(info)
        obs.schedule(now, payload)

    def schedule(self, now: float, live: List[Request], fluid: FluidQoE
                 ) -> List[Request]:
        raise NotImplementedError

    def idle_steps(self, live: List[Request], max_steps: int) -> int:
        """How many consecutive future iterations this scheduler GUARANTEES
        it would be a pure pass-through — i.e. schedule() would return the
        full live set with no decision (no knapsack, no preemption, no
        rotation) — assuming every live request is RUNNING, none finishes,
        and no arrival lands in the window (the engine checks those).

        This is the legality certificate for the engine's multi-step decode
        fast path (§4.2 #1 turned into a skip): the engine may fuse up to
        idle_steps()+1 decode iterations into one device dispatch and
        replay the skipped schedule() calls as `iteration += k` bookkeeping.
        The base scheduler (and any stateful policy like round-robin or the
        fairness counters) answers 0: never skip me.

        Certificate contract (the device-resident persistent
        loop spends it in three ways, all of which a policy's answer
        must stay sound for):

        * **Unquantized:** `decode_persistent` takes the fused length as
          loop DATA, so the certificate is consumed at full resolution —
          a policy must not assume the engine rounds it down.
        * **Token-denominated under speculation:** a speculative verify
          round commits 1..k+1 tokens per slot, so the engine asks for
          `max_steps = s·(k+1) - 1` single-token iterations and runs
          `s` rounds — the projection must therefore be sound per TOKEN
          of growth, not per scheduler invocation. (The acceptance EMA
          may drift inside the block; the engine separately re-checks
          any EMA-dependent trigger at its worst case, so `idle_steps`
          itself may price the current EMA.)
        * **Page pre-reservation bound:** physically paged engines
          reserve every page the block can write BEFORE dispatch, so a
          paged projection (see AndesScheduler) must count the rounded
          page demand of `+max_steps` tokens per running request — an
          over-grant here is not a soft miss but a pool overdraft the
          engine refuses to serve."""
        return 0

    def skip_iterations(self, k: int) -> None:
        """Replay `k` skipped pass-through schedule() calls (multi-step
        decode committed k+1 iterations off one schedule decision)."""
        self.iteration += k

    # -- shared packing / cap enforcement ------------------------------------
    def _pack_in_order(self, ordered: Sequence[Request]) -> List[Request]:
        """Greedy prefix packing under the KV budget M in the given
        priority order (skipping requests that no longer fit — arena
        policies that rank by counters/slack use this; FCFS keeps its own
        head-of-line-blocking admission verbatim)."""
        used = 0
        keep: List[Request] = []
        for r in ordered:
            w = self._kv_weight(r)
            if used + w <= self.M:
                keep.append(r)
                used += w
        return keep

    def _apply_preemption_cap(self, chosen, running, weights, live):
        """Optimization #4 (§4.2): keep average preemptions/request ≤ P by
        sparing would-be victims (cheapest-context first) when the budget
        is exhausted, then re-enforcing memory by dropping admitted
        non-running requests."""
        preempted = [r for r in running if r not in chosen]
        if not preempted:
            return chosen
        budget = self.cfg.preemption_cap * max(self.total_requests, 1) \
            - self.total_preemptions
        allowed = max(int(budget), 0)
        if len(preempted) <= allowed:
            return chosen
        # keep the lowest-context (cheapest-to-keep) would-be victims running
        preempted.sort(key=lambda r: r.context_len)
        spared = preempted[: len(preempted) - allowed]
        chosen = list(chosen) + spared
        # re-enforce memory by dropping admitted (non-running) requests
        used = 0
        final: List[Request] = []
        # running first (sparing them is the point), then the rest
        for r in sorted(chosen, key=lambda r: r.state != ReqState.RUNNING):
            w = self._kv_weight(r)
            if used + w <= self.M:
                final.append(r)
                used += w
        return final
