"""The paper's QoE-aware knapsack scheduler (§4).

Andes: at every continuous-batching iteration, choose the set of
requests to run next by solving the Exact-K-item knapsack

    max Σ gain_i(B) · x_i   s.t.  Σ x_i = B,  Σ l_i x_i ≤ M

over candidate batch sizes B ∈ [B_min, B_max], where
gain_i(B) = Q_serve,i(B) − Q_wait,i (Eq. 2; alternatives in objectives.py)
and l_i is the request's KV footprint in tokens. The production solver is
the greedy packing of Algorithm 1 (priority = gain_i / l_i); the optimal
3-D DP of Algorithm 2 is provided for comparison (fig18 benchmark).

Optimizations from §4.2 implemented here:
  #1 selective triggering   — solve only under memory or latency pressure
  #2 batch-size pruning     — B ∈ [B_min, B_max]
  #3 greedy packing         — O(N log N)
  #4 preemption cap         — average preemptions/request ≤ P

Speculative replicas: a decode step there costs draft(k)+verify(k) and
yields 1..k+1 tokens, so every pacing quantity the solver consumes —
token_rate for Q_serve(B), per_token_latency for the latency trigger,
max_batch_from_latency for B_min, prefill/swap delays for _serve_delay —
is asked of the LatencyModel, and a SpeculativeLatencyModel answers with
the expected-accepted-length already folded in (EMA of observed
acceptance). The scheduler code itself stays regime-agnostic.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core import objectives as obj_lib
from repro_torch.core.policies.base import Scheduler
from repro_torch.core.request import Request, ReqState


class AndesScheduler(Scheduler):
    """The paper's QoE-aware scheduler (greedy packing, Algorithm 1)."""

    name = "andes"
    solver = "greedy"
    enforces_preemption_cap = True

    def schedule(self, now, live, fluid):
        self.iteration += 1
        if not live:
            return []
        running = [r for r in live if r.state == ReqState.RUNNING]
        weights = self._weights(live)

        # ---- Optimization #1: selective triggering -----------------------
        if not self._triggered(live, running, weights):
            chosen = self._admit_all(live, weights)
            self._record_decision(now, live, chosen,
                                  {"triggered": False}
                                  if self.obs is not None else None)
            return chosen

        # ---- Optimization #2: batch size pruning --------------------------
        b_min, b_max = self._batch_bounds(live, weights)
        candidates = np.unique(
            np.linspace(b_min, b_max, self.cfg.num_batch_candidates)
            .round().astype(int)
        )

        # ---- evaluate objective over the candidate-B grid -----------------
        # all Eq. 2 math lives in the pricer (core.pricing) — the same
        # implementation the router/admission/autoscaler consume. The
        # per-request terms are invariant across candidates, so the whole
        # grid is priced in ONE vectorized pass (serve_gains_grid; rows are
        # bit-identical to per-B serve_gains calls) and only the knapsack
        # solve itself remains per candidate.
        bp = self.pricer.batch_pricing(now, live, fluid)
        gain_fn = obj_lib.OBJECTIVES[self.cfg.objective]
        is_running = np.array([r.state == ReqState.RUNNING for r in live])

        gains_grid = self.pricer.serve_gains_grid(
            now, fluid, bp, candidates, gain_fn
        ) + self.cfg.stickiness * is_running
        best = (-np.inf, None, None, 0)
        for gains, b in zip(gains_grid, candidates):
            sel, value = self._solve(gains, weights, int(b))
            if value > best[0]:
                best = (value, sel, gains, int(b))

        sel = best[1]
        chosen = [live[i] for i in np.nonzero(sel)[0]]

        # ---- Optimization #4: preemption cap -------------------------------
        chosen = self._apply_preemption_cap(chosen, running, weights, live)
        if self.obs is not None:
            # pricing inputs behind the decision (QoEPricer gains, the
            # candidate grid, the winning knapsack) — trace-only payload
            info = {
                "triggered": True,
                "b_candidates": [int(b) for b in candidates],
                "b_chosen": best[3],
                "knapsack_value": float(best[0]),
                **bp.summary(),
            }
            if len(live) <= 64:       # full gain vector only when small
                info["gains"] = {str(r.rid): float(g)
                                 for r, g in zip(live, best[2])}
            self._record_decision(now, live, chosen, info)
        return chosen

    # ------------------------------------------------------------------ parts
    def idle_steps(self, live, max_steps):
        """Andes is a pass-through iteration exactly when the §4.2 #1
        trigger is off: schedule() then returns `_admit_all`, which admits
        every live request (untriggered ⇒ total demand ≤ watermark·M < M ⇒
        all fit). Project the trigger forward: the latency term is
        invariant within the window (len(live) and the stiffest TDS don't
        change while nobody finishes/arrives), and the memory term grows
        deterministically — every running request's KV weight grows by one
        token per iteration (or not at all under state_equiv_tokens). The
        s-th skipped call sees demand + s·grow; return the largest s kept
        under the watermark."""
        if not live:
            return 0
        if any(r.state != ReqState.RUNNING for r in live):
            return 0
        stiffest = max((r.spec.tds for r in live), default=0.0)
        if stiffest > 0 and \
                self.lat.per_token_latency(len(live)) > 1.0 / stiffest:
            return 0                         # latency trigger is on
        st = self.cfg.state_equiv_tokens
        demand = int(self._weights(live).sum())
        cap = self.cfg.memory_watermark * self.M
        if demand > cap:
            return 0                         # memory trigger is on
        grow = 0 if st else len(live)
        if grow == 0:
            return int(max_steps)
        p = self.cfg.page_size
        if p > 1:
            # paged capacity view: a request's page weight is flat until
            # its context crosses a page boundary, then jumps by a whole
            # page — project the page-rounded demand exactly rather than
            # the +1-token-per-request linear form
            toks = np.array([r.kv_tokens(st) for r in live], np.int64)
            s = 0
            while s < max_steps and \
                    int((-(-(toks + s + 1) // p) * p).sum()) <= cap:
                s += 1
            return s
        # largest s with demand + s*grow <= cap (float comparison matches
        # _triggered's `total_demand > watermark * M` exactly)
        s = 0
        while s < max_steps and demand + (s + 1) * grow <= cap:
            s += 1
        return s

    def _triggered(self, live, running, weights) -> bool:
        used = sum(self._kv_weight(r) for r in running)
        total_demand = int(weights.sum())
        mem_pressure = total_demand > self.cfg.memory_watermark * self.M \
            or used > self.cfg.memory_watermark * self.M
        if mem_pressure:
            return True
        # latency pressure: per-token latency at "everyone runs" batch size
        # would violate the most stringent TDS in the system. Per *token*,
        # not per iteration: a speculative step costs verify(k) but yields
        # E[accepted+1] tokens (SpeculativeLatencyModel folds that in; for
        # the baseline model per_token_latency IS iter_latency, bit-for-bit).
        stiffest = max((r.spec.tds for r in live), default=0.0)
        if stiffest <= 0:
            return False
        lat_all = self.lat.per_token_latency(len(live))
        return lat_all > 1.0 / stiffest

    def _admit_all(self, live, weights) -> List[Request]:
        order = sorted(range(len(live)), key=lambda i: live[i].arrival)
        used, keep = 0, []
        for i in order:
            if used + weights[i] <= self.M:
                keep.append(live[i])
                used += int(weights[i])
        return keep

    def _batch_bounds(self, live, weights) -> Tuple[int, int]:
        # B_max: most requests that fit in memory (shortest-first)
        w_sorted = np.sort(weights)
        fits = np.cumsum(w_sorted) <= self.M
        b_max = max(int(fits.sum()), 1)
        # B_min: largest B still faster than the stiffest TDS requirement
        stiffest = max((r.spec.tds for r in live), default=1.0)
        b_min = self.lat.max_batch_from_latency(1.0 / max(stiffest, 1e-9))
        b_min = max(1, min(b_min, b_max))
        return b_min, b_max

    def _serve_delay(self, r: Request) -> float:
        return self.pricer.serve_delay(r)

    def _solve(self, gains, weights, b) -> Tuple[np.ndarray, float]:
        """Algorithm 1: greedy packing by priority = gain / weight."""
        pri = gains / np.maximum(weights, 1)
        order = np.argsort(-pri)
        sel = np.zeros(len(gains), bool)
        used = used_n = 0
        value = 0.0
        for i in order:
            if used_n + 1 > b:
                break
            if used + weights[i] <= self.M:
                sel[i] = True
                used += int(weights[i])
                used_n += 1
                value += float(gains[i])
        return sel, value


class AndesDPScheduler(AndesScheduler):
    """Andes with the optimal 3-D dynamic program (Algorithm 2).

    Pseudo-polynomial O(M·N·B); memory is bucketed into `granularity`-token
    units to keep M tractable (the paper runs the DP at full granularity and
    finds it *slower end-to-end* than greedy — fig18 reproduces that)."""

    name = "andes_dp"
    solver = "dp"

    def __init__(self, *args, granularity: int = 64, **kw):
        super().__init__(*args, **kw)
        self.granularity = granularity

    def _solve(self, gains, weights, b):
        g = self.granularity
        w = np.maximum((weights + g - 1) // g, 1).astype(np.int64)
        m = self.M // g
        n = len(gains)
        b = min(b, n)
        NEG = -1e18
        # dp[j, c] = best value with j items and c memory units
        dp = np.full((b + 1, m + 1), NEG)
        dp[0, 0] = 0.0
        choice = np.zeros((n, b + 1, m + 1), np.bool_)
        for i in range(n):
            wi, gi = int(w[i]), float(gains[i])
            if wi > m:
                continue
            new = dp.copy()
            cand = dp[: b, : m + 1 - wi] + gi
            better = cand > new[1:, wi:]
            new[1:, wi:] = np.where(better, cand, new[1:, wi:])
            choice[i, 1:, wi:] = better
            dp = new
        # best exactly-B solution (paper formulation); fall back to best ≤ B
        flat = dp[b] if np.any(dp[b] > NEG / 2) else dp.max(axis=0)
        c = int(np.argmax(flat))
        j = b if np.any(dp[b] > NEG / 2) else int(np.argmax(dp[:, c]))
        value = float(dp[j, c]) if dp[j, c] > NEG / 2 else 0.0
        # backtrack
        sel = np.zeros(n, bool)
        for i in range(n - 1, -1, -1):
            if j > 0 and choice[i, j, c]:
                sel[i] = True
                j -= 1
                c -= int(w[i])
        if value <= 0.0 and not sel.any():
            return super()._solve(gains, weights, b)
        return sel, float(np.sum(gains[sel]))
