"""TokenFlow-style burst-preemptive policy (PAPERS.md).

TokenFlow's observation: the client-side token buffer (qoe.pace_delivery,
§5 of the paper) makes instantaneous server throughput per request
irrelevant — what matters is that no user's buffer runs dry. A request
whose buffer holds 5s of tokens can be paused for 4s with zero visible
impact, freeing the engine to absorb a burst of fresh arrivals whose
TTFT clocks are ticking.

The policy ranks every live request by *buffer slack* — the time until
its user starves:

    emitted requests      slack = buf / tds          (buffer drain time)
    never-emitted         slack = (arrival + ttft) − now   (TTFT countdown)

and serves smallest-slack-first under the KV budget, preempting
big-buffer requests to admit burst arrivals early. Preempted requests
bank no QoE damage while their buffer drains; they are re-admitted when
their slack decays below the frontier. The §4.2 #4 preemption cap is
enforced so pathological traces can't thrash.

Unlike Andes this needs no knapsack and no Δt prediction — it is the
purely reactive competitor: cheap, burst-robust, but blind to the
delivery *future* (it re-serves a starved request even when serving it
can no longer save its QoE, where Andes would cut the loss).
"""
from __future__ import annotations

from typing import List

from repro_torch.core.policies.base import Scheduler
from repro_torch.core.request import ReqState


class BurstPreemptiveScheduler(Scheduler):
    """Serve minimum-buffer-slack first; preempt big buffers for bursts."""

    name = "burst"
    enforces_preemption_cap = True

    def __init__(self, kv_capacity, lat, cfg=None, *,
                 slack_floor: float = 0.0):
        # slack_floor: treat slack below this as "already starving" —
        # such requests are mutually FCFS-ordered to avoid churn.
        self.slack_floor = slack_floor
        super().__init__(kv_capacity, lat, cfg)

    def _slack(self, now, r, fluid) -> float:
        i = r.fluid_idx
        if i is not None and i >= 0 and fluid.emitted[i] > 0:
            tds = max(float(fluid.tds_e[i]), 1e-9)
            return float(fluid.buf[i]) / tds
        return (r.arrival + r.spec.ttft) - now

    def schedule(self, now, live, fluid):
        self.iteration += 1
        if not live:
            return []
        # drain client buffers to `now` so buf reflects the present
        # (idempotent: backends have already advanced to now)
        fluid.advance(now)
        slacks = {r.rid: max(self._slack(now, r, fluid), self.slack_floor)
                  for r in live}
        ordered = sorted(live, key=lambda r: (slacks[r.rid],
                                              r.arrival, r.rid))
        keep = self._pack_in_order(ordered)
        running = [r for r in live if r.state == ReqState.RUNNING]
        weights = self._weights(live)
        keep = self._apply_preemption_cap(keep, running, weights, live)
        if self.obs is not None:
            vals = list(slacks.values())
            self._record_decision(now, live, keep, {
                "slack_min": float(min(vals)),
                "slack_max": float(max(vals)),
                "n_starving": sum(1 for s in vals if s <= self.slack_floor),
            })
        return keep
