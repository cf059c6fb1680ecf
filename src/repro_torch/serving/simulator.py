"""Discrete-event simulator for paper-scale serving experiments.

Faithful continuous-batching semantics (vLLM-style, iteration-granular):
every iteration the scheduler picks the running set; newly admitted
requests pay prefill (which emits their first token, blocking decode like
vLLM's non-chunked prefill); preempted requests pay swap-out now and
swap-in (or full recompute) on readmission; then every running request
decodes one token whose latency comes from the roofline-derived
LatencyModel. The client-side token buffer and exact Eq. 1 QoE are applied
at reporting time.

This is where the paper's Figures 3/10–18/21 and Table 4 are reproduced
at paper scale; the engine in engine.py runs the same scheduler against
real models, and the two agree per request within the tolerance of
tests/test_torch_cluster_engine.py.

The simulator is *steppable*: `submit()` enqueues arrivals, `step()`
executes one continuous-batching iteration, and `result()` snapshots the
metrics. `run()` composes them for the classic single-node path, while the
cluster layer (repro_torch.cluster) drives many simulators as replicas off a
shared arrival trace — stepping each only as far as the fleet clock
requires — without changing the per-iteration semantics.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.qoe import FluidQoE
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.request import Request, ReqState


@dataclasses.dataclass
class SimConfig:
    kv_capacity_tokens: int            # M
    preemption_mode: str = "swap"      # "swap" | "recompute"
    host_kv_capacity_tokens: int = 10_000_000
    max_sim_time: float = 10_000.0
    # charge the *measured host wall time* of each scheduler.schedule() call
    # to the simulated clock — this is what exposes the DP solver's
    # O(M·N·B) cost end-to-end (paper §6.5 Fig. 18)
    charge_scheduler_overhead: bool = False


@dataclasses.dataclass
class SimResult:
    requests: List[Request]
    makespan: float
    total_tokens: int
    preemptions: int
    iterations: int
    batch_sizes: List[int]

    # ---- paper metrics -----------------------------------------------------
    def qoes(self) -> np.ndarray:
        return np.array([r.final_qoe() for r in self.requests])

    def avg_qoe(self) -> float:
        return float(np.mean(self.qoes())) if self.requests else 1.0

    def ttfts(self) -> np.ndarray:
        return np.array([r.final_ttft() for r in self.requests])

    def tds(self) -> np.ndarray:
        return np.array([r.final_tds() for r in self.requests])

    def throughput(self) -> float:
        return self.total_tokens / self.makespan if self.makespan > 0 else 0.0

    def preemption_freq(self) -> float:
        return self.preemptions / max(len(self.requests), 1)

    def normalized_latencies(self) -> np.ndarray:
        return np.array([r.normalized_latency() for r in self.requests])


class ServingSimulator:
    """Single-node continuous-batching simulator.

    Incremental API (used by the cluster layer's `Replica`):
      submit(req)  enqueue an arrival (any time, in any order)
      step()       one scheduling+decode iteration; False when out of work
      has_work     pending or live requests remain
      result()     SimResult over every request ever submitted

    Batch API (classic single-node experiments):
      run(workload)  reset + submit all + step to completion
    """

    def __init__(
        self,
        scheduler: Scheduler,
        lat: LatencyModel,
        sim_cfg: SimConfig,
    ):
        self.sched = scheduler
        self.lat = lat
        self.cfg = sim_cfg
        # observability (repro_torch.obs): `self.obs` is the effective observer
        # (None = off) composed from an installed Observer and/or a legacy
        # `event_sink` callable (deprecated; wrapped in EventSinkAdapter).
        # Survives reset() so run() keeps reporting to installed consumers.
        self._observer = None
        self._event_sink = None
        self.obs = None
        self.reset()

    # ------------------------------------------------------------ observers
    @property
    def observer(self):
        """Installed Observer (repro_torch.obs); None = observability off."""
        return self._observer

    @observer.setter
    def observer(self, obs) -> None:
        self._observer = obs
        self._rewire_obs()

    @property
    def event_sink(self):
        """Legacy lifecycle callable `sink(kind, req, t, k)` (deprecated;
        kept as an EventSinkAdapter shim — prefer `observer`)."""
        return self._event_sink

    @event_sink.setter
    def event_sink(self, sink) -> None:
        self._event_sink = sink
        self._rewire_obs()

    def set_observer(self, obs) -> None:
        self.observer = obs

    def attach_observer(self, obs) -> None:
        """Add `obs` alongside any already-installed observer."""
        from repro_torch.obs.observer import compose
        self.observer = compose(self._observer, obs)

    def _rewire_obs(self) -> None:
        from repro_torch.obs.observer import EventSinkAdapter, compose
        sink_obs = (EventSinkAdapter(self._event_sink)
                    if self._event_sink is not None else None)
        self.obs = compose(self._observer, sink_obs)
        self.sched.obs = self.obs

    # ------------------------------------------------------------------ state
    def reset(self) -> None:
        self.sched.reset()                   # policy state (counters, orders)
        self.fluid = FluidQoE()
        self._pending: List[Request] = []    # sorted arrivals; admitted
        self._pending_pos = 0                #   prefix tracked by cursor
        self.live: List[Request] = []
        self.now = 0.0
        self.total_tokens = 0
        self.preemptions = 0
        self.iterations = 0
        self.batch_sizes: List[int] = []
        self.host_kv_used = 0
        self.halted = False                  # hit max_sim_time (permanent)
        self.stuck = False                   # deadlocked (cleared by submit)
        self.seen: List[Request] = []        # submit order

    def submit(self, req: Request) -> None:
        """Enqueue an arrival. Stable insert keeps equal-arrival order
        (bisect_right above the admitted-prefix cursor — identical order
        to the old insort-into-a-popped-list, without its O(n²) drain)."""
        i = bisect.bisect_right(self._pending, req.arrival,
                                lo=self._pending_pos,
                                key=lambda r: r.arrival)
        self._pending.insert(i, req)
        self.seen.append(req)
        if self.obs is not None:
            self.obs.submit(req, req.arrival)
        # a new arrival may be schedulable even if the current live set
        # deadlocked (e.g. an oversized prompt) — try again
        self.stuck = False

    def cancel(self, rid: int) -> bool:
        """Abort a request by rid — steppable-backend parity with
        ServingEngine.cancel: mark cancelled + FINISHED with whatever was
        emitted, free its host-KV accounting, notify the scheduler. False
        when the rid is unknown or already finished (a cancel racing
        normal completion is a no-op)."""
        for i in range(self._pending_pos, len(self._pending)):
            r = self._pending[i]
            if r.rid == rid:
                del self._pending[i]
                r.cancelled = True
                r.state = ReqState.FINISHED
                r.finish_time = self.now
                if self.obs is not None:
                    self.obs.cancel(r, self.now)
                return True
        for r in self.live:
            if r.rid == rid:
                if r.state == ReqState.SWAPPED:
                    self.host_kv_used -= r.context_len
                r.cancelled = True
                r.state = ReqState.FINISHED
                r.finish_time = self.now
                self.sched.on_request_finish(r)
                self.live = [x for x in self.live if x is not r]
                self.stuck = False
                if self.obs is not None:
                    self.obs.cancel(r, self.now)
                return True
        return False

    @property
    def pending(self) -> List[Request]:
        """Submitted-but-not-admitted requests (protocol view; the hot loop
        uses the cursor directly and never materializes this slice)."""
        return self._pending[self._pending_pos:]

    @property
    def has_work(self) -> bool:
        return self._pending_pos < len(self._pending) or bool(self.live)

    # ---------------------------------------------------------------- helpers
    def _admit_arrivals(self, t: float) -> None:
        pend = self._pending
        pos = self._pending_pos
        obs = self.obs
        while pos < len(pend) and pend[pos].arrival <= t:
            r = pend[pos]
            pos += 1
            r.fluid_idx = self.fluid.add(r.arrival, r.spec)
            r.state = ReqState.WAITING
            self.live.append(r)
            self.sched.on_request_arrival(r)
            if obs is not None:
                obs.admit(r, t)
        self._pending_pos = pos
        # amortized compaction: drop the consumed prefix once it dominates
        if pos and pos * 2 >= len(pend):
            del pend[:pos]
            self._pending_pos = 0

    # ------------------------------------------------------------------- step
    def step(self, until: Optional[float] = None) -> bool:
        """One continuous-batching iteration. Returns False when there is
        nothing left to do (drained or past max_sim_time). `until` is
        accepted for SteppableBackend drive parity (Replica.advance_to
        passes it to bound the engine's multi-step fast path); simulator
        iterations are always indivisible, so it is a no-op here."""
        if self.halted or self.stuck or not self.has_work:
            return False
        if not self.live:
            self.now = max(self.now,
                           self._pending[self._pending_pos].arrival)
        self._admit_arrivals(self.now)
        if not self.live:
            return True
        if self.now > self.cfg.max_sim_time:
            self.halted = True
            return False

        fluid = self.fluid
        now = self.now
        running = [r for r in self.live if r.state == ReqState.RUNNING]
        if self.cfg.charge_scheduler_overhead:
            import time as _time
            _t0 = _time.perf_counter()
            target = self.sched.schedule(now, self.live, fluid)
            now += _time.perf_counter() - _t0
        else:
            target = self.sched.schedule(now, self.live, fluid)
        target_set = set(id(r) for r in target)

        # ---- preemptions ------------------------------------------------
        obs = self.obs
        iter_extra = 0.0
        newly_preempted = [r for r in running if id(r) not in target_set]
        for r in newly_preempted:
            r.preemptions += 1
            self.preemptions += 1
            ctx = r.context_len
            if (self.cfg.preemption_mode == "swap"
                    and self.host_kv_used + ctx <= self.cfg.host_kv_capacity_tokens):
                r.state = ReqState.SWAPPED
                self.host_kv_used += ctx
                iter_extra += self.lat.swap_latency(ctx)
                mode = "swap"
            else:
                # paper §4.2: fall back to recomputation when host RAM full
                r.state = ReqState.WAITING
                r.prefilled = False
                mode = "recompute"
            if obs is not None:
                obs.preempt(r, now, mode)
        self.sched.record_preemptions(len(newly_preempted))

        # ---- admissions -------------------------------------------------
        first_emits: List[Request] = []
        for r in target:
            if r.state == ReqState.SWAPPED:
                self.host_kv_used -= r.context_len
                iter_extra += self.lat.swap_latency(r.context_len)
                r.state = ReqState.RUNNING
                if obs is not None:
                    obs.swap_in(r, now)
            elif r.state == ReqState.WAITING:
                # prefill (recompute includes generated prefix)
                iter_extra += self.lat.prefill_latency(r.context_len)
                r.state = ReqState.RUNNING
                r.prefilled = True
                if obs is not None:
                    obs.prefill(r, now, r.context_len)
                if r.generated == 0:
                    first_emits.append(r)

        running = [r for r in self.live if r.state == ReqState.RUNNING]
        self.batch_sizes.append(len(running))

        # first tokens come out of prefill itself
        prefill_done = now + iter_extra
        for r in first_emits:
            r.emit_times.append(prefill_done)
            fluid.emit(r.fluid_idx, prefill_done, 1)
            r.generated = 1
            self.total_tokens += 1
            if obs is not None:
                obs.emit(r, prefill_done, 1)

        # ---- decode iteration -------------------------------------------
        decoders = [r for r in running if r.generated < r.output_len]
        total_ctx = sum(r.context_len for r in decoders)
        step = self.lat.iter_latency(len(decoders), total_ctx)
        now = prefill_done + (step if decoders else 0.0)
        self.iterations += 1

        emit_idx = []
        for r in decoders:
            r.emit_times.append(now)
            r.generated += 1
            self.total_tokens += 1
            emit_idx.append(r.fluid_idx)
            if obs is not None:
                obs.emit(r, now, 1)
        if emit_idx:
            fluid.emit(np.array(emit_idx), now, 1)

        # ---- completions -------------------------------------------------
        for r in running:
            if r.generated >= r.output_len:
                r.state = ReqState.FINISHED
                r.finish_time = now
                self.sched.on_request_finish(r)
                if obs is not None:
                    obs.finish(r, now)
        self.live = [r for r in self.live if r.is_live]
        self.now = now
        self._admit_arrivals(now)

        # ---- deadlock guard ----------------------------------------------
        # A live request that can never be scheduled (e.g. prompt larger
        # than KV capacity) makes no progress: no admissions or swap-ins
        # (iter_extra stays 0), no decoders, no preemptions. Jump to the
        # next arrival if one exists (it may change the scheduler's
        # choice); otherwise halt, leaving the unschedulable requests
        # unfinished (QoE 0) rather than spinning. (Progress is detected
        # from the work signals, not the clock — charge_scheduler_overhead
        # advances `now` by wall time even in an idle iteration.)
        if iter_extra == 0.0 and not decoders and not first_emits \
                and not newly_preempted:
            if self._pending_pos < len(self._pending):
                self.now = max(self.now,
                               self._pending[self._pending_pos].arrival)
            else:
                self.stuck = True            # a later submit() may clear it
                return False
        return True

    # ----------------------------------------------------------------- result
    def result(self) -> SimResult:
        return SimResult(
            requests=list(self.seen),
            makespan=self.now,
            total_tokens=self.total_tokens,
            preemptions=self.preemptions,
            iterations=self.iterations,
            batch_sizes=self.batch_sizes,
        )

    def run(self, workload: List[Request]) -> SimResult:
        self.reset()
        for r in sorted(workload, key=lambda r: r.arrival):
            self.submit(r)
        while self.step():
            pass
        return self.result()
