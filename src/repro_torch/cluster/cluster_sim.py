"""ClusterSimulator: N replicas, one arrival trace, fleet-wide QoE.

The top of the cluster stack (see this package's __init__ for the map):
pops arrivals in time order, advances every replica's discrete-event clock
to the arrival (iterations are indivisible, exactly as in the single-node
simulator), lets the Autoscaler react, the Router place, and the
AdmissionController admit/defer/shed — then drains the fleet and reports
QoE over *all* requests, shed ones included (paper Eq. 1 gives an
unserved request QoE 0, which is what "degrade gracefully under surge",
§6.4, must be measured against).

A 1-replica cluster with admission and autoscaling off reproduces the
single-node `ServingSimulator` token timeline bit-for-bit — the cluster
layer only ever *adds* decisions around the engine, never changes it
(regression-tested in tests/test_torch_cluster.py).

Like the simulator and engine, the cluster is *steppable*: `submit()`
enqueues arrivals for routing, `step()` executes one fleet event (route
the next queued arrival, or advance each busy replica one iteration once
the queue is empty), and `result()` snapshots a ClusterResult. `run()` is
a thin loop over them — which is what lets `repro_torch.api.ServingClient`
front a whole cluster through the same submit/stream surface as a bare
backend (tests/test_torch_api.py pins client ≡ direct driving bit for
bit via the 1-replica invariance).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.objectives import fleet_slo_attainment
from repro_torch.core.pricing import weighted_attainment
from repro_torch.core.request import Request
from repro_torch.core.scheduler import SchedulerConfig, make_scheduler
from repro_torch.serving.simulator import SimResult
from repro_torch.cluster.admission import ADMIT, DEFER, AdmissionConfig, AdmissionController
from repro_torch.cluster.autoscaler import Autoscaler, AutoscalerConfig, ScaleEvent
from repro_torch.cluster.backends import BackendFactory, simulator_backend
from repro_torch.cluster.replica import Replica
from repro_torch.cluster.router import RouterConfig, make_router


@dataclasses.dataclass
class ClusterConfig:
    n_replicas: int = 2
    scheduler: str = "andes"
    router: str = "qoe"                 # round_robin | jsq | qoe
    kv_capacity_tokens: int = 65_000    # per replica
    preemption_mode: str = "swap"
    max_sim_time: float = 10_000.0
    sched_cfg: Optional[SchedulerConfig] = None
    router_cfg: Optional[RouterConfig] = None
    admission: Optional[AdmissionConfig] = None     # None -> admit all
    autoscaler: Optional[AutoscalerConfig] = None   # None -> fixed fleet
    # what runs inside each replica: (rid, scheduler, lat, cfg) -> backend.
    # None -> discrete-event simulator; see repro_torch.cluster.backends for the
    # real-engine and mixed-fleet factories.
    backend_factory: Optional[BackendFactory] = None


@dataclasses.dataclass
class ClusterResult:
    admitted: List[Request]
    shed: List[Request]
    n_defer_events: int
    makespan: float
    replica_results: Dict[int, SimResult]
    scale_events: List[ScaleEvent]
    peak_replicas: int

    # ---- fleet metrics -----------------------------------------------------
    def qoes(self, include_shed: bool = True) -> np.ndarray:
        q = [r.final_qoe() for r in self.admitted]
        if include_shed:
            q += [0.0] * len(self.shed)
        return np.array(q)

    def avg_qoe(self, include_shed: bool = True) -> float:
        q = self.qoes(include_shed)
        return float(q.mean()) if q.size else 1.0

    def slo_attainment(self, threshold: float = 0.9,
                       include_shed: bool = True) -> float:
        per_rep = [np.array([r.final_qoe() for r in res.requests])
                   for res in self.replica_results.values()]
        return fleet_slo_attainment(
            per_rep, threshold,
            n_shed=len(self.shed) if include_shed else 0)

    def shed_rate(self) -> float:
        n = len(self.admitted) + len(self.shed)
        return len(self.shed) / max(n, 1)

    def ttfts(self) -> np.ndarray:
        return np.array([r.final_ttft() for r in self.admitted])

    def total_tokens(self) -> int:
        return sum(res.total_tokens for res in self.replica_results.values())

    def throughput(self) -> float:
        return self.total_tokens() / self.makespan if self.makespan > 0 else 0.0

    def preemptions(self) -> int:
        return sum(res.preemptions for res in self.replica_results.values())

    def per_tenant_avg_qoe(self) -> Dict[int, float]:
        acc: Dict[int, List[float]] = {}
        for r in self.admitted:
            acc.setdefault(r.tenant, []).append(r.final_qoe())
        for r in self.shed:
            acc.setdefault(r.tenant, []).append(0.0)
        return {k: float(np.mean(v)) for k, v in sorted(acc.items())}

    def contract_attainment(self, default_floor: float = 0.9,
                            include_shed: bool = True) -> float:
        """Contract-weighted SLO attainment over the whole trace
        (core.pricing.weighted_attainment; a shed request never emitted,
        so it fails its contract and its weight counts against the fleet).
        With no contracts this is the uniform QoE-floor attainment."""
        reqs = self.admitted + (self.shed if include_shed else [])
        return weighted_attainment(reqs, default_floor)

    def per_tenant_attainment(self, default_floor: float = 0.9
                              ) -> Dict[int, float]:
        acc: Dict[int, List[Request]] = {}
        for r in self.admitted + self.shed:
            acc.setdefault(r.tenant, []).append(r)
        return {k: weighted_attainment(v, default_floor)
                for k, v in sorted(acc.items())}


class ClusterSimulator:
    """`lat` may be a single LatencyModel (homogeneous fleet) or a sequence
    of them — replica i runs on lat[i % len(lat)], which models a
    heterogeneous fleet (e.g. the paper's 4xA100 and 4xA40 deployments side
    by side; DiSCo-style dispatching is where the QoE router's pricing of
    each replica's hardware pays off)."""

    def __init__(self, lat, cfg: Optional[ClusterConfig] = None):
        self.lats: List[LatencyModel] = (
            list(lat) if isinstance(lat, (list, tuple)) else [lat]
        )
        self.cfg = cfg or ClusterConfig()
        if self.cfg.n_replicas < 1:
            raise ValueError("ClusterConfig.n_replicas must be >= 1")
        if not self.lats:
            raise ValueError("at least one LatencyModel is required")
        self.router = make_router(self.cfg.router, self.cfg.router_cfg)
        self.admission = AdmissionController(
            self.cfg.admission or AdmissionConfig(),
            self.cfg.router_cfg,
        )
        self.autoscaler = (Autoscaler(self.cfg.autoscaler)
                           if self.cfg.autoscaler else None)
        self._rep_ids = itertools.count()
        # observability (repro_torch.obs): `self.obs` is the effective observer
        # composed from an installed Observer and/or a legacy `event_sink`
        # callable (deprecated; wrapped in EventSinkAdapter). Propagated —
        # replica-scoped — to every replica backend, including ones the
        # autoscaler provisions later; the cluster itself emits fleet
        # events (route/admission/scale/shed/defer). Initialized before
        # the first replicas are built so they inherit it too.
        self._observer = None
        self._event_sink = None
        self.obs = None
        self.replicas: List[Replica] = [
            self._new_replica(0.0) for _ in range(self.cfg.n_replicas)
        ]
        self.retired: List[Replica] = []
        self.peak_replicas = len(self.replicas)
        # steppable state: routing queue of (route_at, tiebreak, request);
        # deferred requests re-enter with a later route_at but keep their
        # original arrival (their QoE clock started when the user hit enter)
        self._queue: List = []
        self._seq = itertools.count()
        self.now = 0.0                    # fleet clock (last event time)
        self.admitted: List[Request] = []
        self.shed: List[Request] = []
        self._finalized = False

    # ----------------------------------------------------------------- fleet
    def _new_replica(self, launched_at: float) -> Replica:
        cfg = self.cfg
        rid = next(self._rep_ids)
        lat = self.lats[rid % len(self.lats)]
        sched_cfg = dataclasses.replace(cfg.sched_cfg) if cfg.sched_cfg \
            else SchedulerConfig()
        sched = make_scheduler(cfg.scheduler, cfg.kv_capacity_tokens,
                               lat, sched_cfg)
        factory = cfg.backend_factory or simulator_backend
        backend = factory(rid, sched, lat, cfg)
        backend.now = launched_at    # replica is born at provision time
        # the factory may re-point the scheduler's latency model (e.g.
        # speculative_backend installs a SpeculativeLatencyModel); the
        # replica's routing/admission views must price with the same model
        # the backend does, so the QoE router sees a speculative replica's
        # true expected-burst token rate. For stock factories sched.lat IS
        # the lat picked above, so nothing changes.
        backend.observer = self._scoped_obs(rid)
        return Replica(rid, backend, sched.lat, launched_at=launched_at)

    # ------------------------------------------------------------ observers
    def _scoped_obs(self, rid: int):
        if self.obs is None:
            return None
        from repro_torch.obs.observer import ScopedObserver
        return ScopedObserver(self.obs, rid)

    @property
    def observer(self):
        """Installed Observer (repro_torch.obs); None = observability off. The
        cluster propagates it replica-scoped to every backend (current and
        future), so one observer sees the whole fleet with replica ids."""
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

    def set_event_sink(self, sink) -> None:
        """Install a lifecycle-event sink on the fleet (deprecated shim —
        prefer `set_observer`/`attach_observer`): every replica backend
        (current and future) reports emit/preempt/finish events through
        it, and the cluster itself reports shed/defer decisions. This is
        how repro_torch.api.ServingClient used to observe a whole cluster; it
        now rides the Observer protocol through an EventSinkAdapter."""
        self.event_sink = sink

    def _rewire_obs(self) -> None:
        from repro_torch.obs.observer import EventSinkAdapter, compose
        sink_obs = (EventSinkAdapter(self._event_sink)
                    if self._event_sink is not None else None)
        self.obs = compose(self._observer, sink_obs)
        for rep in self.replicas + self.retired:
            rep.backend.observer = self._scoped_obs(rep.id)

    def _advance_all(self, t: float) -> None:
        for rep in self.replicas:
            rep.advance_to(t)

    def _reap_drained(self, t: float) -> None:
        """Retire fully drained replicas (they keep their results)."""
        still, gone = [], []
        for rep in self.replicas:
            (gone if rep.drained else still).append(rep)
        for rep in gone:
            self.autoscaler.record_reap(t, rep)
            if self.obs is not None:
                self.obs.scale(t, "reap", rep.id)
        self.replicas, self.retired = still, self.retired + gone

    def _autoscale(self, t: float) -> None:
        if self.autoscaler is None:
            return
        for _ in range(self.autoscaler.take_ready_provisions(t)):
            rep = self._new_replica(t)
            self.replicas.append(rep)
            if self.obs is not None:
                self.obs.scale(t, "provision_ready", rep.id)
        events = self.autoscaler.evaluate(t, self.replicas)
        if self.obs is not None:
            for ev in events:
                self.obs.scale(ev.t, ev.action, ev.replica_id,
                               signal=ev.signal)
        self._reap_drained(t)
        self.peak_replicas = max(self.peak_replicas, len(self.replicas))

    # ----------------------------------------------------- incremental API
    def submit(self, req: Request) -> None:
        """Enqueue an arrival for routing at its arrival time. Re-arms the
        end-of-trace cleanup so a second submit-then-drain round on the
        same cluster finalizes again (interactive client sessions)."""
        heapq.heappush(self._queue, (req.arrival, next(self._seq), req))
        if self.obs is not None:
            self.obs.submit(req, req.arrival)
        self._finalized = False

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(rep.has_work for rep in self.replicas)

    @property
    def seen(self) -> List[Request]:
        """Every request this cluster has decided on (admitted or shed)."""
        return self.admitted + self.shed

    def _route_next(self) -> None:
        """Pop the next queued arrival, advance the fleet to it, and let
        autoscaler → router → admission act (one routing event)."""
        route_at, _, req = heapq.heappop(self._queue)
        self.now = max(self.now, route_at)
        self._advance_all(route_at)
        self._autoscale(route_at)
        routable = [r for r in self.replicas if not r.draining]
        if not routable:
            # fleet drained to nothing (e.g. min_replicas=0 during a
            # lull): un-drain the newest replica, or provision a fresh
            # one, rather than dropping traffic on the floor
            if self.replicas:
                self.replicas[-1].draining = False
                routable = [self.replicas[-1]]
            else:
                rep = self._new_replica(route_at)
                self.replicas.append(rep)
                self.peak_replicas = max(self.peak_replicas,
                                         len(self.replicas))
                routable = [rep]
        decision = self.router.route(req, routable, route_at)
        obs = self.obs
        if obs is not None:
            obs.route(req, route_at, decision.replica.id, decision.gain,
                      decision.scores)
        action = self.admission.decide(req, decision, route_at)
        if obs is not None:
            obs.admission(req, route_at, action, decision.gain)
        if action == ADMIT:
            decision.replica.submit(req)
            self.admitted.append(req)
        elif action == DEFER:
            heapq.heappush(
                self._queue,
                (route_at + self.admission.cfg.defer_delay,
                 next(self._seq), req),
            )
            if obs is not None:
                obs.defer(req, route_at)
        else:
            self.shed.append(req)
            if obs is not None:
                obs.shed(req, route_at)

    def step(self, until: Optional[float] = None) -> bool:
        """One fleet event: route the next queued arrival, or — once the
        queue is empty — advance every busy replica by one iteration
        (replicas are independent after routing, so per-replica outcomes
        are identical to draining them one at a time). Returns False when
        fully drained; the first False triggers the end-of-trace
        autoscaler cleanup (cancel in-flight provisions, reap drained
        replicas) exactly as the monolithic run() loop did.

        `until`: arrivals already routed bound each replica's multi-step
        fast path through Replica.advance_to; pass `until` (forwarded to
        every replica stepped here) only for the future-submit pattern —
        a multi-wave session that will submit a request with an explicit
        later `arrival` after stepping past it — so drain-phase fused
        blocks stop at the same iteration boundary a baseline fleet
        driven by the identical call sequence would."""
        if self._queue:
            self._route_next()
            return True
        progressed = False
        for rep in self.replicas + self.retired:
            if rep.has_work and rep.step(until=until):
                progressed = True
        if progressed:
            self.now = max([self.now]
                           + [rep.clock for rep in self.replicas])
            return True
        self._finalize()
        return False

    def _finalize(self) -> None:
        if self._finalized:
            return
        self._finalized = True
        if self.autoscaler is not None:
            # no more arrivals: cancel in-flight provisions (a replica that
            # comes up after the last request would serve nothing and only
            # inflate peak_replicas), then reap whatever finished draining.
            # Deliberately NOT a full _autoscale: re-running evaluate here
            # would record phantom scale decisions after the trace ended.
            self.autoscaler.pending_provisions.clear()
            t_end = max((rep.clock for rep in self.replicas + self.retired),
                        default=0.0)
            self._reap_drained(t_end)

    def result(self) -> ClusterResult:
        all_reps = self.replicas + self.retired
        results = {rep.id: rep.result() for rep in all_reps}
        makespan = max(
            (res.makespan for res in results.values() if res.requests),
            default=0.0,
        )
        return ClusterResult(
            admitted=list(self.admitted),
            shed=list(self.shed),
            n_defer_events=self.admission.n_defer_events,
            makespan=makespan,
            replica_results=results,
            scale_events=list(self.autoscaler.events) if self.autoscaler else [],
            peak_replicas=self.peak_replicas,
        )

    # ------------------------------------------------------------------- run
    def run(self, workload: List[Request]) -> ClusterResult:
        """Serve the workload to completion: a thin loop over submit() +
        step(), preserving the pre-refactor monolithic loop's behavior
        (same pop order — the (arrival, submit-order) heap key is a total
        order — and the same post-trace autoscaler cleanup)."""
        for r in sorted(workload, key=lambda r: r.arrival):
            self.submit(r)
        while self.step():
            pass
        return self.result()
