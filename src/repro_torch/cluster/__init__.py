"""QoE-aware multi-replica cluster serving over the Andes engine.

The paper (§4–§6) maximizes QoE *within one* continuous-batching engine;
this package adds the fleet layer a production deployment needs on top:

  replica.py      Replica — one engine behind submit/step/drain (any
                  SteppableBackend: the discrete-event ServingSimulator
                  or the stepped real ServingEngine).
  backends.py     Backend factories — simulator_backend (default),
                  engine_backend (the port's PyTorch model per replica,
                  shared weights, on the model's device),
                  speculative_backend (the same with a shared draft
                  model proposing and the target verifying), mixed_backends
                  (sim + engine in one fleet); selected via
                  ClusterConfig.backend_factory.
  router.py       Round-robin, join-shortest-queue, and a QoE-aware policy
                  that places each request where its predicted marginal
                  fleet QoE gain — priced with the replica's FluidQoE +
                  LatencyModel — is largest (DiSCo-style dispatching).
  admission.py    Shed/defer requests whose admission would *lower* fleet
                  QoE (paper §6.4 graceful degradation, fleet-wide).
  autoscaler.py   Grow/drain the fleet on the §6.1 QoE-SLO attainment
                  signal; draining replicas finish in-flight requests.
  cluster_sim.py  ClusterSimulator — drives N replicas off one arrival
                  trace and reports fleet QoE (shed requests count as 0).
                  Steppable (submit/step/result), so
                  repro_torch.api.ServingClient fronts a whole cluster through
                  the same surface as a bare backend.

All marginal-QoE-gain pricing (router placements, admission thresholds,
autoscaler attainment) flows through repro_torch.core.pricing — one QoEPricer
surface shared with the in-replica scheduler knapsack; per-tenant
SLOContracts weight it (Request.contract / Request.priority).

A 1-replica cluster reproduces the single-node simulator bit-for-bit.
"""
from repro_torch.cluster.admission import AdmissionConfig, AdmissionController
from repro_torch.cluster.autoscaler import Autoscaler, AutoscalerConfig, ScaleEvent
from repro_torch.cluster.backends import (
    BackendFactory,
    engine_backend,
    mixed_backends,
    simulator_backend,
    speculative_backend,
)
from repro_torch.cluster.cluster_sim import ClusterConfig, ClusterResult, ClusterSimulator
from repro_torch.cluster.replica import Replica, SteppableBackend
from repro_torch.cluster.router import (
    ROUTERS,
    JSQRouter,
    QoEAwareRouter,
    RoundRobinRouter,
    RouteDecision,
    Router,
    RouterConfig,
    make_router,
    marginal_qoe_gain,
)

__all__ = [
    "Replica", "SteppableBackend",
    "BackendFactory", "simulator_backend", "engine_backend",
    "speculative_backend", "mixed_backends",
    "Router", "RouterConfig", "RouteDecision", "RoundRobinRouter",
    "JSQRouter", "QoEAwareRouter", "ROUTERS", "make_router",
    "marginal_qoe_gain",
    "AdmissionConfig", "AdmissionController",
    "Autoscaler", "AutoscalerConfig", "ScaleEvent",
    "ClusterConfig", "ClusterResult", "ClusterSimulator",
]
