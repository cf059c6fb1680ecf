"""The scheduling-policy arena.

One registry, many policies, every backend: any name in `SCHEDULERS`
can drive the simulator, the engine (incl. speculative), and cluster
replicas unchanged — they all consume the `SchedulingPolicy` protocol.

    fcfs         vLLM-style first-come-first-served (baselines.py)
    round_robin  fair-share rotation, paper §6.1 (baselines.py)
    andes        the paper's QoE knapsack, Algorithm 1 (andes.py)
    andes_dp     optimal 3-D DP, Algorithm 2 (andes.py)
    vtc          virtual-token-counter per-tenant fairness (fair.py)
    wsc          FAIRSERVE-style weighted service counter (fair.py)
    burst        TokenFlow-style burst-preemptive buffer slack (burst.py)

`benchmarks/policy_arena.py` referees them on adversarial multi-tenant
traces; `tests/test_policy_conformance.py` is the shared contract every
entry must pass.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.policies.andes import AndesDPScheduler, AndesScheduler
from repro_torch.core.policies.base import (Scheduler, SchedulerConfig,
                                      SchedulingPolicy)
from repro_torch.core.policies.baselines import FCFSScheduler, RoundRobinScheduler
from repro_torch.core.policies.burst import BurstPreemptiveScheduler
from repro_torch.core.policies.fair import VTCScheduler, WSCScheduler

SCHEDULERS = {
    "fcfs": FCFSScheduler,
    "round_robin": RoundRobinScheduler,
    "andes": AndesScheduler,
    "andes_dp": AndesDPScheduler,
    "vtc": VTCScheduler,
    "wsc": WSCScheduler,
    "burst": BurstPreemptiveScheduler,
}


def make_scheduler(name: str, kv_capacity: int, lat: LatencyModel,
                   cfg: Optional[SchedulerConfig] = None, **kw) -> Scheduler:
    return SCHEDULERS[name](kv_capacity, lat, cfg, **kw)


__all__ = [
    "AndesDPScheduler",
    "AndesScheduler",
    "BurstPreemptiveScheduler",
    "FCFSScheduler",
    "RoundRobinScheduler",
    "SCHEDULERS",
    "Scheduler",
    "SchedulerConfig",
    "SchedulingPolicy",
    "VTCScheduler",
    "WSCScheduler",
    "make_scheduler",
]
