"""Backward-compat shim — the schedulers live in `repro.core.policies`.

This module used to hold every scheduler; they were extracted into the
policy-arena package (`repro.core.policies`: base protocol + FCFS /
round-robin / Andes / VTC / WSC / burst-preemptive) so new policies can
be added and refereed without touching the Andes code. Every name that
was importable from here still is.
"""
from repro_torch.core.policies import (  # noqa: F401
    AndesDPScheduler,
    AndesScheduler,
    BurstPreemptiveScheduler,
    FCFSScheduler,
    RoundRobinScheduler,
    SCHEDULERS,
    Scheduler,
    SchedulerConfig,
    SchedulingPolicy,
    VTCScheduler,
    WSCScheduler,
    make_scheduler,
)

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
