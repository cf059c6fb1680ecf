"""Backend factories: what actually runs inside each cluster replica.

`ClusterSimulator` builds one `SteppableBackend` per replica through a
`BackendFactory` — a callable `(replica_id, scheduler, lat, cluster_cfg)
-> SteppableBackend`. The default (`simulator_backend`) wraps the
discrete-event `ServingSimulator`, which is what every paper-scale sweep
uses. `engine_backend(...)` returns a factory whose replicas run the
port's PyTorch model through the steppable `ServingEngine` — same
scheduler, same latency model, virtual clock — on the model's device (a
card unless the caller asks for the CPU), so a fleet can be validated
against actual token emission (tests/test_torch_cluster_engine.py).
`speculative_backend(...)` builds speculative replicas of the same
engine (a shared draft proposes, the shared target verifies; the token
stream is an `engine_backend` replica's, in fewer steps).
`mixed_backends(...)` round-robins factories over replica ids, giving
heterogeneous fleets where e.g. replica 0 is a real model and the rest
are simulated (the DiSCo device/server-split direction in ROADMAP.md).

Weights are shared across engine replicas (the factory closes over one
`(model, params)` pair); each replica gets its own KV cache and fluid
QoE state.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.latency_model import (LatencyModel,
                                            SpeculativeLatencyModel)
from repro_torch.core.scheduler import Scheduler
from repro_torch.cluster.replica import SteppableBackend
from repro_torch.device import resolve_device
from repro_torch.serving.simulator import ServingSimulator, SimConfig

BackendFactory = Callable[..., SteppableBackend]


def simulator_backend(replica_id: int, scheduler: Scheduler,
                      lat: LatencyModel, cluster_cfg) -> SteppableBackend:
    """Default: a discrete-event simulator per replica."""
    return ServingSimulator(scheduler, lat, SimConfig(
        kv_capacity_tokens=cluster_cfg.kv_capacity_tokens,
        preemption_mode=cluster_cfg.preemption_mode,
        max_sim_time=cluster_cfg.max_sim_time,
    ))


def engine_backend(
    model,
    params,
    *,
    num_slots: int = 8,
    max_seq: int = 128,
    capacity_tokens: Optional[int] = None,
    clock: str = "virtual",
    eos_id: int = -1,
    hotpath=None,
    cache_dtype=torch.float32,
    device="cuda",
    reference_decode: bool = False,
) -> BackendFactory:
    """Factory of real-model replicas: each one a `ServingEngine` over the
    shared `(model, params)`. `capacity_tokens` defaults to the cluster
    config's per-replica KV budget (clamped to what the slot cache can
    physically hold); the replica's scheduler is re-pointed at the same
    capacity so its knapsack, the router's pricing, and admission control
    never assume KV the engine does not physically have. `hotpath` is the
    engine's HotpathConfig (None = the lossless optimizations ON, the
    engine default; pass HotpathConfig.baseline() for the eager loop).
    `cache_dtype` is each replica's KV cache dtype; `device` must be the
    model's (a card by default: without one this raises, here rather
    than at the first replica); `reference_decode` is the engine's (the
    JAX engine's decode layout and moe routing, for differential
    tests)."""
    dev = resolve_device(device)
    if dev.type != model.device.type:
        raise ValueError(f"engine_backend device {device!r} differs from "
                         f"the model's ({model.device})")

    def factory(replica_id: int, scheduler: Scheduler,
                lat: LatencyModel, cluster_cfg) -> SteppableBackend:
        from repro_torch.serving.engine import ServingEngine
        cap = capacity_tokens
        if cap is None:
            cap = min(cluster_cfg.kv_capacity_tokens, num_slots * max_seq)
        scheduler.M = min(scheduler.M, cap)
        return ServingEngine(
            model, params, scheduler, lat,
            num_slots=num_slots, max_seq=max_seq, capacity_tokens=cap,
            preemption_mode=cluster_cfg.preemption_mode,
            clock=clock, eos_id=eos_id, hotpath=hotpath,
            cache_dtype=cache_dtype, device=dev,
            reference_decode=reference_decode,
        )
    return factory


def speculative_backend(
    model,
    params,
    draft_model,
    draft_params,
    *,
    spec_k: int = 3,
    num_slots: int = 8,
    max_seq: int = 128,
    capacity_tokens: Optional[int] = None,
    clock: str = "virtual",
    eos_id: int = -1,
    hotpath=None,
    cache_dtype=torch.float32,
    device="cuda",
    reference_decode: bool = False,
) -> BackendFactory:
    """Factory of speculative real-model replicas: each one a
    `ServingEngine` whose rounds draft-propose `spec_k` tokens with the
    shared `(draft_model, draft_params)` and verify them against the
    shared target (lossless: the replica emits the token stream an
    `engine_backend` replica would, in fewer steps).

    The replica's scheduler is re-pointed at a `SpeculativeLatencyModel`
    on its own hardware spec, so knapsack pricing, the router's
    marginal-gain queries and admission control see the expected
    1..k+1-token bursts. `cache_dtype`, `device` and `reference_decode`
    as `engine_backend`'s (a card by default: without one this raises
    here)."""
    dev = resolve_device(device)
    if dev.type != model.device.type:
        raise ValueError(f"speculative_backend device {device!r} differs "
                         f"from the model's ({model.device})")

    def factory(replica_id: int, scheduler: Scheduler,
                lat: LatencyModel, cluster_cfg) -> SteppableBackend:
        from repro_torch.serving.engine import ServingEngine
        cap = capacity_tokens
        if cap is None:
            cap = min(cluster_cfg.kv_capacity_tokens, num_slots * max_seq)
        scheduler.M = min(scheduler.M, cap)
        spec_lat = SpeculativeLatencyModel(
            model.cfg, lat.hw, draft_model.cfg, k=spec_k,
            dtype_bytes=lat.dtype_bytes, avg_ctx=lat.avg_ctx)
        scheduler.lat = spec_lat
        return ServingEngine(
            model, params, scheduler, spec_lat,
            num_slots=num_slots, max_seq=max_seq, capacity_tokens=cap,
            preemption_mode=cluster_cfg.preemption_mode,
            clock=clock, eos_id=eos_id, hotpath=hotpath,
            cache_dtype=cache_dtype, draft_model=draft_model,
            draft_params=draft_params, spec_k=spec_k, device=dev,
            reference_decode=reference_decode,
        )
    return factory


def mixed_backends(factories: Sequence[BackendFactory]) -> BackendFactory:
    """Replica i gets factories[i % len(factories)] — e.g. one real engine
    cross-checking a fleet of simulators."""
    if not factories:
        raise ValueError("at least one backend factory is required")
    fs = list(factories)

    def factory(replica_id: int, scheduler: Scheduler,
                lat: LatencyModel, cluster_cfg) -> SteppableBackend:
        return fs[replica_id % len(fs)](replica_id, scheduler, lat,
                                        cluster_cfg)
    return factory


__all__ = ["BackendFactory", "simulator_backend", "engine_backend",
           "speculative_backend", "mixed_backends"]
