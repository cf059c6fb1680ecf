"""The KV pool a deployment gives the engine: vLLM's documented default
``gpu_memory_utilization=0.9`` of the card's memory, less the weights and
the peak of the warm steps at the cell's batch, in whole pages of the
model's KV bytes per token."""
from __future__ import annotations

GPU_MEMORY_UTILIZATION = 0.9


def pool_tokens(total_bytes: int, weight_bytes: int, step_peak_bytes: int,
                kv_bytes_per_token: int, page_size: int,
                utilization: float = GPU_MEMORY_UTILIZATION) -> int:
    free = utilization * total_bytes - weight_bytes - step_peak_bytes
    if free <= 0:
        raise ValueError("the weights and one step leave no room for a pool")
    pages = int(free // (kv_bytes_per_token * page_size))
    return pages * page_size

