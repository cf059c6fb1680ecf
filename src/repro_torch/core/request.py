"""Request lifecycle for the serving runtime (engine and simulator)."""
from __future__ import annotations

import dataclasses
import enum
from typing import TYPE_CHECKING, List, Optional

import numpy as np

from repro_torch.core.qoe import QoESpec, qoe_exact, tds_actual, ttft_actual

if TYPE_CHECKING:  # pricing imports request; annotation only, no cycle
    from repro_torch.core.pricing import SLOContract


class ReqState(enum.Enum):
    WAITING = "waiting"      # queued, never served or preempted-by-recompute
    RUNNING = "running"      # in the current decode batch
    SWAPPED = "swapped"      # preempted; KV/state parked in host RAM
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float
    prompt_len: int
    spec: QoESpec
    # ground-truth response length (simulator) / max tokens (engine)
    output_len: int
    prompt_tokens: Optional[np.ndarray] = None       # real engine only
    tenant: int = 0              # multi-tenant traces (cluster layer)
    priority: int = 0            # priority class (0 = default; pricing
                                 # weighs class p as (1+p)x, core.pricing)
    contract: Optional["SLOContract"] = None   # per-tenant SLO contract;
                                 # None prices as the uniform default

    state: ReqState = ReqState.WAITING
    generated: int = 0
    emit_times: List[float] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    prefill_cursor: int = 0      # chunked prefill: context tokens already
                                 # committed to the device cache; 0 when not
                                 # mid-prefill (engine clears it on the
                                 # final chunk / recompute preemption)
    fluid_idx: int = -1          # slot in the scheduler's FluidQoE arrays
    engine_slot: int = -1        # slot in the static KV cache (engine)
    prefilled: bool = False      # KV/state for the prompt exists somewhere
    finish_time: float = float("nan")
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    cancelled: bool = False      # aborted by the client (server disconnect /
                                 # explicit cancel) — FINISHED early, partial
                                 # output; QoE reporting should exclude these

    def clone(self) -> "Request":
        """A fresh, unserved copy: identity fields (rid/arrival/lengths/
        spec/prompt/tenant) carried over, all lifecycle state reset.
        This is what differential tests and the cluster layer use to run
        the same workload through two backends."""
        return Request(
            rid=self.rid, arrival=self.arrival, prompt_len=self.prompt_len,
            spec=self.spec, output_len=self.output_len,
            prompt_tokens=self.prompt_tokens, tenant=self.tenant,
            priority=self.priority, contract=self.contract,
        )

    # ---- knapsack weight (l_i) -------------------------------------------
    @property
    def context_len(self) -> int:
        return self.prompt_len + self.generated

    def kv_tokens(self, state_equiv_tokens: int = 0) -> int:
        """Scheduler weight: KV entries consumed (attention archs grow with
        context; SSM archs pay a constant state, see DESIGN.md §4)."""
        if state_equiv_tokens:
            return state_equiv_tokens
        return max(self.context_len, 1)

    # ---- QoE reporting ------------------------------------------------------
    def final_qoe(self) -> float:
        return qoe_exact(
            np.asarray(self.emit_times), self.arrival, self.spec,
            response_len=self.generated,
        )

    def final_ttft(self) -> float:
        return ttft_actual(np.asarray(self.emit_times), self.arrival)

    def final_tds(self) -> float:
        return tds_actual(np.asarray(self.emit_times))

    @property
    def is_live(self) -> bool:
        return self.state != ReqState.FINISHED

    def normalized_latency(self) -> float:
        """End-to-end latency / output length (paper Appendix E)."""
        if not self.emit_times or self.generated == 0:
            return float("inf")
        return (self.emit_times[-1] - self.arrival) / self.generated
