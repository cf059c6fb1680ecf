"""Run results shared by every backend (the `SimResult` of the reference
simulator; the discrete-event simulator itself is not ported yet)."""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core.request import Request


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
