"""ShareGPT-like workload synthesis (paper §6.1, Fig. 9).

The real ShareGPT dump is not available offline; we match the published
shape of Fig. 9: input lengths roughly log-normal with median ≈ 160 tokens
(capped at 1k), outputs log-normal with median ≈ 200 tokens (capped at 1k),
and the Multi-Round variant concatenates rounds for ≈ 3× longer inputs with
the same output distribution.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.qoe import QoESpec
from repro_torch.core.request import Request
from repro_torch.workload.arrivals import gamma_arrivals, poisson_arrivals
from repro_torch.workload.qoe_traces import reading_qoe_trace


def sample_lengths(
    n: int,
    rng: np.random.Generator,
    dataset: str = "sharegpt",
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (prompt_len, output_len) int arrays."""
    if dataset == "sharegpt":
        p = rng.lognormal(mean=5.0, sigma=0.9, size=n)        # median ~148
    elif dataset == "multiround":
        p = rng.lognormal(mean=6.1, sigma=0.7, size=n)        # ~3x longer
    else:
        raise ValueError(dataset)
    o = rng.lognormal(mean=5.3, sigma=0.8, size=n)            # median ~200
    prompt = np.clip(p, 4, 1024).astype(np.int64)
    out = np.clip(o, 4, 1024).astype(np.int64)
    return prompt, out


def make_workload(
    n: int,
    rate: float,
    *,
    seed: int = 0,
    dataset: str = "sharegpt",
    arrival: str = "poisson",
    qoe_trace: str = "reading",
    cv: float = 3.0,
) -> List[Request]:
    rng = np.random.default_rng(seed)
    prompt, out = sample_lengths(n, rng, dataset)
    if arrival == "poisson":
        arrivals = poisson_arrivals(rate, n, rng)
    elif arrival == "gamma":
        arrivals = gamma_arrivals(rate, n, rng, cv=cv)
    else:
        raise ValueError(arrival)
    if qoe_trace == "reading":
        specs = reading_qoe_trace(n, rng)
    else:
        from repro_torch.workload.qoe_traces import voice_qoe_trace
        specs = voice_qoe_trace(n, rng)
    return [
        Request(
            rid=i,
            arrival=float(arrivals[i]),
            prompt_len=int(prompt[i]),
            output_len=int(out[i]),
            spec=specs[i],
        )
        for i in range(n)
    ]
