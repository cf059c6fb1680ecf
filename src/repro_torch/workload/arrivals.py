"""Request arrival processes (paper §6.1 / §6.4)."""
from __future__ import annotations

import numpy as np


def poisson_arrivals(rate: float, n: int, rng: np.random.Generator) -> np.ndarray:
    """n arrival timestamps with exponential inter-arrivals at `rate` req/s."""
    gaps = rng.exponential(1.0 / rate, size=n)
    return np.cumsum(gaps)


def gamma_arrivals(
    rate: float, n: int, rng: np.random.Generator, cv: float = 3.0
) -> np.ndarray:
    """Bursty arrivals: Gamma inter-arrival with coefficient of variation cv
    and the same mean rate (paper §6.4 uses cv = 3)."""
    shape = 1.0 / (cv * cv)
    scale = 1.0 / (rate * shape)
    gaps = rng.gamma(shape, scale, size=n)
    return np.cumsum(gaps)
