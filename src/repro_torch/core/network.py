"""Network link models for the client-side token path (Eloquent-style).

The paper's §5 client buffer assumes tokens arrive at the user exactly
when the server emits them. Over a real wire they do not: token streams
cross links with propagation delay, jitter, and loss, and Eloquent
(PAPERS.md) shows that streaming QoE is dominated by how the transport
turns those impairments into *stalls*. This module makes the link a
pluggable scenario axis:

  * `NetworkModel` — the identity link (arrival == emission), the default
    everywhere so existing timelines are byte-identical;
  * `JitterLossLink` — one-way propagation `delay`, exponential `jitter`,
    and per-token loss with an `rto` retransmission penalty, delivered
    IN ORDER (SSE rides TCP, so a delayed token head-of-line-blocks every
    later one: arrival_i = max(arrival_{i-1}, emit_i + latency_i));
  * `NETWORK_SCENARIOS` — a named catalog (ideal/broadband/wifi/lte/
    satellite/lossy_wifi) used by tests, benchmarks, and per-tenant
    workload specs.

Determinism and monotone coupling: every per-token draw is derived from a
seeded generator *by token index*, independent of impairment knobs — the
jitter of token i is `jitter * exp_i` for a fixed exponential draw, and
its retransmission count is the largest k with `u_i <= loss^k` for a
fixed uniform draw. The same seed therefore yields latencies that are
pointwise non-decreasing in `delay`, `jitter`, `loss`, and `rto`, which
is what lets tests assert "QoE degrades monotonically with loss" as an
exact property instead of a statistical one.

The §5 buffer composes with any of these (`TokenBuffer(tds,
network=...)`, `pace_delivery(..., network=...)`): the buffer paces the
post-link arrival timeline, absorbing jitter up to its accumulated lead.
`qoe_under_network` evaluates Eq. 1 on that degraded timeline.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.qoe import QoESpec, qoe_exact


class NetworkModel:
    """Identity link: tokens arrive the instant they are emitted.

    Subclasses override `latency(i)` (the one-way transit of the i-th
    token of a stream, independent of emission time) and inherit the
    in-order delivery rule. The model is *stateful per stream*: call
    `reset()` (or use a fresh instance / `clone()`) before replaying
    another stream so the head-of-line cursor and the per-index draws
    restart identically.
    """

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._count = 0
        self._last_arrival = -np.inf

    def clone(self) -> "NetworkModel":
        """A fresh same-configuration link (for replaying a stream)."""
        return type(self)()

    # ------------------------------------------------------------- per-token
    def latency(self, i: int) -> float:
        """One-way transit latency of the i-th token (seconds)."""
        return 0.0

    def transit(self, emit_time: float) -> float:
        """Arrival time of the next token emitted at `emit_time`.

        In-order (TCP) delivery: a token can never arrive before its
        predecessor, so one slow transit head-of-line-blocks the rest.
        """
        i = self._count
        self._count += 1
        arr = max(self._last_arrival, float(emit_time) + self.latency(i))
        self._last_arrival = arr
        return arr

    def arrivals(self, emit_times) -> np.ndarray:
        """Vectorized `transit` over a whole emission timeline (resets the
        stream first, so it is a pure function of the timeline)."""
        self.reset()
        e = np.asarray(emit_times, np.float64)
        out = np.empty_like(e)
        for i in range(e.size):
            out[i] = self.transit(e[i])
        self.reset()
        return out


@dataclasses.dataclass
class JitterLossLink(NetworkModel):
    """Delay + jitter + loss link with in-order delivery (module docstring).

    delay   one-way propagation + serialization floor (s)
    jitter  scale of an exponential per-token jitter term (s)
    loss    per-transmission loss probability; each loss costs `rto`
    rto     retransmission timeout charged per lost transmission (s)
    seed    per-stream draw seed (same seed => coupled, monotone draws)
    """
    delay: float = 0.0
    jitter: float = 0.0
    loss: float = 0.0
    rto: float = 0.2
    seed: int = 0

    def __post_init__(self) -> None:
        if not 0.0 <= self.loss < 1.0:
            raise ValueError(f"loss must be in [0, 1), got {self.loss}")
        self._exp_draws: List[float] = []   # fixed per-index draws,
        self._uni_draws: List[float] = []   #   independent of the knobs
        super().__init__()

    def clone(self) -> "JitterLossLink":
        return JitterLossLink(delay=self.delay, jitter=self.jitter,
                              loss=self.loss, rto=self.rto, seed=self.seed)

    def _draws(self, i: int) -> tuple:
        """(exponential, uniform) draws for token index i — extended
        lazily in index order from one seeded generator, so they depend
        only on (seed, i), never on the impairment parameters."""
        if i >= len(self._exp_draws):
            while len(self._exp_draws) <= i:
                rng = np.random.default_rng((self.seed,
                                             len(self._exp_draws)))
                self._exp_draws.append(float(rng.exponential()))
                u = float(rng.random())
                # guard the open interval so log(u) is finite
                self._uni_draws.append(min(max(u, 1e-12), 1.0 - 1e-12))
        return self._exp_draws[i], self._uni_draws[i]

    def retransmissions(self, i: int) -> int:
        """Lost transmissions before token i got through: the largest k
        with u_i <= loss^k (geometric by inversion — monotone in loss)."""
        if self.loss <= 0.0:
            return 0
        _, u = self._draws(i)
        return int(np.floor(np.log(u) / np.log(self.loss)))

    def latency(self, i: int) -> float:
        exp_draw, _ = self._draws(i)
        return (self.delay + self.jitter * exp_draw
                + self.rto * self.retransmissions(i))


def qoe_under_network(emit_times, arrival: float, spec: QoESpec,
                      network: Optional[NetworkModel] = None) -> float:
    """Eq. 1 QoE of a served request as experienced *behind* a link:
    the server emission timeline is pushed through the network model and
    the client buffer paces what actually arrives."""
    e = np.asarray(emit_times, np.float64)
    if network is not None:
        e = network.arrivals(e)
    return qoe_exact(e, arrival, spec, response_len=e.size)


# ---------------------------------------------------------------------------
# Scenario catalog
# ---------------------------------------------------------------------------

#: Named link conditions (rough consumer-access characterizations — the
#: point is a shared ordinal axis from clean to hostile, not calibration).
NETWORK_SCENARIOS: Dict[str, dict] = {
    "ideal":      dict(delay=0.0,   jitter=0.0,   loss=0.0),
    "broadband":  dict(delay=0.02,  jitter=0.005, loss=0.0),
    "wifi":       dict(delay=0.03,  jitter=0.02,  loss=0.005, rto=0.15),
    "lte":        dict(delay=0.06,  jitter=0.04,  loss=0.01,  rto=0.2),
    "satellite":  dict(delay=0.3,   jitter=0.05,  loss=0.01,  rto=0.6),
    "lossy_wifi": dict(delay=0.03,  jitter=0.03,  loss=0.08,  rto=0.25),
}


def make_network(name: str, seed: int = 0) -> NetworkModel:
    """Instantiate a scenario by name (see NETWORK_SCENARIOS)."""
    try:
        kw = NETWORK_SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown network scenario {name!r}; "
            f"known: {sorted(NETWORK_SCENARIOS)}") from None
    if name == "ideal":
        return NetworkModel()
    return JitterLossLink(seed=seed, **kw)


__all__ = [
    "NetworkModel", "JitterLossLink", "qoe_under_network",
    "NETWORK_SCENARIOS", "make_network",
]
