"""QoE arithmetic of the Andes paper (Eq. 1, the client buffer of Fig. 8).

A frozen copy of ``repro_torch.core.qoe``'s ``pace_delivery``,
``expected_area``, ``actual_area`` and ``qoe_exact`` (the same floats for
the same inputs), plus ``qoe_until``: Eq. 1 evaluated at a horizon, for a
request still streaming when the measured window closes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def pace_delivery(emit_times, tds: float) -> np.ndarray:
    """Client-side buffer: token i becomes visible at
    d_i = max(e_i, d_{i-1} + 1/tds); the first is shown when it arrives."""
    e = np.asarray(emit_times, dtype=np.float64)
    if e.size == 0:
        return e
    gap = 1.0 / tds
    d = np.empty_like(e)
    d[0] = e[0]
    for i in range(1, e.size):
        d[i] = max(e[i], d[i - 1] + gap)
    return d


def expected_area(t: float, ttft: float, tds: float,
                  cap: Optional[float] = None) -> float:
    """Integral over [0, t] of min(T(tau), cap), T(tau) = tds * (tau - ttft)+."""
    if t <= ttft:
        return 0.0
    if cap is None or cap <= 0:
        ramp_end = t
    else:
        ramp_end = min(t, ttft + cap / tds)
    area = 0.5 * tds * (ramp_end - ttft) ** 2
    if cap is not None and cap > 0 and t > ramp_end:
        area += cap * (t - ramp_end)
    return area


def actual_area(delivery_times, t: float) -> float:
    """Integral over [0, t] of the delivered-token staircase."""
    d = np.asarray(delivery_times, dtype=np.float64)
    return float(np.sum(np.maximum(t - d[d <= t], 0.0)))


def qoe_exact(emit_times, arrival: float, ttft: float, tds: float, *,
              response_len: Optional[int] = None) -> float:
    """Eq. 1 over [arrival, TTLT] on the buffer-paced delivery timeline."""
    e = np.asarray(emit_times, dtype=np.float64) - arrival
    if e.size == 0:
        return 0.0
    d = pace_delivery(e, tds)
    ttlt = float(d[-1])
    n = response_len if response_len is not None else e.size
    s_exp = expected_area(ttlt, ttft, tds, cap=n)
    if s_exp <= 0.0:
        return 1.0
    return float(np.clip(actual_area(d, ttlt) / s_exp, 0.0, 1.0))


def qoe_until(emit_times, arrival: float, ttft: float, tds: float,
              horizon: float, response_len: int) -> float:
    """Eq. 1 of a request cut at `horizon` (absolute time): the expected
    curve (capped at its full `response_len`) against what the buffer had
    shown by then. No token by the horizon scores 0 once the expected
    curve has started, and 1 before it."""
    t = horizon - arrival
    s_exp = expected_area(t, ttft, tds, cap=response_len)
    if s_exp <= 0.0:
        return 1.0
    e = np.asarray(emit_times, dtype=np.float64) - arrival
    d = pace_delivery(e[e <= t], tds)
    return float(np.clip(actual_area(d, t) / s_exp, 0.0, 1.0))


def request_qoe(emit_times, arrival: float, ttft: float, tds: float,
                output_len: int, horizon: float) -> float:
    """The score of one request due in the window: Eq. 1 as the paper
    takes it when every token was emitted before the horizon, else
    ``qoe_until`` at the horizon."""
    if len(emit_times) >= output_len and emit_times[-1] <= horizon:
        return qoe_exact(emit_times, arrival, ttft, tds,
                         response_len=output_len)
    return qoe_until(emit_times, arrival, ttft, tds, horizon, output_len)
