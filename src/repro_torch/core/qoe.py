"""Quality-of-Experience for text streaming (paper §3.1, Eq. 1).

Two layers:

1. **Exact, discrete** QoE — used for *reporting*: given the server's token
   emission timestamps, `pace_delivery` applies the client-side token buffer
   (§5: release at the user's expected TDS, first token immediately) and
   `qoe_exact` evaluates Eq. 1 on the resulting delivery curve.

2. **Fluid, vectorized** QoE state — used by the *scheduler*: a
   struct-of-arrays over all live requests, advanced in O(1) per event under
   a fluid (continuous-token) approximation, with closed-form
   `predict_qoe(Δt, rate)` for Q_serve(B) / Q_wait (paper Eq. 2, Fig. 7).
   The fluid model is what makes per-iteration scheduling cheap; the exact
   model is what the benchmarks report.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class QoESpec:
    """Expected token delivery timeline of a request."""
    ttft: float       # expected time-to-first-token (s)
    tds: float        # expected token delivery speed (tokens/s)


# ---------------------------------------------------------------------------
# Exact (reporting) path
# ---------------------------------------------------------------------------

def pace_delivery(emit_times: np.ndarray, tds: float,
                  network=None) -> np.ndarray:
    """Client-side token buffer (paper §5, Fig. 8).

    Token i becomes *visible* at d_i = max(e_i, d_{i-1} + 1/tds): the buffer
    withholds tokens arriving faster than the user's digest speed and
    releases them at exactly the expected TDS; the first token is shown as
    soon as it arrives.

    `network` (a repro.core.network.NetworkModel, optional) transits the
    server emission timeline through a delay/jitter/loss link first, so the
    buffer paces what actually *arrives* at the client.
    """
    e = np.asarray(emit_times, dtype=np.float64)
    if e.size == 0:
        return e
    if network is not None:
        e = network.arrivals(e)
    gap = 1.0 / tds
    d = np.empty_like(e)
    d[0] = e[0]
    for i in range(1, e.size):
        d[i] = max(e[i], d[i - 1] + gap)
    return d


def expected_area(t: float, spec: QoESpec, cap: Optional[float] = None) -> float:
    """∫₀ᵗ min(T(τ), cap) dτ with T(τ) = tds·(τ − ttft)⁺  (Eq. 1 denominator)."""
    if t <= spec.ttft:
        return 0.0
    if cap is None or cap <= 0:
        ramp_end = t
    else:
        ramp_end = min(t, spec.ttft + cap / spec.tds)
    area = 0.5 * spec.tds * (ramp_end - spec.ttft) ** 2
    if cap is not None and cap > 0 and t > ramp_end:
        area += cap * (t - ramp_end)
    return area


def actual_area(delivery_times: np.ndarray, t: float) -> float:
    """∫₀ᵗ A(τ) dτ where A is the delivered-token staircase."""
    d = np.asarray(delivery_times, dtype=np.float64)
    return float(np.sum(np.maximum(t - d[d <= t], 0.0)))


def qoe_exact(
    emit_times: np.ndarray,
    arrival: float,
    spec: QoESpec,
    *,
    response_len: Optional[int] = None,
) -> float:
    """Eq. 1: QoE = S_actual / S_expected over [arrival, TTLT], both curves
    measured on the *user-visible* (buffer-paced) delivery timeline."""
    e = np.asarray(emit_times, dtype=np.float64) - arrival
    if e.size == 0:
        return 0.0
    d = pace_delivery(e, spec.tds)
    ttlt = float(d[-1])
    l = response_len if response_len is not None else e.size
    s_exp = expected_area(ttlt, spec, cap=l)
    if s_exp <= 0.0:
        return 1.0
    s_act = actual_area(d, ttlt)
    return float(np.clip(s_act / s_exp, 0.0, 1.0))


def ttft_actual(emit_times: np.ndarray, arrival: float) -> float:
    e = np.asarray(emit_times, dtype=np.float64)
    return float(e[0] - arrival) if e.size else float("inf")


def tds_actual(emit_times: np.ndarray) -> float:
    """Average observed delivery speed excluding TTFT (paper Table 4)."""
    e = np.asarray(emit_times, dtype=np.float64)
    if e.size < 2 or e[-1] <= e[0]:
        return float("inf")
    return (e.size - 1) / (e[-1] - e[0])


def predict_request_qoe(
    spec: QoESpec,
    delay: float,
    rate: float,
    dt: float,
    exp_len: float,
) -> float:
    """Fluid QoE of a *fresh* (not yet admitted) request after horizon dt,
    if its first token appears after `delay` seconds and tokens then flow at
    `rate` tokens/s until the estimated length `exp_len` is generated.

    Scalar companion of `FluidQoE.predict_qoe` for requests that have no
    fluid slot yet — the cluster router and admission controller (paper
    §6.4 surge handling, extended fleet-wide in repro.cluster) score
    hypothetical placements with it. The client buffer caps the visible
    delivery speed at the user's expected TDS, so the visible curve ramps
    at min(rate, tds).
    """
    if dt <= 0:
        return 1.0
    delay = min(max(delay, 0.0), dt)
    s_act = 0.0
    if rate > 0 and delay < dt:
        vis_rate = min(rate, spec.tds)
        # visible ramp lasts until exp_len tokens are shown (or horizon)
        t_ramp = min(dt - delay, exp_len / max(vis_rate, 1e-12))
        s_act += 0.5 * vis_rate * t_ramp * t_ramp
        t_flat = (dt - delay) - t_ramp
        s_act += vis_rate * t_ramp * t_flat
    s_exp = expected_area(dt, spec, cap=exp_len)
    if s_exp <= 0.0:
        return 1.0
    return float(np.clip(s_act / s_exp, 0.0, 1.0))


# ---------------------------------------------------------------------------
# Fluid (scheduling) path — struct-of-arrays over live requests
# ---------------------------------------------------------------------------

class FluidQoE:
    """Vectorized fluid QoE state for N live requests.

    Fields (np.float64 arrays, index = request slot):
      arrival   absolute arrival time
      ttft_e / tds_e   the request's QoESpec
      n_vis     tokens visible to the user (fluid)
      buf       tokens in the client buffer
      s_act     accumulated ∫A dτ (relative to arrival)
      t_last    absolute time of last update
      emitted   tokens emitted by the server so far
    """

    FIELDS = ("arrival", "ttft_e", "tds_e", "n_vis", "buf", "s_act",
              "t_last", "emitted")

    def __init__(self, capacity: int = 0):
        for f in self.FIELDS:
            setattr(self, f, np.zeros(capacity, np.float64))

    def clone_slots(self, idx) -> "FluidQoE":
        """Compact deep copy of only the given slots (positional reindex).

        The cluster router (repro.cluster.router) evaluates hypothetical
        placements with `predict_qoe`, whose internal `advance(t)` moves
        `t_last` forward; querying a copy keeps the replica's own fluid
        state byte-identical to an unrouted run (the 1-replica invariance
        guarantee). Slots are grow-only (finished requests keep theirs),
        so the copy is restricted to the slots the caller cares about —
        cloning the full state per routing decision would make fleet
        routing O(total requests) per query."""
        out = FluidQoE()
        for f in self.FIELDS:
            setattr(out, f, getattr(self, f)[idx].copy())
        return out

    def add(self, arrival: float, spec: QoESpec) -> int:
        """Append a request; returns its slot index."""
        for f in self.FIELDS:
            arr = getattr(self, f)
            setattr(self, f, np.append(arr, 0.0))
        i = self.arrival.size - 1
        self.arrival[i] = arrival
        self.ttft_e[i] = spec.ttft
        self.tds_e[i] = spec.tds
        self.t_last[i] = arrival
        return i

    # -- fluid dynamics ------------------------------------------------------

    def advance(self, t: float, idx=None) -> None:
        """Drain client buffers up to absolute time t (no new emissions)."""
        sl = slice(None) if idx is None else idx
        dt = np.maximum(t - self.t_last[sl], 0.0)
        tds = self.tds_e[sl]
        g = np.minimum(self.buf[sl], tds * dt)
        # visible rises at tds for g/tds, then flat
        self.s_act[sl] += self.n_vis[sl] * dt + g * dt - g * g / (2.0 * tds)
        self.n_vis[sl] += g
        self.buf[sl] -= g
        self.t_last[sl] = t

    def emit(self, idx, t: float, k: float = 1.0) -> None:
        """Server emitted k tokens for request(s) idx at time t."""
        self.advance(t, idx)
        first = self.emitted[idx] == 0
        # the buffer releases the first token immediately
        self.n_vis[idx] = np.where(
            first, self.n_vis[idx] + 1.0, self.n_vis[idx]
        )
        self.buf[idx] += np.where(first, k - 1.0, float(k))
        self.emitted[idx] += k

    # -- QoE queries ---------------------------------------------------------

    def _expected_area_vec(self, t_rel, cap=None):
        ttft, tds = self.ttft_e, self.tds_e
        if cap is None:
            ramp_end = np.maximum(t_rel, ttft)
        else:
            ramp_end = np.minimum(np.maximum(t_rel, ttft), ttft + cap / tds)
        area = 0.5 * tds * (ramp_end - ttft) ** 2
        if cap is not None:
            area += np.maximum(cap, 0.0) * np.maximum(t_rel - ramp_end, 0.0)
        return area

    def qoe_now(self, t: float, exp_len: np.ndarray = None) -> np.ndarray:
        """Current fluid QoE of every request."""
        self.advance(t)
        if exp_len is not None:
            exp_len = np.maximum(exp_len, np.maximum(self.emitted, 1.0))
        s_exp = self._expected_area_vec(t - self.arrival, cap=exp_len)
        out = np.ones_like(s_exp)
        nz = s_exp > 0
        out[nz] = np.clip(self.s_act[nz] / s_exp[nz], 0.0, 1.0)
        return out

    def predict_qoe(
        self,
        t: float,
        dt: float,
        rate: np.ndarray,
        delay: np.ndarray = None,
        exp_len: np.ndarray = None,
    ) -> np.ndarray:
        """QoE after horizon dt if request i receives tokens at rate[i]
        (tokens/s) starting after delay[i] seconds (prefill time; 0 = already
        decoding). rate=0 gives Q_wait. Paper Eq. 2 / Fig. 7.

        exp_len: estimated final response length l̂ (Eq. 1 caps the expected
        curve at l). This is what distinguishes "already sufficiently served"
        (delivered area ≈ capped expected area ⇒ Q_wait high ⇒ safe to
        preempt) from "starving" (Q_wait collapsing ⇒ urgent). Generation
        also stops once emitted reaches l̂.

        Pure function: does NOT mutate state (operates on copies).
        """
        n = self.arrival.size
        rate = np.broadcast_to(np.asarray(rate, np.float64), (n,))
        return self.predict_qoe_grid(t, dt, rate[None, :], delay, exp_len)[0]

    def predict_qoe_grid(
        self,
        t: float,
        dt: float,
        rates: np.ndarray,
        delay: np.ndarray = None,
        exp_len: np.ndarray = None,
    ) -> np.ndarray:
        """`predict_qoe` evaluated for a whole grid of serving rates in one
        vectorized pass: rates (nB,) — one hypothetical rate per candidate
        batch size — or (nB, n) per (candidate, request). Returns (nB, n).

        This is the scheduler-knapsack hot path: the per-request fluid
        state, delays, and l̂ do not depend on the candidate B, so pricing
        all 12 candidates is one broadcast over the rate axis instead of 12
        re-derivations (QoEPricer.serve_gains_grid). Every operation is
        elementwise, so each row is bit-identical to a scalar-rate
        `predict_qoe` call — the greedy knapsack sees the exact same gains.
        """
        n = self.arrival.size
        rates = np.asarray(rates, np.float64)
        if rates.ndim == 1:
            rates = rates[:, None]
        rate = np.broadcast_to(rates, (rates.shape[0], n))
        delay = (np.zeros(n) if delay is None
                 else np.broadcast_to(np.asarray(delay, np.float64), (n,)).copy())
        delay = np.minimum(delay, dt)
        if exp_len is not None:
            exp_len = np.maximum(
                np.broadcast_to(np.asarray(exp_len, np.float64), (n,)),
                np.maximum(self.emitted, 1.0),
            )

        # local copies of fluid state, advanced to t first
        self.advance(t)
        n_vis = self.n_vis.copy()
        buf = self.buf.copy()
        s_act = self.s_act.copy()
        tds = self.tds_e

        def seg(seg_len, inflow, n_vis, buf, s_act):
            """Advance fluid state by seg_len with server inflow rate."""
            # phase A: buffer (plus inflow) sustains drain at tds
            net = tds - inflow                      # buffer depletion rate
            with np.errstate(divide="ignore", invalid="ignore"):
                tau = np.where(net > 0, buf / np.where(net > 0, net, 1.0), np.inf)
            ta = np.minimum(seg_len, tau)           # time visible grows at tds
            s_act = s_act + n_vis * ta + 0.5 * tds * ta * ta
            n_vis = n_vis + tds * ta
            buf = np.maximum(buf - net * ta, 0.0)
            # phase B: buffer empty, visible grows at inflow
            tb = seg_len - ta
            grow = np.minimum(inflow, tds)
            s_act = s_act + n_vis * tb + 0.5 * grow * tb * tb
            n_vis = n_vis + grow * tb
            return n_vis, buf, s_act

        # segment 1: [0, delay) — no inflow (rate-independent, stays (n,))
        n_vis, buf, s_act = seg(delay, np.zeros(n), n_vis, buf, s_act)
        # segment 2: [delay, delay+t_gen) — inflow at `rate` until l̂ reached
        seg2 = dt - delay
        if exp_len is not None:
            remaining = np.maximum(exp_len - self.emitted, 0.0)
            with np.errstate(divide="ignore", invalid="ignore"):
                t_gen = np.where(rate > 0, remaining / np.where(rate > 0, rate, 1.0), 0.0)
            t_gen = np.minimum(seg2, t_gen)
        else:
            t_gen = np.where(rate > 0, seg2, 0.0)
        n_vis, buf, s_act = seg(t_gen, rate, n_vis, buf, s_act)
        # segment 3: rest — generation finished / not served, buffer drains
        n_vis, buf, s_act = seg(seg2 - t_gen, np.zeros(n)[None, :], n_vis,
                                buf, s_act)

        t_rel = (t + dt) - self.arrival
        s_exp = self._expected_area_vec(t_rel, cap=exp_len)
        s_act = np.broadcast_to(s_act, rate.shape)
        out = np.ones(rate.shape)
        nz = np.broadcast_to(s_exp > 0, rate.shape)
        out[nz] = np.clip(s_act[nz] / np.broadcast_to(s_exp, rate.shape)[nz],
                          0.0, 1.0)
        return out
