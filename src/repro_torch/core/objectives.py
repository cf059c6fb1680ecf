"""Scheduling objectives (paper §4.1 Eq. 2 and Appendix A Eqs. 6–7).

Each objective maps (Q_serve, Q_wait, Q_now) vectors to per-request *gains*
(the knapsack item values). The scheduler maximizes the total gain of the
served set.
"""
from __future__ import annotations

import numpy as np

PERFECT_TOL = 1e-3


def avg_qoe(q_serve: np.ndarray, q_wait: np.ndarray, q_now: np.ndarray) -> np.ndarray:
    """Eq. 2 — maximize average QoE: gain_i = Q_serve,i − Q_wait,i."""
    return q_serve - q_wait


# Eqs. 6/7 produce zero gain for most requests most of the time (only the
# floor request / currently-perfect requests earn value). A pure
# implementation therefore loses all discrimination among the zero-gain
# majority and degrades into churn — especially once one unsalvageable
# request anchors Q_min ~ 0. We blend in an epsilon of the Eq. 2 gain as a
# tiebreak so the secondary ordering stays QoE-aware (implementation choice
# documented in DESIGN.md; the primary term still dominates decisions).
EPS_TIEBREAK = 0.01


def max_min_qoe(q_serve: np.ndarray, q_wait: np.ndarray, q_now: np.ndarray) -> np.ndarray:
    """Eq. 6 — lift the QoE floor: gain_i = max(Q_min − Q_wait,i, 0)."""
    if q_now.size == 0:
        return np.zeros(0)
    q_min = float(np.min(q_now))
    return (np.maximum(q_min - q_wait, 0.0)
            + EPS_TIEBREAK * (q_serve - q_wait))


def perfect_count(q_serve: np.ndarray, q_wait: np.ndarray, q_now: np.ndarray) -> np.ndarray:
    """Eq. 7 — maximize requests that keep QoE = 1."""
    s1 = (q_serve >= 1.0 - PERFECT_TOL).astype(np.float64)
    w1 = (q_wait >= 1.0 - PERFECT_TOL).astype(np.float64)
    n1 = (q_now >= 1.0 - PERFECT_TOL).astype(np.float64)
    return (s1 - w1) * n1 + EPS_TIEBREAK * (q_serve - q_wait)


OBJECTIVES = {
    "avg_qoe": avg_qoe,
    "max_min_qoe": max_min_qoe,
    "perfect_count": perfect_count,
}


# ---------------------------------------------------------------------------
# Fleet-level aggregation (cluster layer, paper §6.4 extended)
#
# The single-engine objectives above value a *batch* choice inside one
# replica; the cluster router/admission/autoscaler (repro.cluster) need the
# same vocabulary one level up: how good is the fleet, given each replica's
# per-request QoE vector? Shed requests enter as zeros — degrading
# gracefully under surge means accounting for who we turned away.
# ---------------------------------------------------------------------------

def fleet_qoes(per_replica: "list[np.ndarray]", n_shed: int = 0) -> np.ndarray:
    """Concatenate per-replica QoE vectors, appending a zero per shed
    request."""
    parts = [np.asarray(q, np.float64) for q in per_replica if len(q)]
    if n_shed:
        parts.append(np.zeros(n_shed))
    return np.concatenate(parts) if parts else np.zeros(0)


def fleet_avg_qoe(per_replica: "list[np.ndarray]", n_shed: int = 0) -> float:
    q = fleet_qoes(per_replica, n_shed)
    return float(q.mean()) if q.size else 1.0


def fleet_min_qoe(per_replica: "list[np.ndarray]", n_shed: int = 0) -> float:
    q = fleet_qoes(per_replica, n_shed)
    return float(q.min()) if q.size else 1.0


def fleet_slo_attainment(
    per_replica: "list[np.ndarray]",
    threshold: float = 0.9,
    n_shed: int = 0,
) -> float:
    """Fraction of requests meeting the QoE SLO (§6.1 capacity metric,
    fleet-wide). This is the autoscaler's feedback signal."""
    q = fleet_qoes(per_replica, n_shed)
    return float((q >= threshold).mean()) if q.size else 1.0


FLEET_OBJECTIVES = {
    "fleet_avg_qoe": fleet_avg_qoe,
    "fleet_min_qoe": fleet_min_qoe,
    "fleet_slo_attainment": fleet_slo_attainment,
}
