"""Goodput + fairness scoring for the policy arena.

`core/objectives.py` answers "which batch should the scheduler pick";
this module answers "who actually won" after a run finishes — the
counter-metrics a QoE-maximizing policy must also report against
(the fairness-vs-avg-QoE tension made measurable):

  slo_goodput        SLO-attained work per second ("Revisiting SLOs"
                     family, PAPERS.md): only requests that met their
                     contract count, weighted by their delivered tokens
                     (or counted per-request with unit=\"requests\")
  jains_index        Jain's fairness index over per-tenant normalized
                     service, (Σx)²/(n·Σx²) ∈ (0, 1]; 1.0 = exact
                     weighted fair shares
  per_tenant_service per-tenant delivered tokens, weight-normalized
  max_min_service    min over tenants of normalized service — the
                     max-min yardstick VTC/WSC optimize
  fairness_report    one dict with all of the above + mean/min QoE,
                     the row `benchmarks/policy_arena.py` puts on the
                     scoreboard

Service is normalized by the tenant's contract weight (weight-2 tenants
are *entitled* to twice the tokens, so fair shares mean equal
service/weight), which makes the same metrics correct for both the
unweighted (VTC) and weighted (WSC/FAIRSERVE) notions of fairness.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.pricing import slo_attained
from repro_torch.core.request import Request


def jains_index(x: Sequence[float]) -> float:
    """Jain's fairness index (Σx)²/(n·Σx²); 1.0 when all equal."""
    v = np.asarray(list(x), np.float64)
    v = v[v >= 0]
    if v.size == 0 or not np.any(v > 0):
        return 1.0
    return float(v.sum() ** 2 / (v.size * np.square(v).sum()))


def _tenant_weight(reqs: Sequence[Request], tenant: int) -> float:
    for r in reqs:
        if r.tenant == tenant and r.contract is not None:
            return max(r.contract.weight, 1e-9)
    return 1.0


def per_tenant_service(reqs: Sequence[Request],
                       normalize: bool = True,
                       until: float = None) -> Dict[int, float]:
    """Delivered tokens per tenant, divided by the tenant's contract
    weight when `normalize` (equal values == weighted fair shares).

    `until` counts only tokens emitted at or before that absolute time.
    This matters for run-to-completion experiments: every policy
    eventually delivers every token, so *lifetime* service is
    policy-independent — fairness differentiates inside the contention
    window. Pass the last arrival time (what `fairness_report` does) to
    measure who got served while tenants were actually competing."""
    service: Dict[int, float] = {}
    for r in reqs:
        if until is None:
            tok = float(r.generated)
        else:
            tok = float(sum(1 for e in r.emit_times if e <= until))
        service[r.tenant] = service.get(r.tenant, 0.0) + tok
    if normalize:
        for t in service:
            service[t] /= _tenant_weight(reqs, t)
    return service


def max_min_service(reqs: Sequence[Request],
                    until: float = None) -> float:
    """Smallest weight-normalized per-tenant service (max-min yardstick)."""
    service = per_tenant_service(reqs, until=until)
    return min(service.values()) if service else 0.0


def slo_goodput(reqs: Sequence[Request], duration: float,
                default_floor: float = 0.9,
                unit: str = "tokens") -> float:
    """SLO goodput: work from requests that met their contract, per
    second. `unit=\"tokens\"` counts delivered tokens (throughput-style);
    `unit=\"requests\"` counts attained requests (capacity-style)."""
    if duration <= 0:
        return 0.0
    good = 0.0
    for r in reqs:
        if r.emit_times and slo_attained(r, default_floor):
            good += float(r.generated) if unit == "tokens" else 1.0
    return good / duration


def fairness_report(reqs: Sequence[Request], duration: float,
                    default_floor: float = 0.9) -> Dict[str, float]:
    """Everything the arena scoreboard reports for one (policy, trace,
    load) cell. QoE columns average over finished requests (unfinished
    ones never got their Eq. 1 curve completed). Fairness columns count
    service inside the contention window (up to the last arrival) —
    see `per_tenant_service`."""
    finished: List[Request] = [r for r in reqs if r.emit_times]
    qoes = np.array([r.final_qoe() for r in finished], np.float64)
    window = max((r.arrival for r in reqs), default=None)
    service = per_tenant_service(reqs, until=window)
    return {
        "n_requests": len(reqs),
        "n_finished": len(finished),
        "avg_qoe": float(qoes.mean()) if qoes.size else 0.0,
        "min_qoe": float(qoes.min()) if qoes.size else 0.0,
        "slo_attainment": (float(np.mean(
            [slo_attained(r, default_floor) for r in finished]))
            if finished else 0.0),
        "goodput_tok_s": slo_goodput(reqs, duration, default_floor),
        "goodput_req_s": slo_goodput(reqs, duration, default_floor,
                                     unit="requests"),
        "jains_index": jains_index(service.values()),
        "max_min_service": max_min_service(reqs, until=window),
        "n_tenants": len(service),
    }
