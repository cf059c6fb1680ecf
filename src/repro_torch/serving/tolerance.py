"""Tolerance-based differential harness for wall-clock serving.

Every verification spine in this repo so far is *bit-exact*: same trace in,
byte-identical timeline out (steppable vs. legacy loop, sim vs. engine,
hotpath on vs. off, ...). A wall-clock engine (`clock="wall"`) breaks that
by construction — its timestamps are real `time.monotonic()` readings
carrying OS scheduling jitter, sleep quantization, and host load — so
wall runs need a different contract, split in two:

* **Token text stays bit-exact.** The clock decides *when* things happen,
  never *what* is computed: per-slot decode is row-independent and swap
  preemption moves exact cache slices. So for the same trace with the
  same admission order, the wall run's emitted token ids must match the
  virtual-clock reference 1:1 per rid — a hard gate, no tolerance.

* **Timing agrees in distribution.** Per-request TTFT/TDS/QoE cannot
  match exactly, so the harness gates summary statistics of the paired
  differences (mean / p95 / max of |Δ|) under stated absolute+relative
  tolerances. The tolerances ARE the spec of `clock="wall"`: a host too
  slow to keep the LatencyModel schedule fails here, visibly, instead of
  silently reporting drifted QoE numbers.

`compare_requests(ref, cand)` pairs two request populations by rid and
returns a `ToleranceReport` whose `assert_ok()` raises with the full gate
table — what the tolerance tests and the server's smoke run call.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.request import Request


@dataclasses.dataclass(frozen=True)
class Tolerance:
    """|cand - ref| <= abs_tol + rel_tol * |ref| (numpy.isclose shape)."""
    abs_tol: float = 0.0
    rel_tol: float = 0.0

    def ok(self, ref: float, cand: float) -> bool:
        if np.isnan(ref) and np.isnan(cand):
            return True
        return abs(cand - ref) <= self.abs_tol + self.rel_tol * abs(ref)

    def __str__(self) -> str:
        return f"abs={self.abs_tol:g} rel={self.rel_tol:g}"


@dataclasses.dataclass(frozen=True)
class ToleranceSpec:
    """The gate set for one wall-vs-virtual comparison.

    The distribution gates bound statistics of the *paired per-request
    absolute differences* (|metric_cand - metric_ref| per rid), except the
    `*_mean_of` gates which compare the two population means directly.
    Defaults are sized for the smoke-model timescale (~4-16 ms per decode
    iteration): generous enough for CI-runner sleep jitter, tight enough
    that a host failing to keep the schedule (or a logic change altering
    admission order) trips them.
    """
    # paired per-request |Δ| statistics (seconds / tokens-per-s / QoE units)
    ttft_mean_diff: Tolerance = Tolerance(abs_tol=0.050)
    ttft_p95_diff: Tolerance = Tolerance(abs_tol=0.150)
    ttft_max_diff: Tolerance = Tolerance(abs_tol=0.500)
    tds_mean_diff: Tolerance = Tolerance(abs_tol=0.50, rel_tol=0.10)
    qoe_mean_diff: Tolerance = Tolerance(abs_tol=0.05)
    qoe_max_diff: Tolerance = Tolerance(abs_tol=0.25)
    # population-mean agreement (catches one-sided drift the paired means
    # also see, but reads directly as "the reported headline number moved")
    qoe_mean_of: Tolerance = Tolerance(abs_tol=0.03)
    require_token_identity: bool = True


@dataclasses.dataclass(frozen=True)
class GateResult:
    name: str
    ref: float          # reference-side value (0.0 for |Δ| statistics)
    cand: float         # candidate-side / statistic value
    tol: Tolerance
    passed: bool

    def line(self) -> str:
        mark = "PASS" if self.passed else "FAIL"
        return (f"  [{mark}] {self.name:<18} stat={self.cand:.6g} "
                f"(ref={self.ref:.6g}, tol {self.tol})")


@dataclasses.dataclass
class ToleranceReport:
    """Outcome of one differential comparison (see compare_requests)."""
    gates: List[GateResult]
    n_pairs: int
    missing_rids: List[int]           # in ref but not in cand (or reverse)
    token_mismatches: List[int]       # rids whose token ids differ
    skipped_rids: List[int]           # cancelled/shed on either side

    @property
    def ok(self) -> bool:
        return (not self.missing_rids and not self.token_mismatches
                and all(g.passed for g in self.gates))

    def summary(self) -> str:
        lines = [f"tolerance report: {self.n_pairs} paired requests, "
                 f"{len(self.skipped_rids)} skipped, "
                 f"{'OK' if self.ok else 'FAILED'}"]
        if self.missing_rids:
            lines.append(f"  [FAIL] unpaired rids: {self.missing_rids[:10]}"
                         + (" ..." if len(self.missing_rids) > 10 else ""))
        if self.token_mismatches:
            lines.append("  [FAIL] token text differs for rids: "
                         f"{self.token_mismatches[:10]}"
                         + (" ..." if len(self.token_mismatches) > 10
                            else ""))
        lines.extend(g.line() for g in self.gates)
        return "\n".join(lines)

    def assert_ok(self) -> None:
        if not self.ok:
            raise AssertionError(self.summary())


def _finite_pairs(ref: np.ndarray, cand: np.ndarray):
    """Drop pairs where either side is non-finite (TDS of a 0/1-token
    response is inf on both sides; comparing inf-inf would poison every
    statistic)."""
    m = np.isfinite(ref) & np.isfinite(cand)
    return ref[m], cand[m]


def _gate(name: str, stat: float, tol: Tolerance,
          ref_val: float = 0.0) -> GateResult:
    """Gate on a non-negative |Δ| statistic: stat must stay within
    abs_tol + rel_tol * |ref_val| (ref_val = the reference-side scale the
    relative part is measured against; 0 for purely absolute gates)."""
    bound = tol.abs_tol + tol.rel_tol * abs(ref_val)
    return GateResult(name, ref_val, stat, tol, stat <= bound)


def compare_requests(
    ref: Sequence[Request],
    cand: Sequence[Request],
    spec: Optional[ToleranceSpec] = None,
) -> ToleranceReport:
    """Differential-compare two served populations of the same trace.

    `ref` is the ground truth (virtual-clock run), `cand` the run under
    test (wall-clock). Pairing is by rid. Requests cancelled or unserved
    on either side are excluded from timing statistics (reported in
    `skipped_rids`) but still token-checked over the shorter prefix.
    """
    spec = spec if spec is not None else ToleranceSpec()
    ref_by: Dict[int, Request] = {r.rid: r for r in ref}
    cand_by: Dict[int, Request] = {r.rid: r for r in cand}
    missing = sorted(set(ref_by) ^ set(cand_by))
    common = sorted(set(ref_by) & set(cand_by))

    token_mismatches: List[int] = []
    skipped: List[int] = []
    ttft_r, ttft_c, tds_r, tds_c, qoe_r, qoe_c = [], [], [], [], [], []
    for rid in common:
        a, b = ref_by[rid], cand_by[rid]
        if spec.require_token_identity:
            ta, tb = list(a.output_tokens), list(b.output_tokens)
            partial = a.cancelled or b.cancelled
            n = min(len(ta), len(tb))
            if (ta[:n] != tb[:n]) or (not partial and len(ta) != len(tb)):
                token_mismatches.append(rid)
        if a.cancelled or b.cancelled or not a.emit_times \
                or not b.emit_times:
            skipped.append(rid)
            continue
        ttft_r.append(a.final_ttft()); ttft_c.append(b.final_ttft())
        tds_r.append(a.final_tds());   tds_c.append(b.final_tds())
        qoe_r.append(a.final_qoe());   qoe_c.append(b.final_qoe())

    gates: List[GateResult] = []
    n_pairs = len(ttft_r)
    if n_pairs:
        ttft_r = np.asarray(ttft_r); ttft_c = np.asarray(ttft_c)
        qoe_r = np.asarray(qoe_r);   qoe_c = np.asarray(qoe_c)
        d_ttft = np.abs(ttft_c - ttft_r)
        gates.append(_gate("ttft_mean_diff", float(d_ttft.mean()),
                           spec.ttft_mean_diff))
        gates.append(_gate("ttft_p95_diff",
                           float(np.percentile(d_ttft, 95)),
                           spec.ttft_p95_diff))
        gates.append(_gate("ttft_max_diff", float(d_ttft.max()),
                           spec.ttft_max_diff))
        fr, fc = _finite_pairs(np.asarray(tds_r), np.asarray(tds_c))
        if fr.size:
            d_tds = np.abs(fc - fr)
            gates.append(_gate("tds_mean_diff", float(d_tds.mean()),
                               spec.tds_mean_diff,
                               ref_val=float(fr.mean())))
        d_qoe = np.abs(qoe_c - qoe_r)
        gates.append(_gate("qoe_mean_diff", float(d_qoe.mean()),
                           spec.qoe_mean_diff))
        gates.append(_gate("qoe_max_diff", float(d_qoe.max()),
                           spec.qoe_max_diff))
        gates.append(GateResult(
            "qoe_mean_of", float(qoe_r.mean()), float(qoe_c.mean()),
            spec.qoe_mean_of,
            spec.qoe_mean_of.ok(float(qoe_r.mean()), float(qoe_c.mean()))))

    return ToleranceReport(gates=gates, n_pairs=n_pairs,
                           missing_rids=missing,
                           token_mismatches=token_mismatches,
                           skipped_rids=skipped)


__all__ = ["Tolerance", "ToleranceSpec", "GateResult", "ToleranceReport",
           "compare_requests"]
