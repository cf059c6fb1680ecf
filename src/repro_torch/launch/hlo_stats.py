"""Parse compiled HLO text for roofline inputs —
``src/repro/launch/hlo_stats.py``, copied for the port (it imports
nothing of JAX).

The port produces no HLO: nothing here runs on its own path. The module
is kept for callers that hand it HLO text, and its collective byte
factors (all-reduce 2(g-1)/g, all-gather (g-1)/g of the result,
reduce-scatter (g-1) x the result) are the ones ``launch.dryrun`` applies
to the collectives that DTensor issues.

The reference's description follows.

``compiled.cost_analysis()`` reports FLOPs/bytes for each op counted ONCE —
`while` bodies (every `lax.scan`: layers, microbatches, CE chunks) are not
multiplied by their trip counts, which undercounts scanned models by orders
of magnitude. This module walks the HLO text instead:

  1. split into computations and build the call graph
     (while condition/body, fusion `calls=`, reduce `to_apply=`, ...);
  2. propagate execution multipliers from ENTRY: a while body executes
     `trip` times (recovered from the `constant(N)` bound in its condition),
     a fusion executes once per callsite execution; nesting multiplies;
  3. trip-aware dot FLOPs: every `dot` contributes
     2 x prod(result shape) x prod(contracted dims) x multiplier;
  4. trip-aware collective bytes: result-shape bytes x op factor x
     multiplier (all-reduce ~2x ring traffic, reduce-scatter ~input size).

The dry-run uses (3)/(naive count) as the correction factor for
cost_analysis FLOPs and bytes (dots dominate both, and loop structure is
shared), and (4) directly as the collective roofline term.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s*(?:\()?([a-z0-9]+)\[([\d,]*)\][^ ]*\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\("
)
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_WHILE_RE = re.compile(r"while\(.*?condition=%?([\w\.\-]+), body=%?([\w\.\-]+)")
_CONST_RE = re.compile(r"s32\[\]\s+constant\((\d+)\)")
_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w\.\-]+)\s*=\s*([a-z0-9]+)\[([\d,]*)\]")
_DOT_RE = re.compile(
    r"=\s*([a-z0-9]+)\[([\d,]*)\][^ ]*\s+dot\(%?([\w\.\-]+),\s*%?([\w\.\-]+)\)"
)
_LHS_C_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")
_CALLS_RE = re.compile(r"(?:calls|to_apply|condition|body)=%?([\w\.\-]+)")


def _dims(s: str) -> List[int]:
    return [int(d) for d in s.split(",") if d]


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in _dims(dims):
        n *= d
    return n * _DTYPE_BYTES.get(dtype, 4)


def _split_computations(hlo_text: str) -> Dict[str, List[str]]:
    comp_lines: Dict[str, List[str]] = {}
    cur = "__preamble__"
    for line in hlo_text.splitlines():
        s = line.rstrip()
        if s and not s.startswith(" ") and s.endswith("{"):
            if s.startswith("ENTRY"):
                cur = "ENTRY"
            else:
                m = re.match(r"^%?([\w\.\-]+)", s)
                cur = m.group(1) if m else s.split()[0]
        comp_lines.setdefault(cur, []).append(line)
    return comp_lines


def _multipliers(comp_lines: Dict[str, List[str]]) -> Dict[str, float]:
    """Execution count of each computation, propagated from ENTRY."""
    # edges: caller -> [(callee, per_call_trip)]
    edges: Dict[str, List[Tuple[str, float]]] = {c: [] for c in comp_lines}
    for comp, lines in comp_lines.items():
        for line in lines:
            wm = _WHILE_RE.search(line)
            if wm:
                cond, body = wm.group(1), wm.group(2)
                bound = 1
                for cl in comp_lines.get(cond, []):
                    c = _CONST_RE.search(cl)
                    if c:
                        bound = max(bound, int(c.group(1)))
                edges[comp].append((body, float(bound)))
                edges[comp].append((cond, float(bound)))
                continue
            for callee in _CALLS_RE.findall(line):
                if callee in comp_lines:
                    edges[comp].append((callee, 1.0))

    # propagate from ENTRY (call graph is a DAG; iterate to fixpoint)
    mult: Dict[str, float] = {c: 0.0 for c in comp_lines}
    mult["ENTRY"] = 1.0
    for _ in range(32):
        new = {c: 0.0 for c in comp_lines}
        new["ENTRY"] = 1.0
        for comp, out in edges.items():
            m = mult.get(comp, 0.0)
            if m <= 0:
                continue
            for callee, trip in out:
                new[callee] = new.get(callee, 0.0) + m * trip
        new["ENTRY"] = 1.0
        if new == mult:
            break
        mult = new
    return mult


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, float]
    count_by_op: Dict[str, float]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_op.values())


def collective_bytes(op: str, result_bytes: float, g: int) -> float:
    """Bytes a collective moves per device over a group of `g`, from its
    result's bytes: all-reduce ~2x ring traffic, all-gather the (g-1)/g
    of the result that arrives, reduce-scatter ~the input (g x the
    result) less the own shard; others as they are."""
    if op == "all-reduce":
        return result_bytes * 2.0 * (g - 1) / g
    if op == "all-gather":
        return result_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return result_bytes * (g - 1)
    return result_bytes


def collective_stats(hlo_text: str) -> CollectiveStats:
    comp_lines = _split_computations(hlo_text)
    mult = _multipliers(comp_lines)
    bytes_by: Dict[str, float] = {}
    count_by: Dict[str, float] = {}
    for comp, lines in comp_lines.items():
        m = mult.get(comp, 0.0)
        if m <= 0:
            continue
        for line in lines:
            cm = _COLL_RE.search(line)
            if not cm:
                continue
            dtype, dims, op = cm.group(1), cm.group(2), cm.group(3)
            b = float(_shape_bytes(dtype, dims))
            g = 2
            gm = _GROUPS_RE.search(line)
            if gm:
                g = max(int(gm.group(2)), 2)
            b = collective_bytes(op, b, g)
            bytes_by[op] = bytes_by.get(op, 0.0) + b * m
            count_by[op] = count_by.get(op, 0.0) + m
    return CollectiveStats(bytes_by, count_by)


# ---------------------------------------------------------------------------
# Trip-aware dot FLOPs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlopStats:
    naive_dot_flops: float       # every dot counted once (cost_analysis-like)
    trip_aware_dot_flops: float  # multiplied by execution counts
    trip_aware_dot_bytes: float = 0.0
    # dot operand+result bytes x execution count: a *fused-TPU lower bound*
    # on HBM traffic (elementwise chains fuse into the matmuls on TPU;
    # the unfused CPU HLO's "bytes accessed" is the upper bound)

    @property
    def correction(self) -> float:
        if self.naive_dot_flops <= 0:
            return 1.0
        return max(self.trip_aware_dot_flops / self.naive_dot_flops, 1.0)


def flop_stats(hlo_text: str) -> FlopStats:
    comp_lines = _split_computations(hlo_text)
    mult = _multipliers(comp_lines)
    naive = 0.0
    aware = 0.0
    dot_bytes = 0.0
    for comp, lines in comp_lines.items():
        m = mult.get(comp, 0.0)
        # symbol table: instruction name -> (dims, dtype)
        shapes: Dict[str, List[int]] = {}
        dtypes: Dict[str, str] = {}
        for line in lines:
            dm = _DEF_RE.match(line)
            if dm:
                shapes[dm.group(1)] = _dims(dm.group(3))
                dtypes[dm.group(1)] = dm.group(2)
        for line in lines:
            dot = _DOT_RE.search(line)
            if not dot:
                continue
            out_dims = _dims(dot.group(2))
            lhs = shapes.get(dot.group(3))
            rhs = shapes.get(dot.group(4))
            contract = 1
            lc = _LHS_C_RE.search(line)
            if lhs is not None and lc:
                for d in _dims(lc.group(1)):
                    if d < len(lhs):
                        contract *= lhs[d]
            out = 1
            for d in out_dims:
                out *= d
            f = 2.0 * out * contract
            naive += f
            aware += f * max(m, 0.0)
            b = out * _DTYPE_BYTES.get(dot.group(1), 4)
            for opnd, nm in ((lhs, dot.group(3)), (rhs, dot.group(4))):
                if opnd is not None:
                    nel = 1
                    for d in opnd:
                        nel *= d
                    b += nel * _DTYPE_BYTES.get(dtypes.get(nm, "f32"), 4)
            dot_bytes += b * max(m, 0.0)
    return FlopStats(naive, aware, dot_bytes)
