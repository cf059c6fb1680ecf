"""Structured trace recording: typed events, JSONL and Perfetto export,
and QoE reconciliation straight from the trace.

The recorder is itself an `Observer` — attach it to any backend (or to a
ClusterSimulator, where `ScopedObserver` stamps replica ids) and it
accumulates `TraceEvent`s carrying everything needed to replay the run's
quality story offline:

  * the "arrival" event snapshots the request's QoE contract (ttft, tds,
    prompt/output lengths, tenant, priority, SLO weight), so a trace file
    is self-contained;
  * "emit" events carry the exact virtual-clock floats the engine
    appended to `Request.emit_times` — which is why `qoe_from_trace`
    reconciles *bit-for-bit* with `Request.final_qoe()`: both push the
    same floats through the same `qoe_exact`;
  * a synthetic "first_token" event precedes each request's first emit
    (TTFT is first-class in Andes, so it is first-class in the trace);
  * scheduler / route / admission / scale events carry their decision
    payloads (gains, victim sets, scores, autoscale signals).

Export formats:

  to_jsonl / from_jsonl       lossless round-trip (floats via repr)
  to_chrome_trace             Chrome trace-event JSON loadable in
                              Perfetto / chrome://tracing: one process
                              per replica (pid 0 = fleet), one thread per
                              request, an "X" span from arrival to
                              finish/shed, instants for everything else;
                              given the engines' span logs
                              (``obs.spans``), their spans as "X" events
                              on a host thread of each replica's process
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Mapping, Optional, Union

import numpy as np

from repro_torch.core.pricing import request_weight
from repro_torch.core.qoe import QoESpec, qoe_exact
from repro_torch.obs.observer import Observer
from repro_torch.obs.spans import SpanLog

#: the thread id of the span logs' host thread in a Chrome trace (rids
#: take the others; the harnesses' warm-up rids are small negatives)
HOST_TID = -(2 ** 31)


@dataclasses.dataclass(slots=True)
class TraceEvent:
    """One typed event. `rid` is None for request-less events (schedule,
    scale, sync, ...); `replica` is -1 outside a cluster. `data` is a
    JSON-able payload whose keys depend on `kind`.

    `slots=True`: a trace of a few-minute run holds 10^5-10^6 of these;
    slots halve the per-event footprint and keep allocation (and GC
    pressure on the engine hot path) inside the benchmark's overhead
    budget."""
    kind: str
    t: float
    rid: Optional[int]
    replica: int
    data: Dict

    def to_json(self) -> str:
        return json.dumps(
            {"kind": self.kind, "t": self.t, "rid": self.rid,
             "replica": self.replica, "data": self.data},
            default=_jsonable, sort_keys=True)

    @staticmethod
    def from_json(line: str) -> "TraceEvent":
        d = json.loads(line)
        return TraceEvent(d["kind"], d["t"], d["rid"], d["replica"],
                          d["data"])


def _jsonable(x):
    """json.dumps default= hook: numpy scalars/arrays -> python."""
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    raise TypeError(f"not JSON-serializable: {type(x)!r}")


class TraceRecorder(Observer):
    """Accumulate TraceEvents from any instrumented backend."""

    #: hot-path event kinds excluded when `lifecycle_only=True` (they
    #: dominate event counts without changing the QoE story)
    HOTPATH_KINDS = frozenset({"sync", "dispatch"})

    def __init__(self, lifecycle_only: bool = False):
        self.lifecycle_only = lifecycle_only
        self.events: List[TraceEvent] = []
        self._tokens_seen: Dict[int, int] = {}

    def clear(self) -> None:
        self.events.clear()
        self._tokens_seen.clear()

    # ------------------------------------------------------------- internals
    def _rec(self, kind, t, rid, replica, **data) -> None:
        self.events.append(TraceEvent(kind, float(t), rid, replica, data))

    # ------------------------------------------------------------- lifecycle
    def submit(self, req, t, *, replica=-1):
        # A cluster emits a fleet-level arrival and the chosen replica
        # backend emits its own on hand-off; keep only the first per rid
        # so qoe reconciliation sees the true arrival.
        if req.rid in self._tokens_seen:
            return
        self._tokens_seen[req.rid] = 0
        self._rec("arrival", t, req.rid, replica,
                  prompt_len=int(req.prompt_len),
                  output_len=int(req.output_len),
                  ttft=float(req.spec.ttft), tds=float(req.spec.tds),
                  tenant=req.tenant, priority=float(req.priority),
                  weight=float(request_weight(req)))

    def admit(self, req, t, *, replica=-1):
        self._rec("admit", t, req.rid, replica)

    def prefill(self, req, t, n_tokens, *, replica=-1):
        self._rec("prefill", t, req.rid, replica, n_tokens=int(n_tokens))

    def prefill_chunk(self, req, t, cursor, total, *, replica=-1):
        self._rec("prefill_chunk", t, req.rid, replica,
                  cursor=int(cursor), total=int(total))

    def emit(self, req, t, k=1, *, replica=-1):
        # hottest hook (per token): TraceEvent built inline, no _rec hop
        rid = req.rid
        seen = self._tokens_seen.get(rid, 0)
        if seen == 0:
            self.events.append(
                TraceEvent("first_token", float(t), rid, replica, {}))
        total = seen + int(k)
        self._tokens_seen[rid] = total
        self.events.append(
            TraceEvent("emit", float(t), rid, replica,
                       {"k": int(k), "total": total}))

    def preempt(self, req, t, mode="swap", *, replica=-1):
        self._rec("preempt", t, req.rid, replica, mode=mode,
                  generated=int(req.generated))

    def swap_in(self, req, t, *, replica=-1):
        self._rec("swap_in", t, req.rid, replica,
                  context_len=int(req.context_len))

    def finish(self, req, t, *, replica=-1):
        self._rec("finish", t, req.rid, replica,
                  generated=int(req.generated),
                  preemptions=int(req.preemptions))

    def shed(self, req, t, *, replica=-1):
        self._rec("shed", t, req.rid, replica)

    def defer(self, req, t, *, replica=-1):
        self._rec("defer", t, req.rid, replica)

    def cancel(self, req, t, *, replica=-1):
        self._rec("cancel", t, req.rid, replica,
                  generated=int(req.generated))

    # ------------------------------------------------------------- scheduler
    def schedule(self, t, info, *, replica=-1):
        self._rec("schedule", t, None, replica, **info)

    def multi_step(self, t, j, committed, *, replica=-1):
        self._rec("multi_step", t, None, replica, j=int(j),
                  committed=int(committed))

    # ----------------------------------------------------------------- fleet
    def route(self, req, t, replica_id, gain, scores, *, replica=-1):
        self._rec("route", t, req.rid, replica,
                  replica_id=int(replica_id),
                  gain=None if gain is None else float(gain),
                  scores=None if scores is None else
                  {str(k): float(v) for k, v in scores.items()})

    def admission(self, req, t, action, gain, *, replica=-1):
        self._rec("admission", t, req.rid, replica, action=action,
                  gain=None if gain is None else float(gain))

    def scale(self, t, action, replica_id, signal=None, *, replica=-1):
        self._rec("scale", t, None, replica, action=action,
                  replica_id=int(replica_id), signal=signal)

    # -------------------------------------------------------------- hot path
    def sync(self, t, n=1, *, replica=-1):
        if not self.lifecycle_only:
            self.events.append(
                TraceEvent("sync", float(t), None, replica, {"n": int(n)}))

    def dispatch(self, t, kind, n=1, *, replica=-1):
        if not self.lifecycle_only:
            self.events.append(
                TraceEvent("dispatch", float(t), None, replica,
                           {"op": kind, "n": int(n)}))

    def jit_compile(self, t, key, *, replica=-1):
        self._rec("jit_compile", t, None, replica, key=list(key))

    def spec(self, t, proposed, accepted, *, replica=-1):
        self._rec("spec", t, None, replica, proposed=int(proposed),
                  accepted=int(accepted))

    # --------------------------------------------------------- wire / server
    def connection(self, t, conn_id, event, info=None, *, replica=-1):
        self._rec("connection", t, None, replica, conn_id=int(conn_id),
                  event=event, info=info)

    def sse_flush(self, t, conn_id, rid, n_events, n_bytes, *, replica=-1):
        self._rec("sse_flush", t, rid, replica, conn_id=int(conn_id),
                  n_events=int(n_events), n_bytes=int(n_bytes))

    def drain(self, t, phase, conns, live, *, replica=-1):
        self._rec("drain", t, None, replica, phase=phase,
                  conns=int(conns), live=int(live))

    # --------------------------------------------------------------- exports
    def to_jsonl(self) -> str:
        return "\n".join(ev.to_json() for ev in self.events) + "\n" \
            if self.events else ""

    def save_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    @staticmethod
    def from_jsonl(text: str) -> List[TraceEvent]:
        return [TraceEvent.from_json(line)
                for line in text.splitlines() if line.strip()]

    @staticmethod
    def load_jsonl(path: str) -> List[TraceEvent]:
        with open(path) as f:
            return TraceRecorder.from_jsonl(f.read())

    def to_chrome_trace(
            self, span_logs: Union[SpanLog, Mapping[int, SpanLog],
                                   None] = None) -> Dict:
        """Chrome trace-event format (Perfetto / chrome://tracing).

        pid = replica + 1 (pid 0 is the fleet control plane), tid = rid
        (tid 0 for request-less events). Each request gets one "X"
        complete span from arrival to finish/shed; every event is also an
        "i" instant. Events are sorted by timestamp, so per-(pid, tid)
        timestamps are monotone. `span_logs` (one engine's log, or a
        replica -> log mapping; a lone log is the single node's, replica
        -1) adds each log's spans as "X" events, cat "span", on thread
        HOST_TID of the replica's process: the log's clock is the one the
        engine stamps its events with."""
        instants, spans = [], []
        arrivals: Dict[int, TraceEvent] = {}
        pids, tids = set(), set()
        for ev in sorted(self.events, key=lambda e: e.t):
            pid = ev.replica + 1
            tid = ev.rid if ev.rid is not None else 0
            pids.add(pid)
            tids.add((pid, tid))
            instants.append({
                "name": ev.kind, "ph": "i", "s": "t",
                "ts": ev.t * 1e6, "pid": pid, "tid": tid,
                "args": json.loads(json.dumps(ev.data, default=_jsonable)),
            })
            if ev.kind == "arrival":
                arrivals[ev.rid] = ev
            elif ev.kind in ("finish", "shed") and ev.rid in arrivals:
                start = arrivals.pop(ev.rid)
                spans.append({
                    "name": f"req {ev.rid}", "ph": "X", "cat": "request",
                    "ts": start.t * 1e6, "dur": (ev.t - start.t) * 1e6,
                    "pid": pid, "tid": tid,
                    "args": {"outcome": ev.kind, **start.data},
                })
        if isinstance(span_logs, SpanLog):
            span_logs = {-1: span_logs}
        for replica, log in sorted((span_logs or {}).items()):
            pid = replica + 1
            pids.add(pid)
            tids.add((pid, HOST_TID))
            for sp in sorted(log.spans(), key=lambda x: (x.start, x.seq)):
                spans.append({
                    "name": sp.name, "ph": "X", "cat": "span",
                    "ts": sp.start * 1e6, "dur": (sp.end - sp.start) * 1e6,
                    "pid": pid, "tid": HOST_TID,
                    "args": {"seq": sp.seq, "parent": sp.parent,
                             **json.loads(json.dumps(sp.payload or {},
                                                     default=_jsonable))},
                })
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "ts": 0,
                 "args": {"name": "fleet" if pid == 0
                          else f"replica {pid - 1}"}}
                for pid in sorted(pids)]
        meta += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                  "ts": 0, "args": {"name": "control" if tid == 0
                                    else "host" if tid == HOST_TID
                                    else f"req {tid}"}}
                 for pid, tid in sorted(tids)]
        return {"traceEvents": meta + spans + instants,
                "displayTimeUnit": "ms"}

    def save_chrome_trace(self, path: str, span_logs=None) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(span_logs), f)


def qoe_from_trace(events: List[TraceEvent]) -> Dict[int, float]:
    """Recompute per-request QoE purely from a trace.

    Uses only "arrival" (contract snapshot) and "emit" (delivery
    timestamps) events, pushed through the same `qoe_exact` as
    `Request.final_qoe()`. On the virtual clock emit events carry the
    identical floats the backend appended to `emit_times`, so the result
    matches the backend-reported QoE exactly — the trace-reconciliation
    oracle. On a wall engine's clock the emit event of a staged first
    token carries the time the host held the token, after its readback,
    which is later than its `emit_times` entry (the staging tick): the
    result is then the QoE of delivery as the host saw it, and may read
    below `final_qoe()`.

    Robust to event *file order*: wall-clock runs interleave replicas and
    server connections, so a merged trace may deliver a request's events
    out of order (and a fleet hand-off records two "arrival" events whose
    order depends on the writer). The reconstruction is therefore
    permutation-invariant — the earliest-timestamp arrival wins and each
    request's emit timeline is sorted before pacing — because
    `pace_delivery` is order-sensitive: feeding it an unsorted timeline
    silently computes a different (wrong) delivery curve."""
    specs: Dict[int, tuple] = {}
    emits: Dict[int, List[float]] = {}
    for ev in events:
        if ev.kind == "arrival":
            if ev.rid not in specs or ev.t < specs[ev.rid][0]:
                specs[ev.rid] = (ev.t, QoESpec(ttft=ev.data["ttft"],
                                               tds=ev.data["tds"]))
        elif ev.kind == "emit":
            emits.setdefault(ev.rid, []).extend(
                [ev.t] * int(ev.data["k"]))
    out: Dict[int, float] = {}
    for rid, (arrival, spec) in specs.items():
        times = emits.get(rid, [])
        if not times:
            out[rid] = 0.0          # shed / never served
        else:
            times = np.sort(np.asarray(times, np.float64))
            out[rid] = float(qoe_exact(times, arrival, spec,
                                       response_len=len(times)))
    return out
