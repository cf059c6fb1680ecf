"""Metrics registry: counters / gauges / histograms with Prometheus-text
and JSON export, virtual-clock snapshots, and a `MetricsObserver` that
derives the Andes QoE metric family from the Observer event stream.

Everything is plain Python and allocation-light: a metric series is a
dict entry keyed by its label values. Gauges may be *bound* to a callable
(`set_fn`) so exports read live state — e.g. KV slot occupancy straight
off `engine.kv` — without per-step bookkeeping; bindings survive
`engine.reset()` because `KVSlotManager.reset()` clears in place.

Export / ingest:

  to_prometheus()     Prometheus text exposition (HELP/TYPE, labels,
                      histogram _bucket/_sum/_count with cumulative
                      counts and a +Inf bucket)
  parse_prometheus()  inverse of the above (for round-trip testing and
                      scraping our own output); label values must not
                      contain '",' or newlines
  to_json/from_json   lossless structural round-trip
  snapshot(t)         append a timestamped sample set (driven by the
                      virtual clock via MetricsObserver.snapshot_every)
"""
from __future__ import annotations

import json
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.pricing import request_weight, slo_attained
from repro_torch.core.qoe import tds_actual, ttft_actual
from repro_torch.obs.observer import Observer

_INF = float("inf")


def _fmt(v: float) -> str:
    """Exact float formatting (repr round-trips doubles)."""
    if v == _INF:
        return "+Inf"
    if v == -_INF:
        return "-Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return repr(v)
    return repr(float(v))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series: Dict[Tuple, object] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple:
        # fast paths: unlabeled metrics dominate the hot emit/sync/dispatch
        # stream, and the reference's overhead gate (benchmarks/engine_hotpath.py)
        # budgets the whole observer stack at ~2% of engine wall clock —
        # so no set() construction on the labeled path either
        if not labels and not self.labelnames:
            return ()
        try:
            key = tuple(str(labels[n]) for n in self.labelnames)
        except KeyError:
            key = None
        if key is None or len(labels) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labels)}")
        return key

    def _labels_dict(self, key: Tuple) -> Dict[str, str]:
        return dict(zip(self.labelnames, key))


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        cur = self._series.get(key, 0.0)
        if callable(cur):
            raise TypeError(f"{self.name}: cannot inc a bound counter")
        self._series[key] = cur + amount

    def set_fn(self, fn: Callable[[], float], **labels) -> None:
        """Bind this series to a callable read at export/snapshot time.

        Hot observers (MetricsObserver, ProfilingObserver) count in plain
        instance attributes and bind the counter to a reader, so the
        per-event cost is one `+=` instead of a metric lookup — the same
        pattern Gauge.set_fn uses for live state."""
        self._series[self._key(labels)] = fn

    def value(self, **labels) -> float:
        v = self._series.get(self._key(labels), 0.0)
        return float(v()) if callable(v) else float(v)

    def samples(self):
        for key, v in self._series.items():
            yield self.name, self._labels_dict(key), \
                float(v()) if callable(v) else float(v)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[self._key(labels)] = float(value)

    def set_fn(self, fn: Callable[[], float], **labels) -> None:
        """Bind this series to a callable read at export/snapshot time."""
        self._series[self._key(labels)] = fn

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        cur = self._series.get(key, 0.0)
        if callable(cur):
            raise TypeError(f"{self.name}: cannot inc a bound gauge")
        self._series[key] = cur + amount

    def value(self, **labels) -> float:
        v = self._series.get(self._key(labels), 0.0)
        return float(v()) if callable(v) else float(v)

    def samples(self):
        for key, v in self._series.items():
            yield self.name, self._labels_dict(key), \
                float(v()) if callable(v) else float(v)


class Histogram(_Metric):
    kind = "histogram"
    DEFAULT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                       50.0, 100.0)

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(buckets if buckets is not None
                          else self.DEFAULT_BUCKETS))
        if not bs or bs[-1] != _INF:
            bs = bs + (_INF,)
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        st = self._series.get(key)
        if st is None:
            st = self._series[key] = {"counts": [0] * len(self.buckets),
                                      "sum": 0.0, "count": 0}
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                st["counts"][i] += 1
                break
        st["sum"] += value
        st["count"] += 1

    def count(self, **labels) -> int:
        st = self._series.get(self._key(labels))
        return int(st["count"]) if st else 0

    def sum(self, **labels) -> float:
        st = self._series.get(self._key(labels))
        return float(st["sum"]) if st else 0.0

    def samples(self):
        for key, st in self._series.items():
            labels = self._labels_dict(key)
            cum = 0
            for ub, c in zip(self.buckets, st["counts"]):
                cum += c
                yield (self.name + "_bucket",
                       {**labels, "le": _fmt(float(ub))}, float(cum))
            yield self.name + "_sum", labels, float(st["sum"])
            yield self.name + "_count", labels, float(st["count"])


class MetricsRegistry:
    """Ordered get-or-create registry of named metrics."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self.snapshots: List[Dict] = []

    # ------------------------------------------------------------- creation
    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Metric:
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(f"{name} already registered as {m.kind}")
            return m
        m = cls(name, help, labelnames, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    # --------------------------------------------------------------- access
    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def value(self, name: str, **labels) -> float:
        """Current value of a counter/gauge series (0.0 if unset)."""
        m = self._metrics[name]
        return m.value(**labels)

    def samples(self):
        """Yield (sample_name, labels_dict, value) over every series,
        expanding histograms into _bucket/_sum/_count."""
        for m in self._metrics.values():
            yield from m.samples()

    # -------------------------------------------------------------- exports
    def to_prometheus(self) -> str:
        lines: List[str] = []
        for m in self._metrics.values():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for name, labels, value in m.samples():
                if labels:
                    lab = ",".join(f'{k}="{v}"'
                                   for k, v in sorted(labels.items()))
                    lines.append(f"{name}{{{lab}}} {_fmt(value)}")
                else:
                    lines.append(f"{name} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> Dict:
        metrics = []
        for m in self._metrics.values():
            entry = {"name": m.name, "kind": m.kind, "help": m.help,
                     "labelnames": list(m.labelnames)}
            if isinstance(m, Histogram):
                entry["buckets"] = [b for b in m.buckets if b != _INF]
                entry["series"] = [
                    {"labels": m._labels_dict(k),
                     "counts": list(st["counts"]), "sum": st["sum"],
                     "count": st["count"]}
                    for k, st in m._series.items()]
            else:
                entry["series"] = [
                    {"labels": m._labels_dict(k),
                     "value": float(v()) if callable(v) else float(v)}
                    for k, v in m._series.items()]
            metrics.append(entry)
        return {"metrics": metrics, "snapshots": self.snapshots}

    @staticmethod
    def from_json(d: Dict) -> "MetricsRegistry":
        reg = MetricsRegistry()
        for e in d.get("metrics", []):
            names = e.get("labelnames", [])
            if e["kind"] == "counter":
                m = reg.counter(e["name"], e.get("help", ""), names)
                for s in e["series"]:
                    m.inc(s["value"], **s["labels"])
            elif e["kind"] == "gauge":
                m = reg.gauge(e["name"], e.get("help", ""), names)
                for s in e["series"]:
                    m.set(s["value"], **s["labels"])
            elif e["kind"] == "histogram":
                m = reg.histogram(e["name"], e.get("help", ""), names,
                                  buckets=e.get("buckets"))
                for s in e["series"]:
                    key = m._key(s["labels"])
                    m._series[key] = {"counts": list(s["counts"]),
                                      "sum": s["sum"],
                                      "count": s["count"]}
        reg.snapshots = list(d.get("snapshots", []))
        return reg

    def snapshot(self, t: float) -> Dict:
        """Record a timestamped sample set (virtual-clock periodic
        snapshots; bound gauges are resolved now)."""
        snap = {"t": float(t),
                "samples": [[name, labels, value]
                            for name, labels, value in self.samples()]}
        self.snapshots.append(snap)
        return snap


_LINE_RE = re.compile(r'^([A-Za-z_:][A-Za-z0-9_:]*)'
                      r'(?:\{(.*)\})?\s+(\S+)$')


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return _INF
    if s == "-Inf":
        return -_INF
    return float(s)


def parse_prometheus(text: str) -> Dict[Tuple[str, Tuple], float]:
    """Parse Prometheus text exposition into
    {(sample_name, ((label, value), ...)): value}. Handles exactly the
    dialect `to_prometheus` emits (label values without '",' /
    newlines)."""
    out: Dict[Tuple[str, Tuple], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable metric line: {line!r}")
        name, labelstr, value = m.groups()
        labels: List[Tuple[str, str]] = []
        if labelstr:
            for part in labelstr.split('",'):
                k, _, v = part.partition('=')
                labels.append((k.strip(), v.strip('"')))
        out[(name, tuple(sorted(labels)))] = _parse_value(value)
    return out


def registry_samples_dict(reg: MetricsRegistry) -> Dict[Tuple[str, Tuple], float]:
    """Same keying as parse_prometheus, for round-trip comparison."""
    return {(name, tuple(sorted((k, str(v)) for k, v in labels.items()))):
            float(value)
            for name, labels, value in reg.samples()}


# ---------------------------------------------------------------------------
# Observer -> registry bridge
# ---------------------------------------------------------------------------

class MetricsObserver(Observer):
    """Derive the QoE metric family from the event stream.

    Counters for every lifecycle/fleet event, histograms for TTFT / TDS /
    per-tenant QoE on finish, and a running contract-weighted attainment
    gauge (same `slo_attained` the autoscaler uses). When
    `snapshot_every` is set, takes periodic registry snapshots on the
    *virtual* clock — event timestamps, not wall time.

    The unlabeled lifecycle counters are *bound* to this observer's
    internal tallies (Counter.set_fn), so attach at most one
    MetricsObserver per registry — a second would rebind the series."""

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 qoe_floor: float = 0.9,
                 snapshot_every: Optional[float] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.qoe_floor = qoe_floor
        self.snapshot_every = snapshot_every
        self._next_snap = snapshot_every
        r = self.registry
        # unlabeled lifecycle counters fire per event (emit is per TOKEN);
        # count in plain attributes and bind the registry series to readers
        # so the hot path pays one `+=` (the benchmark's ~2% overhead gate)
        self._submitted_n = 0
        self._admitted_n = 0
        self._finished_n = 0
        self._shed_n = 0
        self._deferred_n = 0
        self._tokens_n = 0
        self._prefill_n = 0
        self._chunks_n = 0
        self._swapins_n = 0
        self._cancelled_n = 0
        self._sse_events_n = 0
        self._sse_bytes_n = 0
        r.counter("requests_submitted_total",
                  "requests that entered the system"
                  ).set_fn(lambda: float(self._submitted_n))
        r.counter("requests_admitted_total",
                  "requests admitted to a live set"
                  ).set_fn(lambda: float(self._admitted_n))
        r.counter("requests_finished_total", "requests fully served"
                  ).set_fn(lambda: float(self._finished_n))
        r.counter("requests_shed_total",
                  "requests rejected by admission control"
                  ).set_fn(lambda: float(self._shed_n))
        r.counter("requests_deferred_total",
                  "admission deferrals (re-queues)"
                  ).set_fn(lambda: float(self._deferred_n))
        r.counter("tokens_emitted_total", "tokens delivered to clients"
                  ).set_fn(lambda: float(self._tokens_n))
        r.counter("prefill_tokens_total",
                  "prompt tokens prefetched/prefilled"
                  ).set_fn(lambda: float(self._prefill_n))
        r.counter("prefill_chunks_total",
                  "chunked-prefill chunks committed"
                  ).set_fn(lambda: float(self._chunks_n))
        r.counter("swap_ins_total", "swapped requests restored to device"
                  ).set_fn(lambda: float(self._swapins_n))
        r.counter("requests_cancelled_total",
                  "requests aborted by clients (disconnect / cancel)"
                  ).set_fn(lambda: float(self._cancelled_n))
        r.counter("sse_events_flushed_total",
                  "server-sent events written to client sockets"
                  ).set_fn(lambda: float(self._sse_events_n))
        r.counter("sse_bytes_flushed_total",
                  "SSE bytes written to client sockets"
                  ).set_fn(lambda: float(self._sse_bytes_n))
        self._conns = r.counter(
            "connection_events_total", "server connection lifecycle events",
            ("event",))
        self._drains = r.counter(
            "drain_events_total", "graceful-shutdown drain phases",
            ("phase",))
        self._preempts = r.counter(
            "preemptions_total", "batch evictions by mode", ("mode",))
        self._sched = r.counter(
            "schedule_decisions_total", "scheduler invocations",
            ("policy", "triggered"))
        self._routes = r.counter(
            "route_decisions_total", "fleet routing choices", ("replica",))
        self._admission = r.counter(
            "admission_decisions_total", "admission verdicts", ("action",))
        self._scales = r.counter(
            "autoscale_events_total", "autoscaler actions", ("action",))
        self._ttft = r.histogram(
            "ttft_seconds", "time to first token",
            buckets=(0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))
        self._tds = r.histogram(
            "tds_tokens_per_second", "observed token delivery speed",
            buckets=(0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0))
        self._qoe = r.histogram(
            "request_qoe", "final per-request QoE (Eq. 1)", ("tenant",),
            buckets=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95,
                     0.99, 1.0))
        self._attain = r.gauge(
            "weighted_attainment",
            "running contract-weighted SLO attainment over finished requests")
        # clock/live update on EVERY event; keep them as plain attributes
        # read through bound gauges so the hot path pays an attribute
        # compare, not a gauge lookup (the benchmark's ~2% overhead gate)
        self._clock_t = 0.0
        self._live_n = 0
        self._clock = r.gauge("clock_seconds", "virtual clock high-water mark")
        self._clock.set_fn(lambda: self._clock_t)
        self._live = r.gauge("live_requests", "admitted, unfinished requests")
        self._live.set_fn(lambda: float(self._live_n))
        self._w_sum = 0.0
        self._wa_sum = 0.0

    # ------------------------------------------------------------- plumbing
    def _tick(self, t: float) -> None:
        if t > self._clock_t:
            self._clock_t = t
        ns = self._next_snap
        if ns is not None and t >= ns:
            self.registry.snapshot(t)
            period = self.snapshot_every
            self._next_snap = (t // period + 1) * period

    # ------------------------------------------------------------ lifecycle
    def submit(self, req, t, *, replica=-1):
        self._submitted_n += 1
        self._tick(t)

    def admit(self, req, t, *, replica=-1):
        self._admitted_n += 1
        self._live_n += 1
        self._tick(t)

    def prefill(self, req, t, n_tokens, *, replica=-1):
        self._prefill_n += n_tokens
        self._tick(t)

    def prefill_chunk(self, req, t, cursor, total, *, replica=-1):
        self._chunks_n += 1
        self._tick(t)

    def emit(self, req, t, k=1, *, replica=-1):
        # hottest hook (per token): _tick inlined
        self._tokens_n += k
        if t > self._clock_t:
            self._clock_t = t
        if self._next_snap is not None and t >= self._next_snap:
            self.registry.snapshot(t)
            period = self.snapshot_every
            self._next_snap = (t // period + 1) * period

    def preempt(self, req, t, mode="swap", *, replica=-1):
        self._preempts.inc(mode=mode)
        self._tick(t)

    def swap_in(self, req, t, *, replica=-1):
        self._swapins_n += 1
        self._tick(t)

    def finish(self, req, t, *, replica=-1):
        self._finished_n += 1
        self._live_n -= 1
        ttft = req.final_ttft()
        if ttft != _INF:
            self._ttft.observe(ttft)
        tds = req.final_tds()
        if tds != _INF:
            self._tds.observe(tds)
        self._qoe.observe(req.final_qoe(), tenant=req.tenant or "default")
        w = request_weight(req)
        self._w_sum += w
        self._wa_sum += w * slo_attained(req, self.qoe_floor)
        self._attain.set(self._wa_sum / self._w_sum)
        self._tick(t)

    def shed(self, req, t, *, replica=-1):
        self._shed_n += 1
        self._tick(t)

    def defer(self, req, t, *, replica=-1):
        self._deferred_n += 1
        self._tick(t)

    def cancel(self, req, t, *, replica=-1):
        self._cancelled_n += 1
        self._live_n -= 1 if req.fluid_idx >= 0 else 0  # admitted only
        self._tick(t)

    # ------------------------------------------------------------ scheduler
    def schedule(self, t, info, *, replica=-1):
        self._sched.inc(policy=str(info.get("policy", "?")),
                        triggered=str(bool(info.get("triggered", False))))
        self._tick(t)

    # ---------------------------------------------------------------- fleet
    def route(self, req, t, replica_id, gain, scores, *, replica=-1):
        self._routes.inc(replica=str(replica_id))
        self._tick(t)

    def admission(self, req, t, action, gain, *, replica=-1):
        self._admission.inc(action=str(action))
        self._tick(t)

    def scale(self, t, action, replica_id, signal=None, *, replica=-1):
        self._scales.inc(action=str(action))
        self._tick(t)

    # --------------------------------------------------------- wire / server
    def connection(self, t, conn_id, event, info=None, *, replica=-1):
        self._conns.inc(event=str(event))
        self._tick(t)

    def sse_flush(self, t, conn_id, rid, n_events, n_bytes, *, replica=-1):
        self._sse_events_n += n_events
        self._sse_bytes_n += n_bytes
        self._tick(t)

    def drain(self, t, phase, conns, live, *, replica=-1):
        self._drains.inc(phase=str(phase))
        self._tick(t)


#: the engine's span-log counters (``obs.spans``) and the gauges that
#: export them: (counter, gauge, help)
SPAN_COUNTER_GAUGES = (
    ("prefill.calls", "engine_prefill_calls_total",
     "prefill calls: one per bucket group or eager call"),
    ("prefill.rows", "engine_prefill_rows_total", "real rows prefilled"),
    ("prefill.row_slots", "engine_prefill_row_slots_total",
     "rows prefilled, row-bucket padding included"),
    ("prefill.tokens", "engine_prefill_tokens_total",
     "valid tokens prefilled"),
    ("prefill.token_slots", "engine_prefill_token_slots_total",
     "token slots prefilled: rows x length bucket"),
)


def register_backend_gauges(registry: MetricsRegistry, backend,
                            replica: Optional[int] = None) -> None:
    """Bind live-state gauges onto a backend.

    KV occupancy (current / peak tokens, utilization, slots in use) comes
    straight off `backend.kv` (the manager's peak tracking, readable from
    outside); clock and live-set size work for any SteppableBackend.
    Bound gauges survive `backend.reset()` because `KVSlotManager.reset()`
    clears the same object in place. A backend with a span log
    (``backend.spans``, the engine's) also exports its prefill counters
    (SPAN_COUNTER_GAUGES), totals since its last reset."""
    labels = {} if replica is None else {"replica": str(replica)}
    names = () if replica is None else ("replica",)

    def bind(name, help, fn):
        registry.gauge(name, help, names).set_fn(fn, **labels)

    if getattr(backend, "spans", None) is not None:
        for counter, gauge, help in SPAN_COUNTER_GAUGES:
            bind(gauge, help,
                 lambda c=counter: backend.spans.counters.get(c, 0))

    bind("backend_clock_seconds", "backend virtual clock",
         lambda: backend.now)
    bind("backend_live_requests", "live (admitted, unfinished) requests",
         lambda: len(backend.live))
    kv = getattr(backend, "kv", None)
    if kv is not None:
        bind("kv_tokens_used", "KV cache tokens currently resident",
             lambda: backend.kv.tokens_used)
        bind("kv_tokens_peak", "peak KV cache tokens resident",
             lambda: backend.kv.peak_tokens_used)
        bind("kv_utilization", "KV token occupancy / capacity",
             lambda: backend.kv.utilization)
        bind("kv_peak_utilization", "peak KV occupancy / capacity",
             lambda: backend.kv.peak_utilization)
        bind("kv_slots_in_use", "engine slots holding a request",
             lambda: backend.kv.slots_in_use)
        bind("kv_swap_bytes_total", "bytes moved by KV swap in/out",
             lambda: backend.kv.swap_bytes_total)
        bind("kv_swaps_out_total", "requests parked to host by swap_out",
             lambda: getattr(backend.kv, "swaps_out_total", 0))
        bind("kv_drops_total", "KV slices discarded by drop()",
             lambda: getattr(backend.kv, "drops_total", 0))
        bind("kv_dropped_bytes_total",
             "parked host/draft bytes discarded by drop()",
             lambda: getattr(backend.kv, "dropped_bytes_total", 0))
        if getattr(kv, "paged", False):
            bind("kv_pages_used", "KV pages currently allocated",
                 lambda: backend.kv.pages_used)
            bind("kv_pages_peak", "peak KV pages allocated",
                 lambda: backend.kv.peak_pages_used)
            bind("kv_pages_total", "KV page-pool capacity",
                 lambda: backend.kv.total_pages)
            bind("kv_page_utilization", "KV page occupancy / page pool",
                 lambda: backend.kv.page_utilization)
            bind("kv_physical_pages_used",
                 "device page-pool rows holding data (overdraft clamped)",
                 lambda: backend.kv.physical_pages_used)
            bind("kv_physical_page_utilization",
                 "physical page occupancy / pool (never exceeds 1.0)",
                 lambda: backend.kv.physical_page_utilization)
            bind("kv_overdraft_pages",
                 "ledger pages past the physical pool (fictional ids)",
                 lambda: getattr(backend.kv, "overdraft_pages", 0))
        if getattr(backend, "physical_pages", False):
            bind("kv_page_gathers_total",
                 "pool->contiguous row gathers (swap-out reads)",
                 lambda: backend.page_gathers)
            bind("kv_page_scatters_total",
                 "contiguous->pool scatter commits (prefill/swap-in)",
                 lambda: backend.page_scatters)
            bind("kv_page_gather_bytes_total",
                 "bytes moved by page-pool gathers",
                 lambda: backend.page_gather_bytes)
