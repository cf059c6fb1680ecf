"""repro_torch.obs — zero-overhead-when-off observability for the serving stack.

Andes's thesis is that serving systems optimize metrics users don't feel;
observability is how you *watch* the metrics they do feel. This package
threads one `Observer` protocol through every layer — simulator, engine
(including its speculative and hot-path machinery), scheduler, and the
whole cluster (router / admission / autoscaler) — so a single attached
object sees the complete story of a run:

  * request lifecycle — arrival / admit / prefill / first-token / emit /
    preempt / swap-in / finish / shed / defer, with exact virtual-clock
    timestamps;
  * scheduler decisions with their pricing inputs — `QoEPricer` gains,
    victim sets, the multi-step `idle_steps` certificates;
  * fleet events — routing choices with per-replica scores, admission
    verdicts, autoscale up/down/drain/reap (with the attainment signal
    that triggered them);
  * hot-path profiling — host↔device syncs, device dispatches by kind,
    prefill jit compiles, fused multi-step blocks, speculative
    acceptance.

Consumers:

  TraceRecorder     (obs.trace)     structured typed events; JSONL and
                                    Chrome-trace/Perfetto export; QoE
                                    reconciliation (`qoe_from_trace`)
  MetricsObserver   (obs.metrics)   counters/gauges/histograms (TTFT,
                                    TDS, per-tenant QoE, attainment, KV
                                    occupancy) with Prometheus-text and
                                    JSON export + virtual-clock snapshots
  ProfilingObserver (obs.profiling) the engine's sync/compile/dispatch counting
                                    formalized into the same registry the
                                    benchmarks read

Beside the hooks, which are instants on the backend's clock, the engine
and the model write spans and counters into a bounded span log
(`obs.spans.SpanLog`, the engine's `spans`): the step and its schedule,
each prefill call split into staging, cache set-up, the forward's
enqueue (with the cache fill), the slot write and the first-token
readback, the decode blocks, swaps and the clock's sleeps, with the
prefill's rows, padded rows, tokens and padded tokens counted. The
spans carry start and end on the engine's clock (wall mode: monotonic
seconds since the log's epoch), so they explain where a step's time
went; while a `torch.profiler` session records they also open profiler
ranges, anchored so that the log lines up with the device trace.
`register_backend_gauges` exports the counters, and
`TraceRecorder.to_chrome_trace` draws the spans beside the lifecycle
instants (the server's `GET /trace`).

The default observer is None everywhere — instrumentation points guard
with a single `is not None` test, so an unobserved run executes the exact
pre-observability code path. The verification spine is differential
(tests/test_obs.py): an instrumented run is bit-for-bit identical —
tokens, timestamps, preemptions, QoE — to an uninstrumented one, and on
the virtual clock QoE recomputed purely from the emitted trace equals the
engine-reported QoE (on the wall clock the emit of a staged first token
carries the time after its readback: `obs.observer`).

Legacy `event_sink` lifecycle callables remain supported as a thin
`EventSinkAdapter` shim (deprecated; new code should implement Observer).
"""
from repro_torch.obs.observer import (
    EventSinkAdapter,
    MultiObserver,
    Observer,
    ScopedObserver,
    compose,
)
from repro_torch.obs.trace import TraceEvent, TraceRecorder, qoe_from_trace
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsObserver,
    MetricsRegistry,
    parse_prometheus,
    register_backend_gauges,
)
from repro_torch.obs.profiling import ProfilingObserver, profile_engine
from repro_torch.obs.spans import Span, SpanLog

__all__ = [
    "Observer", "MultiObserver", "ScopedObserver", "EventSinkAdapter",
    "compose",
    "TraceEvent", "TraceRecorder", "qoe_from_trace",
    "MetricsRegistry", "MetricsObserver", "Counter", "Gauge", "Histogram",
    "parse_prometheus", "register_backend_gauges",
    "ProfilingObserver", "profile_engine",
    "Span", "SpanLog",
]
