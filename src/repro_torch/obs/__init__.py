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

The default observer is None everywhere — instrumentation points guard
with a single `is not None` test, so an unobserved run executes the exact
pre-observability code path. The verification spine is differential
(tests/test_obs.py): an instrumented run is bit-for-bit identical —
tokens, timestamps, preemptions, QoE — to an uninstrumented one, and QoE
recomputed purely from the emitted trace equals the engine-reported QoE.

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

__all__ = [
    "Observer", "MultiObserver", "ScopedObserver", "EventSinkAdapter",
    "compose",
    "TraceEvent", "TraceRecorder", "qoe_from_trace",
    "MetricsRegistry", "MetricsObserver", "Counter", "Gauge", "Histogram",
    "parse_prometheus", "register_backend_gauges",
    "ProfilingObserver", "profile_engine",
]
