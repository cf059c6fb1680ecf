"""Hot-path profiling: the engine's sync / dispatch / compile counting as a
reusable Observer feeding a MetricsRegistry.

The engine instruments its hot path by hand — `host_syncs`,
`multi_step_blocks`, the `BucketedPrefill.shapes_seen` compile cache —
and the benchmark read those private counters directly. This module
formalizes the same signals as Observer events (`sync`, `dispatch`,
`jit_compile`, `multi_step`, `spec`), so any consumer (benchmarks,
dashboards, tests) reads them from the registry instead of reaching into
engine internals. The engine still keeps its cheap integer counters
(`host_syncs`, `dispatches`, ...) for `hotpath_stats()`; with a
ProfilingObserver attached the two must agree — the benchmark asserts it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.observer import Observer


class ProfilingObserver(Observer):
    """Map hot-path events onto registry counters.

    Counters (all under the `engine_` prefix; labels in brackets):
      engine_host_syncs_total          host<->device synchronizations
      engine_dispatches_total[kind]    device computation dispatches
      engine_jit_compiles_total        new jit shape signatures
      engine_multi_step_blocks_total   fused decode blocks executed
      engine_multi_step_iters_total    iterations covered by those blocks
      engine_persistent_blocks_total   of which: device while_loop blocks
      engine_persistent_iters_total    device loop iterations executed
      engine_spec_proposed_total       speculative tokens drafted
      engine_spec_accepted_total       speculative tokens accepted

    Series are *bound* to this observer's internal tallies
    (Counter.set_fn), so attach at most one ProfilingObserver per
    registry — a second would rebind them.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        # these hooks fire on EVERY device interaction, so the counts live
        # in plain attributes and the registry series are bound readers
        # (Counter.set_fn) — one `+=` per event, no metric lookup
        self._syncs_n = 0
        self._compiles_n = 0
        self._mblocks_n = 0
        self._miters_n = 0
        self._pblocks_n = 0
        self._piters_n = 0
        self._spec_p_n = 0
        self._spec_a_n = 0
        self._disp_n: Dict[str, int] = {}
        r.counter("engine_host_syncs_total",
                  "host-device synchronizations"
                  ).set_fn(lambda: float(self._syncs_n))
        self._dispatches = r.counter(
            "engine_dispatches_total", "device dispatches by kind",
            ("kind",))
        r.counter("engine_jit_compiles_total",
                  "new jit shape signatures compiled"
                  ).set_fn(lambda: float(self._compiles_n))
        r.counter("engine_multi_step_blocks_total",
                  "fused multi-step blocks"
                  ).set_fn(lambda: float(self._mblocks_n))
        r.counter("engine_multi_step_iters_total",
                  "decode iterations inside fused blocks"
                  ).set_fn(lambda: float(self._miters_n))
        r.counter("engine_persistent_blocks_total",
                  "device-resident while_loop decode blocks"
                  ).set_fn(lambda: float(self._pblocks_n))
        r.counter("engine_persistent_iters_total",
                  "decode iterations executed inside the device loop"
                  ).set_fn(lambda: float(self._piters_n))
        r.counter("engine_spec_proposed_total",
                  "speculative tokens drafted"
                  ).set_fn(lambda: float(self._spec_p_n))
        r.counter("engine_spec_accepted_total",
                  "speculative tokens accepted"
                  ).set_fn(lambda: float(self._spec_a_n))
        r.gauge("spec_acceptance_rate",
                "running speculative acceptance rate"
                ).set_fn(lambda: (self._spec_a_n / self._spec_p_n
                                  if self._spec_p_n else 0.0))
        self.compile_keys: List[Tuple] = []

    # ---------------------------------------------------------------- hooks
    def sync(self, t, n=1, *, replica=-1):
        self._syncs_n += n

    def dispatch(self, t, kind, n=1, *, replica=-1):
        d = self._disp_n
        if kind in d:
            d[kind] += n
        else:
            # first sight of this kind: tally + bind its labeled series
            d[kind] = n
            self._dispatches.set_fn(
                lambda _k=kind: float(self._disp_n[_k]), kind=kind)

    def jit_compile(self, t, key, *, replica=-1):
        self._compiles_n += 1
        self.compile_keys.append(tuple(key))

    def multi_step(self, t, j, committed, *, replica=-1):
        self._mblocks_n += 1
        self._miters_n += j

    def persistent_loop(self, t, j, steps, *, replica=-1):
        self._pblocks_n += 1
        self._piters_n += steps

    def spec(self, t, proposed, accepted, *, replica=-1):
        self._spec_p_n += proposed
        self._spec_a_n += accepted

    # -------------------------------------------------------------- reading
    def total_dispatches(self) -> int:
        return sum(self._disp_n.values())

    def dispatches_by_kind(self) -> Dict[str, int]:
        return dict(self._disp_n)

    def summary(self) -> Dict:
        """Registry view mirroring `ServingEngine.hotpath_stats()` keys
        (plus the per-kind dispatch breakdown)."""
        return {
            "host_syncs": self._syncs_n,
            "dispatches": self.total_dispatches(),
            "dispatches_by_kind": self.dispatches_by_kind(),
            "jit_compiles": self._compiles_n,
            "multi_step_blocks": self._mblocks_n,
            "multi_step_iters": self._miters_n,
            "persistent_blocks": self._pblocks_n,
            "persistent_iters": self._piters_n,
            "spec_proposed": self._spec_p_n,
            "spec_accepted": self._spec_a_n,
        }


def profile_engine(engine,
                   registry: Optional[MetricsRegistry] = None
                   ) -> ProfilingObserver:
    """Attach a ProfilingObserver (composing with whatever observer is
    already installed) and return it."""
    prof = ProfilingObserver(registry)
    engine.attach_observer(prof)
    return prof
