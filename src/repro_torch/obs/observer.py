"""The Observer protocol: one hook surface for every layer of the stack.

Backends (ServingSimulator / ServingEngine / ClusterSimulator), the
scheduler, and the cluster control plane all report through a single
`Observer` object. The base class is the *null* implementation — every
hook is a no-op — and the default everywhere is `None`, so instrumentation
sites cost exactly one `is not None` test when observability is off.

Hook taxonomy (all timestamps are virtual-clock seconds):

  request lifecycle   submit admit prefill emit preempt swap_in finish
                      shed defer cancel
  scheduler           schedule (decision payload: pricing inputs, victim
                      set), multi_step (idle_steps certificate j)
  fleet               route admission scale
  hot path            sync dispatch jit_compile spec
  wire / server       connection sse_flush drain (repro_torch.server; `t` is the
                      serving clock — wall seconds for a wall engine)

Every hook takes a keyword-only ``replica`` (default -1 = "not a cluster
replica" / fleet-level). `ScopedObserver` stamps it so one observer
attached at the cluster level sees which replica each event came from.

Composition:

  MultiObserver      fan out one event stream to several observers
  ScopedObserver     tag events with a replica id
  EventSinkAdapter   adapt an Observer stream back onto the legacy
                     ``sink(kind, req, t, k)`` callable (deprecated)
  compose(*obs)      None-tolerant combinator returning None / the single
                     observer / a flattened MultiObserver
"""
from __future__ import annotations

from typing import Callable, Optional


class Observer:
    """Null observer: subclass and override only the hooks you need.

    Contract notes:
      * hooks must not mutate the request or any engine state — the
        differential oracle (tests/test_obs.py) asserts instrumented runs
        are bit-for-bit identical to uninstrumented ones;
      * ``t`` is the clock of the emitting backend (virtual seconds, or
        a wall engine's ``wall_now()``); on the wall clock the engine's
        ``emit`` of a staged first token, and a ``finish`` it causes,
        carry the time the host holds the token, after its readback,
        while ``req.emit_times`` keep the staging tick;
      * ``replica`` is keyword-only and already stamped when the event
        crossed a cluster boundary (-1 means single-node / fleet-level).
    """

    # ---- request lifecycle -------------------------------------------------
    def submit(self, req, t, *, replica=-1):
        """Request entered the system (arrival)."""

    def admit(self, req, t, *, replica=-1):
        """Request became visible to the scheduler (joined the live set)."""

    def prefill(self, req, t, n_tokens, *, replica=-1):
        """Prompt (or recompute) prefill of `n_tokens` charged at `t`."""

    def prefill_chunk(self, req, t, cursor, total, *, replica=-1):
        """One chunk of a chunked prefill committed: `cursor` of `total`
        context tokens are now resident on-device (the `prefill` hook
        still fires once when the final chunk lands)."""

    def emit(self, req, t, k=1, *, replica=-1):
        """`k` tokens delivered to the client at `t`."""

    def preempt(self, req, t, mode="swap", *, replica=-1):
        """Request evicted from the batch (`mode`: "swap"|"recompute")."""

    def swap_in(self, req, t, *, replica=-1):
        """Swapped-out request restored to the device."""

    def finish(self, req, t, *, replica=-1):
        """Request completed its full response."""

    def shed(self, req, t, *, replica=-1):
        """Admission control rejected the request outright."""

    def defer(self, req, t, *, replica=-1):
        """Admission control pushed the request back into the queue."""

    def cancel(self, req, t, *, replica=-1):
        """Request aborted by the client (disconnect / explicit cancel)
        before completing; `req.generated` tokens had been emitted."""

    # ---- scheduler ---------------------------------------------------------
    def schedule(self, t, info, *, replica=-1):
        """One scheduler decision. `info` is a JSON-able dict: policy,
        n_live, chosen rids, and (for QoE-aware policies) the pricing
        inputs — candidate batch sizes, chosen B, knapsack value, gains,
        victim set."""

    def multi_step(self, t, j, committed, *, replica=-1):
        """Engine ran a fused block of `j` decode iterations under a
        scheduler `idle_steps` certificate, committing `committed` tokens."""

    def persistent_loop(self, t, j, steps, *, replica=-1):
        """The fused block ran as a device-resident while_loop: planned
        `j` iterations, the device executed `steps` (< j only when every
        active row emitted its EOS early). Fires IN ADDITION to
        `multi_step` — the persistent path is a strict specialization."""

    # ---- fleet -------------------------------------------------------------
    def route(self, req, t, replica_id, gain, scores, *, replica=-1):
        """Router picked `replica_id`; `scores` maps replica id -> marginal
        QoE gain (None for score-free policies)."""

    def admission(self, req, t, action, gain, *, replica=-1):
        """Admission verdict: action in {"admit","shed","defer"}."""

    def scale(self, t, action, replica_id, signal=None, *, replica=-1):
        """Autoscaler event: action in {"scale_up","scale_down","reap",
        "provision_ready"}; `signal` is the attainment/pressure snapshot
        that triggered it (when available)."""

    # ---- hot path ----------------------------------------------------------
    def sync(self, t, n=1, *, replica=-1):
        """`n` host<->device synchronizations (device_get / blocking read)."""

    def dispatch(self, t, kind, n=1, *, replica=-1):
        """`n` device computation dispatches of `kind` (prefill / write /
        decode / decode_multi / spec_fused / propose / verify / read)."""

    def jit_compile(self, t, key, *, replica=-1):
        """A new jit shape signature `key` entered the compile cache."""

    def spec(self, t, proposed, accepted, *, replica=-1):
        """One speculative iteration: drafted `proposed`, accepted
        `accepted` tokens (acceptance rate = accepted/proposed)."""

    # ---- wire / server (repro_torch.server) --------------------------------------
    # `t` on these hooks is the *serving* clock (wall seconds since server
    # start for a wall-clock engine) and `conn_id` a server-unique integer
    # per accepted TCP connection.
    def connection(self, t, conn_id, event, info=None, *, replica=-1):
        """Connection lifecycle: event in {"open","request","close",
        "disconnect","reject"}; `info` is a small JSON-able dict (peer,
        path, rid, ...) when available."""

    def sse_flush(self, t, conn_id, rid, n_events, n_bytes, *, replica=-1):
        """`n_events` server-sent events (`n_bytes` on the wire) flushed
        to connection `conn_id` for request `rid`."""

    def drain(self, t, phase, conns, live, *, replica=-1):
        """Graceful-shutdown progress: phase in {"begin","waiting",
        "done","timeout"} with `conns` open connections and `live`
        unfinished requests remaining."""


#: Every hook name, in canonical order. MultiObserver / ScopedObserver
#: forwarders are generated from this list so new hooks only need a
#: definition on Observer plus an entry here.
HOOK_NAMES = (
    "submit", "admit", "prefill", "prefill_chunk", "emit", "preempt",
    "swap_in", "finish",
    "shed", "defer", "cancel",
    "schedule", "multi_step", "persistent_loop",
    "route", "admission", "scale",
    "sync", "dispatch", "jit_compile", "spec",
    "connection", "sse_flush", "drain",
)


def _is_null_hook(bound: Callable, name: str) -> bool:
    """True when `bound` is the inherited no-op from the Observer base
    (works for both class methods and instance-attribute closures)."""
    return getattr(bound, "__func__", None) is getattr(Observer, name)


class MultiObserver(Observer):
    """Fan a single event stream out to several observers, in order.

    Forwarders are pre-bound per hook at construction (the children tuple
    is immutable): a hook no child overrides inherits the Observer no-op,
    a single-consumer hook IS that child's bound method (no wrapper), and
    only genuinely shared hooks pay a fan-out loop. This keeps a full
    trace+metrics+profiling stack inside the engine benchmark's ~2%
    overhead budget on per-token events."""

    def __init__(self, *children: Observer):
        self.children = tuple(c for c in children if c is not None)
        for name in HOOK_NAMES:
            targets = tuple(getattr(c, name) for c in self.children
                            if not _is_null_hook(getattr(c, name), name))
            if not targets:
                continue                      # inherit the class no-op
            if len(targets) == 1:
                setattr(self, name, targets[0])
            else:
                setattr(self, name, _fanout(targets))


def _fanout(targets: tuple) -> Callable:
    if len(targets) == 2:           # the common full-stack case, loop-free
        f1, f2 = targets

        def hook(*args, **kwargs):
            f1(*args, **kwargs)
            f2(*args, **kwargs)
        return hook

    def hook(*args, **kwargs):
        for f in targets:
            f(*args, **kwargs)
    return hook


class ScopedObserver(Observer):
    """Stamp every forwarded event with a replica id.

    The cluster installs one of these on each replica backend so a single
    observer attached at the cluster level can attribute events. An
    already-stamped event (replica != -1) passes through untouched.
    Forwarders are pre-bound like MultiObserver's: hooks the inner
    observer does not consume stay the inherited no-op."""

    def __init__(self, inner: Observer, replica: int):
        self.inner = inner
        self.replica = replica
        for name in HOOK_NAMES:
            bound = getattr(inner, name)
            if not _is_null_hook(bound, name):
                setattr(self, name, _scoped(bound, replica))


def _scoped(bound: Callable, stamp: int) -> Callable:
    def hook(*args, replica=-1, **kwargs):
        bound(*args, replica=stamp if replica == -1 else replica, **kwargs)
    return hook


class EventSinkAdapter(Observer):
    """Adapter from the Observer stream to the legacy ``event_sink``.

    .. deprecated::
        ``backend.event_sink = fn`` (a ``fn(kind, req, t, k)`` callable
        receiving kinds emit/preempt/finish/shed/defer) predates the
        Observer protocol. It keeps working — backends wrap an assigned
        sink in this adapter and compose it with any installed observer —
        but new code should subclass :class:`Observer`, which also sees
        scheduler, fleet, and hot-path events the sink never carried.
    """

    def __init__(self, sink: Callable):
        self.sink = sink

    def emit(self, req, t, k=1, *, replica=-1):
        self.sink("emit", req, t, k)

    def preempt(self, req, t, mode="swap", *, replica=-1):
        self.sink("preempt", req, t, 0)

    def finish(self, req, t, *, replica=-1):
        self.sink("finish", req, t, 0)

    def shed(self, req, t, *, replica=-1):
        self.sink("shed", req, t, 0)

    def defer(self, req, t, *, replica=-1):
        self.sink("defer", req, t, 0)


def compose(*observers: Optional[Observer]) -> Optional[Observer]:
    """Combine observers, tolerating None: returns None when empty, the
    lone observer when singular, otherwise a flattened MultiObserver."""
    flat = []
    for obs in observers:
        if obs is None:
            continue
        if isinstance(obs, MultiObserver):
            flat.extend(obs.children)
        else:
            flat.append(obs)
    if not flat:
        return None
    if len(flat) == 1:
        return flat[0]
    return MultiObserver(*flat)
