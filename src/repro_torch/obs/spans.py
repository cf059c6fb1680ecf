"""Spans and counters written inside the port, on the engine's own clock.

A ``SpanLog`` is a bounded in-memory log that the serving engine and the
model write as they work. A span is a closed interval: its name, start
and end, the span that was open around it when it began (its parent, by
sequence number; -1 at the top), its own sequence number and a small
payload (a dict of ints, or of tuples of rids and lengths: the spans of
one request carry its rid). A counter is a name and a total since the
last ``reset``. ``NO_SPANS`` is a log that keeps nothing, for a writer
whose spans nobody reads (a draft model's prefill).

Times are seconds on the writer's clock: CLOCK_MONOTONIC less the log's
``epoch`` by default (a wall engine's ``wall_now()``, with the epoch its
``_wall0``), so ``epoch + t`` is absolute host time; or whatever
``clock`` returns (a virtual engine's ``now``). Storage is a ring of
``capacity`` closed spans, so a server that runs for days does not
grow; ``dropped_until`` is the latest end among the spans the ring has
overwritten, and ``covers(t0, t1)`` says whether every span that started
in [t0, t1) is still held. ``reset`` clears the log and takes a new
epoch.

The process keeps weak references to its live logs, the one reset last
at the end (``logs()``): a reader that holds no engine (a benchmark
reader, a debugging shell) finds its log there. ``active()`` is the log
with a span open on the calling thread, which is how the model, called
by the engine, writes into the engine's log.

On the profiler's clock: while a ``torch.profiler`` session records,
every span also opens a profiler range ``repro_torch.<name>``. The first
span of a session first opens one empty anchor range,
``repro_torch.anchor``, and ``anchors()`` keeps its host start on
CLOCK_MONOTONIC: the anchor's start in the profiler's trace less that
time is the one offset that lays every span of every log onto the
trace. ``sublayer_ranges()`` gives the model's per-sublayer ranges,
which exist only while a profiler records and are not written to any
log. With no profiler recording, a span pays one boolean check for all
of this.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Callable, List, NamedTuple, Optional

import torch

try:                                    # a range that costs ~1 us
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:                     # pragma: no cover - older torch
    from torch.autograd.profiler import record_function as _Range

try:
    _recording = torch._C._autograd._profiler_enabled
except AttributeError:                  # pragma: no cover - older torch
    def _recording() -> bool:
        return torch.autograd.profiler._is_profiler_enabled

_monotonic = time.monotonic
PREFIX = "repro_torch."
ANCHOR = PREFIX + "anchor"


class Span(NamedTuple):
    name: str
    start: float
    end: float
    parent: int
    seq: int
    payload: object


class _Profiler:
    """Whether the last span saw a profiler recording, and the host start
    (CLOCK_MONOTONIC) of each session's anchor range. One per process,
    as the profiler is."""
    on = False
    anchors: List[float] = []


def ranged(name: str):
    """A profiler range ``repro_torch.<name>``, as a context manager."""
    return _Range(PREFIX + name)


_NO_RANGE = contextlib.nullcontext()


def unranged(name: str):
    """A context manager that does nothing (``ranged``'s stand-in)."""
    return _NO_RANGE


def _open_range(name: str):
    if not _Profiler.on:
        _Profiler.on = True
        t0 = _monotonic()
        anchor = _Range(ANCHOR)
        anchor.__enter__()
        _Profiler.anchors.append((t0 + _monotonic()) / 2.0)
        anchor.__exit__(None, None, None)
    rng = ranged(name)
    rng.__enter__()
    return rng


def anchors() -> List[float]:
    """Host start, on CLOCK_MONOTONIC, of each profiler session's anchor
    range ``repro_torch.anchor``, oldest first."""
    return list(_Profiler.anchors)


def sublayer_ranges() -> Callable:
    """``ranged`` while a profiler records, else ``unranged``. Taken once
    per forward, so the layers pay no check of their own."""
    return ranged if _recording() else unranged


_tls = threading.local()
_logs: List[weakref.ref] = []
_logs_lock = threading.Lock()


def _newest(log: "SpanLog") -> None:
    with _logs_lock:
        _logs[:] = [r for r in _logs
                    if r() is not None and r() is not log]
        _logs.append(weakref.ref(log))


def logs() -> List["SpanLog"]:
    """The process's live span logs, the one reset last at the end."""
    with _logs_lock:
        return [log for log in (r() for r in _logs) if log is not None]


def active() -> Optional["SpanLog"]:
    """The log with a span open on this thread, or None."""
    return getattr(_tls, "log", None)


def begin(log: Optional["SpanLog"], name: str, payload=None) -> int:
    """``log.begin(name, payload)``; -1 when `log` is None (a model called
    with no span open, outside an engine)."""
    return -1 if log is None else log.begin(name, payload)


def end(log: Optional["SpanLog"], seq: int) -> None:
    """``log.end(seq)``; nothing when `log` is None."""
    if log is not None:
        log.end(seq)


class SpanLog:
    """A ring of closed spans and a dict of counters (module docstring).

    ``begin(name, payload)`` opens a span and returns its sequence
    number; ``end(seq)`` closes it, and first any span opened inside it
    and left open (an exception's way out), so a log never holds a
    child that outlives its parent."""

    def __init__(self, capacity: int = 1 << 16,
                 clock: Optional[Callable[[], float]] = None,
                 epoch: Optional[float] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._clock = clock
        self._stack: list = []
        self._outer = None
        self.reset(epoch)

    def reset(self, epoch: Optional[float] = None) -> None:
        """Drop every span and counter and start a new epoch
        (CLOCK_MONOTONIC seconds; now by default)."""
        self.epoch = _monotonic() if epoch is None else float(epoch)
        self._ring: list = [None] * self.capacity
        self._n = 0                     # spans closed since the reset
        self._seq = 0
        if self._stack:
            self._stack = []
            _tls.log = self._outer
        self.dropped_until = float("-inf")
        self.counters: dict = {}
        _newest(self)

    def now(self) -> float:
        clock = self._clock
        return clock() if clock is not None else _monotonic() - self.epoch

    # ------------------------------------------------------------ writing
    # an open span is (seq, name, start, parent, payload, range)
    def begin(self, name: str, payload=None) -> int:
        stack = self._stack
        if stack:
            parent = stack[-1][0]
        else:
            parent = -1
            self._outer = getattr(_tls, "log", None)
            _tls.log = self
        seq = self._seq
        self._seq = seq + 1
        rng = None
        if _recording():
            rng = _open_range(name)
        elif _Profiler.on:
            _Profiler.on = False
        # the clock is read next to the range's own stamps
        clock = self._clock
        t = clock() if clock is not None else _monotonic() - self.epoch
        stack.append((seq, name, t, parent, payload, rng))
        return seq

    def end(self, seq: int) -> None:
        stack = self._stack
        if not stack or stack[-1][0] < seq:
            return                      # closed already
        clock = self._clock
        ring, cap = self._ring, self.capacity
        while stack and stack[-1][0] >= seq:
            s, name, t0, parent, payload, rng = stack.pop()
            t1 = clock() if clock is not None else _monotonic() - self.epoch
            if rng is not None:
                rng.__exit__(None, None, None)
            n = self._n
            i = n % cap
            if n >= cap:                # spans close in order of their ends
                self.dropped_until = ring[i][2]
            # a tuple: the collector stops tracking one of plain values
            ring[i] = (name, t0, t1, parent, s, payload)
            self._n = n + 1
        if not stack:
            _tls.log = self._outer

    def count(self, *pairs) -> None:
        """Add each (name, n) pair to its counter."""
        c = self.counters
        for name, n in pairs:
            c[name] = c.get(name, 0) + n

    # ------------------------------------------------------------ reading
    def spans(self) -> List[Span]:
        """The closed spans the ring holds, in the order they closed."""
        n, cap = self._n, self.capacity
        if n <= cap:
            held = self._ring[:n]
        else:
            held = self._ring[n % cap:] + self._ring[:n % cap]
        return [Span(*rec) for rec in held]

    def covers(self, t0: float, t1: float) -> bool:
        """True when the log holds every span that started in [t0, t1):
        none closed at or after t0 has been overwritten, and the clock
        has reached t1 since the last reset."""
        return self.dropped_until < t0 and self.now() >= t1

    def to_host(self, t: float) -> float:
        """A time of this log as CLOCK_MONOTONIC seconds (default clock)."""
        return self.epoch + t


class _NoSpans(SpanLog):
    """A log that keeps nothing and is in no reader's list (``NO_SPANS``)."""

    def __init__(self):
        self.capacity = 0
        self.epoch = 0.0
        self._clock = None
        self.counters: dict = {}
        self.dropped_until = float("-inf")

    def reset(self, epoch: Optional[float] = None) -> None:
        pass

    def begin(self, name: str, payload=None) -> int:
        return -1

    def end(self, seq: int) -> None:
        pass

    def count(self, *pairs) -> None:
        pass

    def spans(self) -> List[Span]:
        return []


NO_SPANS = _NoSpans()
