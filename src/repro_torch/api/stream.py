"""Token streams: the client-visible side of a served request.

The paper defines QoE on the *user's* timeline (§4): first token promptly,
then tokens at a digestible pace, with the client-side buffer (§5)
re-smoothing whatever burstiness the server produced. `StreamHandle` is
that timeline as an object: an iterator of timestamped `TokenEvent`s whose
`visible_time` is the §5 buffer-paced display instant (TokenBuffer — the
incremental form of core.qoe.pace_delivery), plus the lifecycle callbacks
a real streaming client would register (first token, emission bursts,
preemptions, completion).

Iterating a handle *drives the backend*: `__next__` steps the underlying
engine/simulator/cluster until this request's next token exists. Because
every backend is virtual-clocked and deterministic, pulling streams in any
order yields the same token timeline as draining the backend wholesale —
the differential guarantee tests/test_api.py pins.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.qoe import pace_delivery
from repro_torch.core.request import Request, ReqState
from repro_torch.core.token_buffer import TokenBuffer


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One user-visible token of a streamed response."""
    index: int                 # 0-based position in the response
    emit_time: float           # server emission timestamp (absolute, s)
    visible_time: float        # §5 buffer-paced display timestamp
    token: Optional[int]       # token id (real engines; None in simulation)


Callback = Callable[["StreamHandle", float], None]
EmitCallback = Callable[["StreamHandle", float, int], None]


class StreamHandle:
    """A live token stream for one submitted request.

    Iteration yields `TokenEvent`s, stepping the backend on demand; the
    handle is also the per-request reporting surface (qoe/ttft/tds and the
    raw/paced timelines) once the stream ends. Lifecycle callbacks:

      on_first_token(handle, t)   first server emission (TTFT instant)
      on_emit(handle, t, k)       every server emission (k tokens — k > 1
                                  is a speculative verify burst)
      on_preempt(handle, t)       the request lost its batch slot
      on_finish(handle, t)        the response completed

    A request the cluster admission layer rejected never emits: `shed`
    flips True, iteration ends, and final_qoe() is 0 — exactly how fleet
    metrics account for it (§6.4 degrade-gracefully).
    """

    def __init__(self, client, request: Request):
        self._client = client
        self.request = request
        self._buf = TokenBuffer(request.spec.tds)
        self._cursor = 0
        self._emitted_seen = 0
        self.shed = False
        self.deferrals = 0
        self.on_first_token: Optional[Callback] = None
        self.on_emit: Optional[EmitCallback] = None
        self.on_preempt: Optional[Callback] = None
        self.on_finish: Optional[Callback] = None
        self.on_cancel: Optional[Callback] = None

    # ------------------------------------------------------------ identity
    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def finished(self) -> bool:
        return self.request.state == ReqState.FINISHED

    @property
    def cancelled(self) -> bool:
        """Aborted by the client (disconnect / ServingClient.cancel)."""
        return self.request.cancelled

    @property
    def done(self) -> bool:
        """No more tokens will ever arrive (finished or shed)."""
        return self.finished or self.shed

    # ------------------------------------------------------- event plumbing
    def _event(self, kind: str, t: float, k: int) -> None:
        """Dispatched by the ServingClient's backend event sink."""
        if kind == "emit":
            if self._emitted_seen == 0 and self.on_first_token is not None:
                self.on_first_token(self, t)
            self._emitted_seen += k
            if self.on_emit is not None:
                self.on_emit(self, t, k)
        elif kind == "preempt":
            if self.on_preempt is not None:
                self.on_preempt(self, t)
        elif kind == "finish":
            if self.on_finish is not None:
                self.on_finish(self, t)
        elif kind == "shed":
            self.shed = True
        elif kind == "defer":
            self.deferrals += 1
        elif kind == "cancel":
            if self.on_cancel is not None:
                self.on_cancel(self, t)

    # ------------------------------------------------------------ iteration
    def __iter__(self) -> "StreamHandle":
        return self

    def __next__(self) -> TokenEvent:
        r = self.request
        while self._cursor >= len(r.emit_times):
            if self.done or not self._client.step():
                raise StopIteration
        i = self._cursor
        self._cursor += 1
        e = float(r.emit_times[i])
        v = self._buf.push(e)
        tok = r.output_tokens[i] if i < len(r.output_tokens) else None
        return TokenEvent(index=i, emit_time=e, visible_time=v, token=tok)

    def read(self) -> List[TokenEvent]:
        """Drain this stream to completion and return every event."""
        return list(self)

    # ------------------------------------------------------------ reporting
    def emit_times(self) -> np.ndarray:
        return np.asarray(self.request.emit_times, np.float64)

    def visible_times(self) -> np.ndarray:
        """The §5 buffer-paced delivery timeline (absolute timestamps)."""
        return pace_delivery(self.emit_times(), self.request.spec.tds)

    def tokens(self) -> List[int]:
        return list(self.request.output_tokens)

    def qoe(self) -> float:
        return self.request.final_qoe()

    def ttft(self) -> float:
        return self.request.final_ttft()

    def tds(self) -> float:
        return self.request.final_tds()

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        state = ("shed" if self.shed
                 else self.request.state.value)
        return (f"StreamHandle(rid={self.rid}, {state}, "
                f"{len(self.request.emit_times)} tokens)")
