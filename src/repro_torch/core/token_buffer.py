"""Client-side token buffer (paper §5, Fig. 8) — incremental form.

The server streams tokens as fast as it generates them; the buffer shows
them to the user at the expected TDS, absorbing generation burstiness and
network jitter. The first token is displayed on arrival.

An optional `network` model (repro_torch.core.network) sits between the server
emission and the buffer: `push(emit_time)` is then the *server-side*
timestamp, transited through the link (delay/jitter/loss, in-order) before
the buffer paces it. The default (None) keeps arrival == emission, so all
existing timelines are unchanged.
"""
from __future__ import annotations

from typing import List, Optional, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (network -> qoe)
    from repro_torch.core.network import NetworkModel


class TokenBuffer:
    def __init__(self, tds: float, network: "Optional[NetworkModel]" = None):
        self.gap = 1.0 / tds
        self.network = network
        self.deliveries: List[float] = []
        self.arrivals: List[float] = []
        self._last: Optional[float] = None

    def push(self, emit_time: float) -> float:
        """Register a server emission; returns the user-visible display time."""
        if self.network is not None:
            emit_time = self.network.transit(emit_time)
        self.arrivals.append(emit_time)
        d = emit_time if self._last is None else max(emit_time, self._last + self.gap)
        self._last = d
        self.deliveries.append(d)
        return d

    def buffered_at(self, t: float) -> int:
        """Tokens received but not yet displayed at time t."""
        return sum(1 for d in self.deliveries if d > t)

    def __len__(self) -> int:
        return len(self.deliveries)
