"""Server-sent events (SSE) wire format: framing and incremental parsing.

The streaming surface of the HTTP frontend maps the `StreamHandle` /
`TokenEvent` lifecycle 1:1 onto SSE frames (WHATWG HTML §9.2 subset):

    event: token
    data: {"index": 0, "token": 1234, "t": 0.183, "visible": 1.0}

One frame per lifecycle event, `data` always a single JSON line. The
parser is the strict inverse and is incremental — feed it arbitrary byte
chunks as they come off the socket (frames routinely straddle TCP reads)
and it yields complete events in order. Both directions are exercised
against each other and against a live server in tests/test_server.py.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple


def format_sse(event: str, data: Any, event_id: Optional[int] = None) -> bytes:
    """Render one SSE frame. `data` is JSON-encoded (single line)."""
    lines = [f"event: {event}"]
    if event_id is not None:
        lines.append(f"id: {event_id}")
    lines.append("data: " + json.dumps(data, separators=(",", ":")))
    return ("\n".join(lines) + "\n\n").encode("utf-8")


class SSEParser:
    """Incremental SSE decoder: bytes in, (event, data) tuples out.

    Handles frames split across chunk boundaries, multi-line `data:`
    fields (joined with \\n per spec), `id:` fields, comment lines
    (leading ':'), and both \\n and \\r\\n line endings. Unknown field
    names are ignored, as the spec requires.
    """

    def __init__(self):
        self._buf = b""
        self._event = ""
        self._data: List[str] = []
        self.last_id: Optional[str] = None

    def feed(self, chunk: bytes) -> List[Tuple[str, Dict[str, Any]]]:
        """Consume a chunk; return every event completed by it."""
        self._buf += chunk
        out: List[Tuple[str, Dict[str, Any]]] = []
        while True:
            nl = self._buf.find(b"\n")
            if nl < 0:
                break
            line = self._buf[:nl].rstrip(b"\r")
            self._buf = self._buf[nl + 1:]
            ev = self._line(line.decode("utf-8"))
            if ev is not None:
                out.append(ev)
        return out

    def _line(self, line: str) -> Optional[Tuple[str, Dict[str, Any]]]:
        if line == "":                       # blank line: dispatch the frame
            if not self._event and not self._data:
                return None                  # stray keep-alive blank
            event = self._event or "message"
            raw = "\n".join(self._data)
            self._event, self._data = "", []
            try:
                data = json.loads(raw) if raw else {}
            except json.JSONDecodeError:
                data = {"raw": raw}
            return (event, data)
        if line.startswith(":"):             # comment / keep-alive
            return None
        field, _, value = line.partition(":")
        value = value[1:] if value.startswith(" ") else value
        if field == "event":
            self._event = value
        elif field == "data":
            self._data.append(value)
        elif field == "id":
            self.last_id = value
        return None


__all__ = ["format_sse", "SSEParser"]
