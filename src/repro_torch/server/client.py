"""Minimal HTTP/SSE client helpers for the repro_torch.server frontend.

Stdlib-only (raw sockets + SSEParser), deliberately independent of the
server's asyncio internals so tests exercise the wire format the way an
external consumer would: bytes on a TCP socket, chunk boundaries
wherever the kernel puts them. `stream()` is the blocking form used by
tests/examples; `astream()` is the asyncio form used when a test needs
many concurrent connections in one loop.
"""
from __future__ import annotations

import asyncio
import json
import socket
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.server.sse import SSEParser

Event = Tuple[str, Dict[str, Any]]


def _request_bytes(method: str, path: str, host: str,
                   body: Optional[bytes] = None,
                   ctype: str = "application/json") -> bytes:
    head = [f"{method} {path} HTTP/1.1", f"Host: {host}",
            "Connection: close"]
    if body:
        head += [f"Content-Type: {ctype}", f"Content-Length: {len(body)}"]
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + (body or b"")


def _split_head(data: bytes) -> Tuple[int, Dict[str, str], bytes]:
    head, _, rest = data.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    headers: Dict[str, str] = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers, rest


def fetch(host: str, port: int, path: str,
          timeout: float = 10.0) -> Tuple[int, str]:
    """Blocking GET; returns (status, body_text). For /metrics, /healthz,
    /trace."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(_request_bytes("GET", path, host))
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    status, _, body = _split_head(data)
    return status, body.decode("utf-8")


def stream(host: str, port: int, payload: Dict[str, Any],
           timeout: float = 60.0,
           max_events: Optional[int] = None) -> Iterator[Event]:
    """Open one POST /v1/stream and yield (event, data) tuples as they
    arrive. Closing the generator early closes the socket — the server
    sees the disconnect and cancels the request (what a browser tab
    closing does). `max_events` stops reading after that many events
    WITHOUT closing cleanly first, for disconnect tests."""
    body = json.dumps(payload).encode("utf-8")
    s = socket.create_connection((host, port), timeout=timeout)
    try:
        s.sendall(_request_bytes("POST", "/v1/stream", host, body))
        parser = SSEParser()
        buf = b""
        # read past the HTTP response head first
        while b"\r\n\r\n" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                return
            buf += chunk
        status, _, rest = _split_head(buf)
        if status != 200:
            yield ("http_error", {"status": status,
                                  "body": rest.decode("utf-8", "replace")})
            return
        n = 0
        for ev in parser.feed(rest):
            yield ev
            n += 1
            if max_events is not None and n >= max_events:
                return
        while True:
            chunk = s.recv(65536)
            if not chunk:
                return
            for ev in parser.feed(chunk):
                yield ev
                n += 1
                if max_events is not None and n >= max_events:
                    return
    finally:
        try:
            s.close()
        except OSError:
            pass


def collect(host: str, port: int, payload: Dict[str, Any],
            timeout: float = 60.0) -> List[Event]:
    """stream() drained to a list (one whole response)."""
    return list(stream(host, port, payload, timeout=timeout))


async def astream(host: str, port: int, payload: Dict[str, Any]) -> List[Event]:
    """Asyncio variant of collect() — lets a test hold N concurrent
    streams open in one event loop."""
    body = json.dumps(payload).encode("utf-8")
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(_request_bytes("POST", "/v1/stream", host, body))
        await writer.drain()
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = await reader.read(65536)
            if not chunk:
                return []
            buf += chunk
        status, _, rest = _split_head(buf)
        if status != 200:
            return [("http_error", {"status": status,
                                    "body": rest.decode("utf-8", "replace")})]
        parser = SSEParser()
        events = list(parser.feed(rest))
        while True:
            chunk = await reader.read(65536)
            if not chunk:
                return events
            events.extend(parser.feed(chunk))
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass


__all__ = ["fetch", "stream", "collect", "astream"]
