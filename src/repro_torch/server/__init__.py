"""repro_torch.server — HTTP/SSE wire frontend over the serving stack.

  ServingServer  — asyncio HTTP server: POST /v1/stream (SSE token
                   streams mapping StreamHandle 1:1), GET /metrics
                   (Prometheus text), GET /healthz; per-connection
                   backpressure, disconnect-cancel, graceful drain.
  ServerConfig   — knobs (host/port, arch, clock mode, queue depth).
  build_engine   — the smoke ServingEngine a standalone server runs.
  format_sse / SSEParser — wire framing + incremental decoder.
  stream / fetch — minimal blocking client helpers (tests, examples).

Run one: `python -m repro_torch.server --port 8080` (SIGTERM drains).
"""
from repro_torch.server.app import ServerConfig, ServingServer, build_engine
from repro_torch.server.client import astream, collect, fetch, stream
from repro_torch.server.sse import SSEParser, format_sse

__all__ = [
    "ServingServer", "ServerConfig", "build_engine",
    "format_sse", "SSEParser", "stream", "collect", "astream", "fetch",
]
