"""Asyncio HTTP/SSE serving frontend over ServingClient.

This is the wire edge of the repo: the first place the serving stack
talks to something it does not control — a real socket, a real client,
real time. The moving parts:

* **Engine pump thread.** The backend (a `ServingEngine`, usually with
  `clock="wall"` so its emissions happen at LatencyModel pace in real
  time) plus its `ServingClient` live on one dedicated thread, because
  `step()` may *sleep* to hold the schedule and must never block the
  event loop. Commands (submit / cancel / stop) reach it through a
  `queue.Queue`; after every step it flushes newly emitted tokens to the
  owning connections via `loop.call_soon_threadsafe`.

* **Asyncio loop thread.** A stdlib `asyncio.start_server` HTTP/1.1
  frontend (standard library only):

      POST /v1/stream   JSON body -> SSE stream of lifecycle frames
                        (accepted / token / preempt / finish / shed /
                        cancel), mapping StreamHandle events 1:1.
      GET  /metrics     Prometheus text from the live MetricsRegistry.
      GET  /trace       the TraceRecorder's events as a Chrome trace
                        (Perfetto), with the engine's span log, if it
                        has one, drawn on a host thread.
      GET  /healthz     liveness + clock mode + live-connection count.

* **Backpressure.** Each connection owns a bounded `asyncio.Queue`; a
  consumer that stops reading long enough to fill it is *evicted* — its
  request cancelled on the engine (freeing the KV slot for paying
  traffic) and its stream closed with an `evicted` frame. A client
  disconnect mid-stream does the same through the reader-EOF path.

* **Graceful drain.** `shutdown(drain=True)` (what SIGTERM triggers in
  `python -m repro_torch.server`) stops admitting new streams (503), lets live
  ones finish within `drain_timeout`, then stops the pump and the loop.
  Every phase fires the `Observer.drain` hook; connection lifecycle and
  flush volume go through `Observer.connection` / `Observer.sse_flush`,
  so the trace/metrics layers see the wire exactly like they see the
  scheduler.

Wall-clock timestamps in SSE frames are engine-relative seconds (the
same clock as the trace events), so a captured stream can be compared
frame-for-frame against a virtual-clock reference run with the
`serving.tolerance` harness — the acceptance gate of the server's smoke
run.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import math
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.api import ServingClient, SubmitOptions
from repro_torch.core import QoESpec, make_network
from repro_torch.core.request import Request
from repro_torch.core.token_buffer import TokenBuffer
from repro_torch.obs import MetricsObserver, MetricsRegistry, TraceRecorder, compose
from repro_torch.obs.metrics import register_backend_gauges
from repro_torch.server.sse import format_sse

_MAX_HEADER_BYTES = 65536
_MAX_BODY_BYTES = 1 << 20


@dataclasses.dataclass
class ServerConfig:
    """Knobs for a ServingServer (CLI flags in `python -m repro_torch.server`)."""
    host: str = "127.0.0.1"
    port: int = 0                  # 0 = OS-assigned; read server.port after start
    arch: str = "llama3-8b"        # smoke-config architecture
    clock: str = "wall"            # "wall" = real-time pacing (the point)
    scheduler: str = "andes"
    num_slots: int = 4
    max_seq: int = 64
    queue_depth: int = 256         # per-connection SSE backpressure bound
    drain_timeout: float = 10.0    # graceful-shutdown budget (seconds)
    warmup: bool = True            # absorb jit compile before first request
    default_spec: QoESpec = dataclasses.field(
        default_factory=lambda: QoESpec(ttft=1.0, tds=4.8))


def build_engine(config: ServerConfig, device="cuda"):
    """Construct the smoke-model ServingEngine a standalone server runs,
    on `device` (a card unless the caller asks for the CPU), with random
    weights from seed 0.

    Split out so tests can build the identical engine with
    `clock="virtual"` for the differential reference."""
    import torch

    from repro_torch.bridge import init_params
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import TPU_V5E, LatencyModel, make_scheduler
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine

    cfg = get_smoke_config(config.arch)
    model = Model(cfg, device=device)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device=device)
    lat = LatencyModel(cfg, TPU_V5E)
    sched = make_scheduler(config.scheduler, config.num_slots * config.max_seq,
                           lat)
    eng = ServingEngine(model, params, sched, lat,
                        num_slots=config.num_slots, max_seq=config.max_seq,
                        clock=config.clock, device=device)
    return cfg, eng


class _Conn:
    """Per-connection state, bridging the pump thread and the loop.

    The pump thread owns `handle`, `cursor`, `buf`, and `marks`; the loop
    thread owns `queue` and the writer. `dead` is a one-way flag either
    side may set (GIL-atomic) meaning "stop producing for this stream"."""

    def __init__(self, conn_id: int, depth: int):
        self.conn_id = conn_id
        self.handle = None                    # set by pump on submit
        self.cursor = 0                       # emit_times consumed so far
        self.buf: Optional[TokenBuffer] = None
        self.marks: List[Dict[str, Any]] = [] # preempt/shed frames, in order
        self.queue: "asyncio.Queue" = asyncio.Queue(maxsize=depth)
        self.dead = False
        self.final_sent = False


class ServingServer:
    """The HTTP/SSE frontend. Sync lifecycle: start() / shutdown().

    Pass a prebuilt `backend` (anything ServingClient accepts) to serve
    it directly, or leave it None to build the smoke engine described by
    `config` on `device`. The server owns a TraceRecorder + MetricsRegistry attached
    alongside any observers the backend already has.
    """

    def __init__(self, config: Optional[ServerConfig] = None, *,
                 backend=None, model_cfg=None, device="cuda"):
        self.config = config if config is not None else ServerConfig()
        if backend is None:
            model_cfg, backend = build_engine(self.config, device=device)
        self.model_cfg = model_cfg
        self.backend = backend
        self.registry = MetricsRegistry()
        self.trace = TraceRecorder()
        backend.attach_observer(
            compose(self.trace, MetricsObserver(self.registry)))
        register_backend_gauges(self.registry, backend)
        self.client = ServingClient(backend)
        self.port: Optional[int] = None
        self._cmds: "queue.Queue" = queue.Queue()
        self._conns: Dict[int, _Conn] = {}     # pump-owned registry
        self._next_conn = 0
        self._draining = False
        self._started = False
        self._stopped = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._ready = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None
        self._pump_thread: Optional[threading.Thread] = None
        self._asyncio_server = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> int:
        """Bind, start the loop and pump threads, return the bound port."""
        if self._started:
            return self.port
        self._loop_thread = threading.Thread(target=self._loop_main,
                                             name="sse-loop", daemon=True)
        self._loop_thread.start()
        if not self._ready.wait(timeout=30):
            raise RuntimeError("server event loop failed to start")
        if self.port is None:
            raise RuntimeError("server failed to bind")
        if self.config.warmup:
            self._warmup()
        self._pump_thread = threading.Thread(target=self._pump,
                                             name="engine-pump", daemon=True)
        self._pump_thread.start()
        self._started = True
        return self.port

    def _warmup(self) -> None:
        """Run one tiny request through the backend so jit compilation
        happens before the socket accepts traffic — otherwise the first
        client's wall TTFT eats the compile time (the same reason the
        tolerance tests warm their wall engines)."""
        run = getattr(self.backend, "run", None)
        if run is None or self.model_cfg is None:
            return
        rng = np.random.default_rng(0)
        wl = [Request(rid=-(i + 1), arrival=0.0, prompt_len=5, output_len=3,
                      spec=self.config.default_spec,
                      prompt_tokens=rng.integers(
                          0, self.model_cfg.vocab_size, 5))
              for i in range(2)]
        run(wl, max_iterations=500)
        # fresh clock for real traffic: without this, wall_now() would
        # carry the warmup's compile seconds into every arrival stamp
        reset = getattr(self.backend, "reset", None)
        if reset is not None:
            reset()

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> str:
        """Stop serving. With `drain`, refuse new streams (503) and wait
        up to `timeout` (default config.drain_timeout) for live ones to
        finish. Returns the terminal drain phase: "done" or "timeout"."""
        if not self._started or self._stopped.is_set():
            return "done"
        timeout = self.config.drain_timeout if timeout is None else timeout
        self._draining = True
        t = self._now()
        self._observer_call("drain", t, "begin", len(self._conns),
                            self._live_count())
        phase = "done"
        if drain and self._conns:
            self._observer_call("drain", self._now(), "waiting",
                                len(self._conns), self._live_count())
            deadline = time.monotonic() + timeout
            while self._conns and time.monotonic() < deadline:
                time.sleep(0.02)
            phase = "done" if not self._conns else "timeout"
        self._cmds.put(("stop",))
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=10)
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10)
        self._observer_call("drain", self._now(), phase, len(self._conns),
                            self._live_count())
        self._stopped.set()
        return phase

    def _live_count(self) -> int:
        try:
            return len(self.backend.live)
        except Exception:
            return 0

    def _now(self) -> float:
        wall = getattr(self.backend, "wall_now", None)
        return float(wall() if callable(wall) else self.backend.now)

    def _observer_call(self, hook: str, *args) -> None:
        obs = getattr(self.backend, "obs", None) or self.backend.observer
        if obs is not None:
            getattr(obs, hook)(*args)

    # ------------------------------------------------------------ loop side
    def _loop_main(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def boot():
            self._asyncio_server = await asyncio.start_server(
                self._serve_conn, self.config.host, self.config.port)
            self.port = self._asyncio_server.sockets[0].getsockname()[1]
            self._ready.set()

        loop.run_until_complete(boot())
        try:
            loop.run_forever()
        finally:
            self._asyncio_server.close()
            loop.run_until_complete(self._asyncio_server.wait_closed())
            loop.close()

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            if not line:
                return
            try:
                method, path, _ = line.decode("latin-1").split()
            except ValueError:
                await self._respond(writer, 400, {"error": "bad request"})
                return
            headers: Dict[str, str] = {}
            total = 0
            while True:
                h = await reader.readline()
                total += len(h)
                if h in (b"\r\n", b"\n", b""):
                    break
                if total > _MAX_HEADER_BYTES:
                    await self._respond(writer, 431,
                                        {"error": "headers too large"})
                    return
                k, _, v = h.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            n = int(headers.get("content-length", "0") or 0)
            if n > _MAX_BODY_BYTES:
                await self._respond(writer, 413, {"error": "body too large"})
                return
            if n:
                body = await reader.readexactly(n)

            if method == "GET" and path == "/healthz":
                await self._respond(writer, 200, {
                    "ok": True,
                    "clock": getattr(self.backend, "clock", "virtual"),
                    "draining": self._draining,
                    "connections": len(self._conns),
                    "live": self._live_count(),
                })
            elif method == "GET" and path == "/metrics":
                await self._respond(writer, 200, self.registry.to_prometheus(),
                                    ctype="text/plain; version=0.0.4")
            elif method == "GET" and path == "/trace":
                # a long run's trace takes a while to build: off the loop
                body = await asyncio.get_running_loop().run_in_executor(
                    None, self._chrome_trace)
                await self._respond(writer, 200, body)
            elif method == "POST" and path == "/v1/stream":
                await self._stream(reader, writer, body)
            else:
                await self._respond(writer, 404, {"error": "not found"})
        except (ConnectionResetError, asyncio.IncompleteReadError,
                BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    def _chrome_trace(self) -> str:
        return json.dumps(self.trace.to_chrome_trace(
            getattr(self.backend, "spans", None)))

    async def _respond(self, writer: asyncio.StreamWriter, status: int,
                       body, ctype: str = "application/json") -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  413: "Payload Too Large", 431: "Headers Too Large",
                  503: "Service Unavailable"}.get(status, "Error")
        if not isinstance(body, (bytes, str)):
            body = json.dumps(body)
        if isinstance(body, str):
            body = body.encode("utf-8")
        writer.write((f"HTTP/1.1 {status} {reason}\r\n"
                      f"Content-Type: {ctype}\r\n"
                      f"Content-Length: {len(body)}\r\n"
                      "Connection: close\r\n\r\n").encode("latin-1") + body)
        await writer.drain()

    async def _stream(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter, body: bytes) -> None:
        t = self._now()
        if self._draining:
            self._observer_call("connection", t, -1, "reject")
            await self._respond(writer, 503, {"error": "draining"})
            return
        try:
            payload = json.loads(body.decode("utf-8")) if body else {}
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, UnicodeDecodeError) as e:
            await self._respond(writer, 400, {"error": str(e)})
            return

        conn = _Conn(self._next_conn, self.config.queue_depth)
        self._next_conn += 1
        self._observer_call("connection", t, conn.conn_id, "open")
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        self._cmds.put(("submit", payload, conn))

        # EOF on the read side = client went away; an SSE client never
        # sends more bytes after the request, so any read completion
        # (data or EOF) means disconnect.
        eof_task = asyncio.ensure_future(reader.read(1))
        try:
            while True:
                get_task = asyncio.ensure_future(conn.queue.get())
                done, _ = await asyncio.wait(
                    {get_task, eof_task},
                    return_when=asyncio.FIRST_COMPLETED)
                if get_task not in done:
                    get_task.cancel()
                    conn.dead = True
                    if conn.handle is not None:
                        self._cmds.put(("cancel", conn.handle.rid))
                    self._observer_call("connection", self._now(),
                                        conn.conn_id, "disconnect")
                    return
                batch = get_task.result()
                if batch is None:              # sentinel: stream complete
                    break
                frame = b"".join(format_sse(ev.pop("event"), ev)
                                 for ev in batch)
                writer.write(frame)
                await writer.drain()
                self._observer_call("sse_flush", self._now(), conn.conn_id,
                                    conn.handle.rid if conn.handle else -1,
                                    len(batch), len(frame))
        except (ConnectionResetError, BrokenPipeError):
            conn.dead = True
            if conn.handle is not None:
                self._cmds.put(("cancel", conn.handle.rid))
            self._observer_call("connection", self._now(), conn.conn_id,
                                "disconnect")
            return
        finally:
            if not eof_task.done():
                eof_task.cancel()
        self._observer_call("connection", self._now(), conn.conn_id, "close")

    def _offer(self, conn: _Conn, batch: Optional[List[Dict[str, Any]]]):
        """Loop-thread callback: enqueue a flush batch for one connection.

        A full queue means the consumer stopped reading while the engine
        kept emitting — evict: drop what it hasn't read, cancel its
        request, and end the stream with an `evicted` frame so the client
        knows it wasn't a clean finish."""
        if conn.dead:
            return
        if batch is None:
            try:
                conn.queue.put_nowait(None)
            except asyncio.QueueFull:
                # drop unread frames so the sentinel always fits — the
                # stream is over either way
                conn.queue.get_nowait()
                conn.queue.put_nowait(None)
            return
        try:
            conn.queue.put_nowait(batch)
        except asyncio.QueueFull:
            conn.dead = True
            while True:
                try:
                    conn.queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
            t = self._now()
            conn.queue.put_nowait([{"event": "evicted", "t": t}])
            conn.queue.put_nowait(None)
            if conn.handle is not None:
                self._cmds.put(("cancel", conn.handle.rid))
            self._observer_call("connection", t, conn.conn_id, "evict")

    # ------------------------------------------------------------ pump side
    def _pump(self) -> None:
        while True:
            try:
                while True:
                    if self._apply(self._cmds.get_nowait()):
                        return
            except queue.Empty:
                pass
            progressed = self.client.step()
            self._flush_all()
            if not progressed:
                try:
                    cmd = self._cmds.get(timeout=0.02)
                except queue.Empty:
                    continue
                if self._apply(cmd):
                    return
                # apply newly submitted work before sleeping again
                self.client.step()
                self._flush_all()

    def _apply(self, cmd) -> bool:
        """Execute one command on the pump thread. True = stop."""
        kind = cmd[0]
        if kind == "stop":
            # anything still connected gets a terminal frame so its
            # handler coroutine wakes up and closes
            for conn in list(self._conns.values()):
                self._post(conn, [{"event": "shutdown", "t": self._now()}],
                           final=True)
                self._conns.pop(conn.conn_id, None)
            return True
        if kind == "cancel":
            self.client.cancel(cmd[1])
            return False
        if kind == "submit":
            _, payload, conn = cmd
            try:
                self._submit(payload, conn)
            except Exception as e:
                self._post(conn, [{"event": "error", "message": str(e)}],
                           final=True)
            return False
        return False

    def _submit(self, payload: Dict[str, Any], conn: _Conn) -> None:
        spec = self.config.default_spec
        spec = QoESpec(ttft=float(payload.get("ttft", spec.ttft)),
                       tds=float(payload.get("tds", spec.tds)))
        toks = payload.get("prompt_tokens")
        if toks is not None:
            prompt = np.asarray(toks, np.int32)
        else:
            plen = int(payload.get("prompt_len", 8))
            vocab = (self.model_cfg.vocab_size
                     if self.model_cfg is not None else 32_000)
            # deterministic per-connection prompt so differential runs
            # can reproduce it
            prompt = np.random.default_rng(
                (1234, conn.conn_id)).integers(0, vocab, plen)
        # explicit arrival: ServingClient's default reads backend.now,
        # which on a wall engine is the *paced* clock (stale while the
        # pump is between steps) — stamp the real reading instead
        opts = SubmitOptions(
            spec=spec,
            max_tokens=int(payload.get("max_tokens", 16)),
            tenant=int(payload.get("tenant", 0)),
            priority=int(payload.get("priority", 0)),
            arrival=self._now(),
        )
        if payload.get("rid") is not None:
            # trace replays pin rids for differential pairing
            req = Request(rid=int(payload["rid"]), arrival=opts.arrival,
                          prompt_len=int(prompt.size),
                          output_len=opts.max_tokens, spec=spec,
                          prompt_tokens=prompt, tenant=opts.tenant,
                          priority=opts.priority)
            handle = self.client.submit_request(req)
        else:
            handle = self.client.submit(prompt, opts)
        conn.handle = handle
        net = payload.get("network")
        conn.buf = TokenBuffer(spec.tds,
                               network=make_network(net) if net else None)
        handle.on_preempt = lambda h, t: conn.marks.append(
            {"event": "preempt", "t": t})
        self._conns[conn.conn_id] = conn
        self._observer_call("connection", self._now(), conn.conn_id,
                            "request", {"rid": handle.rid})
        self._post(conn, [{"event": "accepted", "rid": handle.rid,
                           "arrival": handle.request.arrival}])

    def _post(self, conn: _Conn, batch: Optional[List[Dict[str, Any]]],
              final: bool = False) -> None:
        """Hand a batch to the loop thread (pump side)."""
        if conn.dead or self._loop is None:
            return
        self._loop.call_soon_threadsafe(self._offer, conn, batch)
        if final:
            conn.final_sent = True
            self._loop.call_soon_threadsafe(self._offer, conn, None)

    def _flush_all(self) -> None:
        for conn in list(self._conns.values()):
            if conn.dead:
                self._conns.pop(conn.conn_id, None)
                continue
            self._flush(conn)
            if conn.final_sent:
                self._conns.pop(conn.conn_id, None)

    def _flush(self, conn: _Conn) -> None:
        h = conn.handle
        if h is None:
            return
        r = h.request
        batch: List[Dict[str, Any]] = conn.marks
        conn.marks = []
        while conn.cursor < len(r.emit_times):
            i = conn.cursor
            conn.cursor += 1
            e = float(r.emit_times[i])
            tok = (int(r.output_tokens[i]) if i < len(r.output_tokens)
                   else None)
            batch.append({"event": "token", "index": i, "token": tok,
                          "t": e, "visible": conn.buf.push(e)})
        final = False
        if h.shed:
            batch.append({"event": "shed", "t": self._now()})
            final = True
        elif h.cancelled:
            batch.append({"event": "cancel", "t": self._now(),
                          "n_tokens": int(r.generated)})
            final = True
        elif h.finished:
            tds = r.final_tds()
            batch.append({"event": "finish", "t": float(r.finish_time),
                          "n_tokens": int(r.generated),
                          "ttft": r.final_ttft(),
                          "tds": tds if math.isfinite(tds) else None,
                          "qoe": r.final_qoe()})
            final = True
        if batch:
            self._post(conn, batch, final=final)
        elif final:
            self._post(conn, None)
            conn.final_sent = True


__all__ = ["ServerConfig", "ServingServer", "build_engine"]
