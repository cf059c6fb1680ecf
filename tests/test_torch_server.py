"""The port's HTTP/SSE server (``repro_torch.server``) on the CPU.

Layered like the reference's server tests: SSE framing units (no socket);
a simulator-backed server over the port's ``ServingSimulator`` for the
reference's protocol cases (healthz, lifecycle frames and pacing, network
scenarios, a bad payload, metrics round trip, concurrent streams), its
frames equal to the reference server's over the reference simulator; an
engine-backed virtual-clock server over the port's engine for the
protocol (healthz, metrics round trip, concurrent streams) and for token
identity — the SSE stream carries exactly the tokens of a direct port
run and of the reference engine (f32, weights bridged from the reference
server's own engine); a slowed wall-clock server (``overhead=0.05``:
tokens ~50 ms apart, wide enough to race against) for disconnect-cancel,
mid-stream drain and the 503 barrier; and the ``python -m
repro_torch.server`` entry point as a subprocess. Wall-clock assertions
are on events only, never on times.
"""
import asyncio
import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.server import ServerConfig as JServerConfig
from repro.server import build_engine as j_build_engine
from repro_torch.bridge import from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core import (TPU_V5E, LatencyModel, QoESpec,
                              make_scheduler)
from repro_torch.core.request import Request
from repro_torch.models import Model
from repro_torch.obs.metrics import parse_prometheus, registry_samples_dict
from repro_torch.server import (SSEParser, ServerConfig, ServingServer,
                                astream, build_engine, collect, fetch,
                                format_sse, stream)
from repro_torch.server.app import _Conn
from repro_torch.serving import ServingEngine, ServingSimulator, SimConfig

torch.set_num_threads(1)
SPEC = QoESpec(ttft=1.0, tds=4.8)
ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# SSE wire format units
# ---------------------------------------------------------------------------

def test_sse_roundtrip_across_chunk_boundaries():
    frames = [format_sse("token", {"index": i, "token": 7 * i, "t": 0.1 * i})
              for i in range(20)]
    frames.append(format_sse("finish", {"qoe": 1.0}, event_id=3))
    blob = b"".join(frames)
    for size in (1, 3, 7, 64, len(blob)):
        p = SSEParser()
        evs = []
        for off in range(0, len(blob), size):
            evs.extend(p.feed(blob[off:off + size]))
        assert len(evs) == 21
        assert evs[0] == ("token", {"index": 0, "token": 0, "t": 0.0})
        assert evs[-1] == ("finish", {"qoe": 1.0})
        assert p.last_id == "3"


def test_sse_parser_spec_features():
    from repro.server import SSEParser as JSSEParser
    wire = (b": keep-alive comment\n"
            b"data: {\"a\": 1}\n\n"
            b"event: multi\r\ndata: line1\r\ndata: line2\r\n\r\n"
            b"ignored-field: x\nevent: token\ndata: {\"i\":0}\n\n")
    evs = SSEParser().feed(wire)
    assert evs[0] == ("message", {"a": 1})
    assert evs[1] == ("multi", {"raw": "line1\nline2"})
    assert evs[2] == ("token", {"i": 0})
    assert evs == JSSEParser().feed(wire)


# ---------------------------------------------------------------------------
# simulator-backed server: the reference's protocol cases
# ---------------------------------------------------------------------------

def _sim_backend(kv=4_000):
    cfg = get_smoke_config("llama3-8b")
    lat = LatencyModel(cfg, TPU_V5E)
    return ServingSimulator(make_scheduler("andes", kv, lat), lat,
                            SimConfig(kv_capacity_tokens=kv))


@pytest.fixture(scope="module")
def sim_server():
    srv = ServingServer(ServerConfig(clock="virtual", warmup=False),
                        backend=_sim_backend())
    srv.start()
    yield srv
    srv.shutdown(drain=False)


SIM_PAYLOADS = ({"prompt_len": 8, "max_tokens": 6},
                {"prompt_len": 8, "max_tokens": 6, "network": "ideal"},
                {"prompt_len": 8, "max_tokens": 6, "network": "satellite"},
                {"prompt_len": 30, "max_tokens": 4, "rid": 77})


def test_sim_server_frames_match_reference_server():
    """Sequential streams through the port's simulator-backed server carry
    the frames the reference server sends over the reference simulator:
    lifecycle, virtual emit times, paced visible times, QoE."""
    from repro.configs import get_smoke_config as j_smoke
    from repro.core import LatencyModel as JLat
    from repro.core import TPU_V5E as J_TPU_V5E
    from repro.core import make_scheduler as j_make_scheduler
    from repro.server import ServingServer as JServingServer
    from repro.serving import ServingSimulator as JSim
    from repro.serving import SimConfig as JSimConfig
    jlat = JLat(j_smoke("llama3-8b"), J_TPU_V5E)
    jsrv = JServingServer(
        JServerConfig(clock="virtual", warmup=False),
        backend=JSim(j_make_scheduler("andes", 4_000, jlat), jlat,
                     JSimConfig(kv_capacity_tokens=4_000)))
    srv = ServingServer(ServerConfig(clock="virtual", warmup=False),
                        backend=_sim_backend())
    frames = []
    for server in (jsrv, srv):
        server.start()
        try:
            frames.append([collect("127.0.0.1", server.port, dict(p))
                           for p in SIM_PAYLOADS])
        finally:
            server.shutdown(drain=False)
    assert frames[0] == frames[1]
    assert [evs[0][1]["rid"] for evs in frames[1]][-1] == 77


def test_sim_server_healthz_404_and_lifecycle(sim_server):
    status, body = fetch("127.0.0.1", sim_server.port, "/healthz")
    assert status == 200 and json.loads(body)["ok"]
    assert fetch("127.0.0.1", sim_server.port, "/nope")[0] == 404
    evs = collect("127.0.0.1", sim_server.port,
                  {"prompt_len": 8, "max_tokens": 6})
    kinds = [k for k, _ in evs]
    assert kinds[0] == "accepted" and kinds[-1] == "finish"
    toks = [d for k, d in evs if k == "token"]
    assert [d["index"] for d in toks] == list(range(6))
    vis = [d["visible"] for d in toks]
    assert all(b - a >= 1.0 / SPEC.tds - 1e-9
               for a, b in zip(vis, vis[1:]))
    assert evs[-1][1]["n_tokens"] == 6 and 0.0 <= evs[-1][1]["qoe"] <= 1.0


def test_sim_server_network_scenario_paces_visible_times(sim_server):
    ideal = collect("127.0.0.1", sim_server.port,
                    {"prompt_len": 8, "max_tokens": 6, "network": "ideal"})
    sat = collect("127.0.0.1", sim_server.port,
                  {"prompt_len": 8, "max_tokens": 6, "network": "satellite"})
    v_ideal = [d["visible"] for k, d in ideal if k == "token"]
    v_sat = [d["visible"] for k, d in sat if k == "token"]
    assert v_sat[0] >= v_ideal[0] + 0.25


def test_sim_server_bad_payload_400(sim_server):
    import socket
    from repro_torch.server.client import _request_bytes, _split_head
    with socket.create_connection(("127.0.0.1", sim_server.port), 5) as s:
        s.sendall(_request_bytes("POST", "/v1/stream", "x", b"not json"))
        data = b""
        while True:
            c = s.recv(65536)
            if not c:
                break
            data += c
    assert _split_head(data)[0] == 400


def test_sim_server_concurrent_streams_and_metrics(sim_server):
    async def many(n):
        return await asyncio.gather(*[
            astream("127.0.0.1", sim_server.port,
                    {"prompt_len": 6, "max_tokens": 5}) for _ in range(n)])

    results = asyncio.run(many(8))
    rids = set()
    for evs in results:
        kinds = [k for k, _ in evs]
        assert kinds[0] == "accepted" and kinds[-1] == "finish"
        assert kinds.count("token") == 5
        rids.add(evs[0][1]["rid"])
    assert len(rids) == 8
    status, text = fetch("127.0.0.1", sim_server.port, "/metrics")
    assert status == 200
    parsed = parse_prometheus(text)
    live = registry_samples_dict(sim_server.registry)
    assert parsed.keys() == live.keys()
    for k, v in live.items():
        assert parsed[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    assert parsed[("requests_submitted_total", ())] >= 8
    assert parsed[("sse_events_flushed_total", ())] >= 40
    assert parsed[("connection_events_total", (("event", "open"),))] >= 8


# ---------------------------------------------------------------------------
# engine-backed virtual server over the port's engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    """The reference server's own smoke engine (virtual clock) and the
    port's engine over the same weights, bridged."""
    config = JServerConfig(clock="virtual", warmup=False)
    cfg, jeng = j_build_engine(config)
    params = from_numpy(jax.tree.map(np.asarray, jeng.params), device="cpu")
    return config, cfg, jeng, params


def _port_engine(params, clock="virtual", hw=TPU_V5E, num_slots=4,
                 max_seq=64):
    cfg = get_smoke_config("llama3-8b")
    lat = LatencyModel(cfg, hw)
    sched = make_scheduler("andes", num_slots * max_seq, lat)
    eng = ServingEngine(Model(cfg, device="cpu"), params, sched, lat,
                        num_slots=num_slots, max_seq=max_seq, clock=clock,
                        device="cpu", reference_decode=True)
    return cfg, eng


@pytest.fixture(scope="module")
def virtual_server(reference):
    _, _, _, params = reference
    cfg, eng = _port_engine(params)
    srv = ServingServer(ServerConfig(clock="virtual", warmup=False),
                        backend=eng, model_cfg=cfg)
    srv.start()
    yield srv
    srv.shutdown(drain=False)


def test_healthz_and_404(virtual_server):
    status, body = fetch("127.0.0.1", virtual_server.port, "/healthz")
    assert status == 200
    h = json.loads(body)
    assert h["ok"] and not h["draining"] and h["clock"] == "virtual"
    assert fetch("127.0.0.1", virtual_server.port, "/nope")[0] == 404


def test_stream_lifecycle_frames(virtual_server):
    evs = collect("127.0.0.1", virtual_server.port,
                  {"prompt_len": 8, "max_tokens": 6})
    kinds = [k for k, _ in evs]
    assert kinds[0] == "accepted" and kinds[-1] == "finish"
    assert kinds.count("token") == 6
    toks = [d for k, d in evs if k == "token"]
    assert [d["index"] for d in toks] == list(range(6))
    vis = [d["visible"] for d in toks]
    assert all(b - a >= 1.0 / SPEC.tds - 1e-9
               for a, b in zip(vis, vis[1:]))
    fin = evs[-1][1]
    assert fin["n_tokens"] == 6 and 0.0 <= fin["qoe"] <= 1.0


def test_concurrent_streams_and_metrics(virtual_server):
    async def many(n):
        return await asyncio.gather(*[
            astream("127.0.0.1", virtual_server.port,
                    {"prompt_len": 6 + i, "max_tokens": 5})
            for i in range(n)])

    before = virtual_server.registry.value("tokens_emitted_total")
    results = asyncio.run(many(6))
    rids = set()
    for evs in results:
        kinds = [k for k, _ in evs]
        assert kinds[0] == "accepted" and kinds[-1] == "finish"
        assert kinds.count("token") == 5
        rids.add(evs[0][1]["rid"])
    assert len(rids) == 6
    status, text = fetch("127.0.0.1", virtual_server.port, "/metrics")
    assert status == 200
    parsed = parse_prometheus(text)
    live = registry_samples_dict(virtual_server.registry)
    assert parsed.keys() == live.keys()
    for k, v in live.items():
        assert parsed[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    assert parsed[("tokens_emitted_total", ())] - before == 30
    assert parsed[("sse_events_flushed_total", ())] >= 30
    assert parsed[("kv_slots_in_use", ())] == 0


def test_backpressure_evicts_slow_consumer(virtual_server):
    conn = _Conn(conn_id=9999, depth=2)
    virtual_server._offer(conn, [{"event": "token", "index": 0}])
    virtual_server._offer(conn, [{"event": "token", "index": 1}])
    assert not conn.dead
    virtual_server._offer(conn, [{"event": "token", "index": 2}])
    assert conn.dead
    assert conn.queue.get_nowait()[0]["event"] == "evicted"
    assert conn.queue.get_nowait() is None


def test_stream_tokens_equal_direct_and_reference_runs(reference):
    """The SSE stream carries exactly the tokens a direct virtual-clock
    port run and the reference engine produce (f32, identity)."""
    config, cfg, _, params = reference
    _, eng = _port_engine(params)
    srv = ServingServer(ServerConfig(clock="virtual", warmup=False),
                        backend=eng, model_cfg=cfg)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 9 + 4 * i).tolist()
               for i in range(3)]
    got = {}
    try:
        srv.start()
        for i, toks in enumerate(prompts):
            evs = collect("127.0.0.1", srv.port,
                          {"prompt_tokens": toks, "max_tokens": 7,
                           "rid": 50 + i})
            got[50 + i] = [d["token"] for k, d in evs if k == "token"]
    finally:
        srv.shutdown(drain=False)

    def workload(make):
        return [make(rid=50 + i, arrival=0.0, prompt_len=len(toks),
                     output_len=7, spec=SPEC,
                     prompt_tokens=np.asarray(toks, np.int32))
                for i, toks in enumerate(prompts)]

    from repro.core.request import Request as JRequest
    _, direct_eng = _port_engine(params)
    direct = direct_eng.run(workload(Request), max_iterations=2000)
    _, ref_eng = j_build_engine(config)
    ref = ref_eng.run(workload(JRequest), max_iterations=2000)
    for d, r in zip(direct, ref):
        assert got[d.rid] == [int(t) for t in d.output_tokens], d.rid
        assert got[r.rid] == [int(t) for t in r.output_tokens], r.rid


def test_build_engine_on_cpu_and_cuda_without_card():
    cfg, eng = build_engine(ServerConfig(clock="virtual"), device="cpu")
    assert cfg.name == "llama3-8b-smoke" and eng.model.device.type == "cpu"
    out = eng.run([Request(rid=0, arrival=0.0, prompt_len=5, output_len=3,
                           spec=SPEC)], max_iterations=100)
    assert out[0].generated == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_engine(ServerConfig(clock="virtual"))


# ---------------------------------------------------------------------------
# slowed wall-clock server: cancellation, drain and the 503 barrier
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wall_server(reference):
    _, _, _, params = reference
    hw = dataclasses.replace(TPU_V5E, overhead=0.05)
    cfg, eng = _port_engine(params, clock="wall", hw=hw)
    srv = ServingServer(ServerConfig(clock="wall", warmup=True,
                                     drain_timeout=60.0),
                        backend=eng, model_cfg=cfg)
    srv.start()
    yield srv
    if not srv._stopped.is_set():
        srv.shutdown(drain=False)


def test_disconnect_cancels_request(wall_server):
    port = wall_server.port
    seen = {}
    for k, d in stream("127.0.0.1", port,
                       {"prompt_len": 6, "max_tokens": 50, "rid": 700},
                       max_events=4):         # accepted + 3 tokens, hang up
        if k == "accepted":
            seen["rid"] = d["rid"]
    assert seen["rid"] == 700
    req = next(r for r in wall_server.backend.seen if r.rid == 700)
    deadline = time.monotonic() + 30
    while not req.cancelled and time.monotonic() < deadline:
        time.sleep(0.05)
    assert req.cancelled and req.generated < 50
    deadline = time.monotonic() + 10
    while wall_server.backend.kv.slots_in_use and time.monotonic() < deadline:
        time.sleep(0.05)
    assert wall_server.backend.kv.slots_in_use == 0
    assert wall_server.registry.value("requests_cancelled_total") >= 1


def test_graceful_drain_completes_live_streams_and_503s_new(wall_server):
    """shutdown(drain=True) mid-stream: live connections run to a clean
    `finish`, new streams bounce with 503, the terminal phase is "done".
    (Last test of the wall server: it consumes it.)"""
    port = wall_server.port
    results = {}
    started = threading.Barrier(3)

    def client(i):
        evs = []
        for ev in stream("127.0.0.1", port,
                         {"prompt_len": 6, "max_tokens": 25,
                          "rid": 800 + i}):
            evs.append(ev)
            if ev[0] == "accepted":
                started.wait(timeout=30)
        results[i] = evs

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    started.wait(timeout=30)

    phase = {}
    shut = threading.Thread(
        target=lambda: phase.update(p=wall_server.shutdown(drain=True)))
    shut.start()
    deadline = time.monotonic() + 10
    while not wall_server._draining and time.monotonic() < deadline:
        time.sleep(0.005)
    assert wall_server._draining
    rejected = collect("127.0.0.1", port, {"prompt_len": 4, "max_tokens": 4})
    assert rejected and rejected[0][0] == "http_error"
    assert rejected[0][1]["status"] == 503

    shut.join(timeout=120)
    for th in threads:
        th.join(timeout=30)
    assert not shut.is_alive() and not any(th.is_alive() for th in threads)
    assert phase["p"] == "done"
    for i in range(2):
        kinds = [k for k, _ in results[i]]
        assert kinds[-1] == "finish", kinds
        assert kinds.count("token") == 25
    assert wall_server.registry.value("drain_events_total",
                                      phase="begin") == 1
    assert wall_server.registry.value("drain_events_total",
                                      phase="done") == 1


# ---------------------------------------------------------------------------
# the CLI entry point
# ---------------------------------------------------------------------------

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_cli_serves_and_drains_on_sigterm():
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.server", "--device", "cpu",
         "--clock", "virtual", "--no-warmup"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env())
    try:
        line = proc.stdout.readline()
        assert line.startswith("LISTENING "), (line, proc.stderr.read())
        port = int(line.split()[1])
        evs = collect("127.0.0.1", port, {"prompt_len": 7, "max_tokens": 4})
        assert [k for k, _ in evs].count("token") == 4
        assert evs[-1][0] == "finish"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert "DRAINED done" in out
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_cli_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "-m", "repro_torch.server"],
                         capture_output=True, text=True, env=_env(),
                         timeout=120)
    assert res.returncode != 0
    assert "LISTENING" not in res.stdout
    assert "no CUDA device" in res.stderr
