"""The span log inside the port (``repro_torch.obs.spans``) on the CPU:
what the engine and the model write into it on the smoke model, how it
stores and forgets, that writing it changes nothing the engine computes,
that its profiler ranges land where the log says once the anchor's
offset is applied, that the wall clock's hooks stay in order, and that
the counters reach the server's ``/metrics`` and the spans its
``/trace``."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import (TPU_V5E, LatencyModel, QoESpec,
                              SchedulerConfig, make_scheduler)
from repro_torch.models import Model
from repro_torch.obs import Observer, TraceRecorder
from repro_torch.obs import spans as spans_lib
from repro_torch.obs.spans import NO_SPANS, SpanLog
from repro_torch.serving import HotpathConfig, Request, ServingEngine
from repro_torch.serving.engine import BucketedPrefill

torch.set_num_threads(1)
CAP = 100
CALL_PARTS = ["prefill.stage", "prefill.cache_init", "model.prefill",
              "prefill.write", "prefill.readback"]
EAGER_PARTS = ["prefill.cache_init", "prefill.stage", "model.prefill",
               "prefill.write", "prefill.readback"]
COUNTERS = ("prefill.calls", "prefill.rows", "prefill.row_slots",
            "prefill.tokens", "prefill.token_slots")


@pytest.fixture(scope="module")
def model():
    tm = Model(get_smoke_config("llama3-8b"), device="cpu")
    return tm, tm.init(torch.Generator().manual_seed(0))


def _engine(model, cap=CAP, **kw):
    tm, tp = model
    lat = LatencyModel(tm.cfg, TPU_V5E)
    sched = make_scheduler("andes", cap, lat, SchedulerConfig(delta_t=2.0))
    return ServingEngine(tm, tp, sched, lat, num_slots=4, max_seq=64,
                         capacity_tokens=cap, device="cpu", **kw)


def _decoding_trace(vocab):
    """12 staggered requests of 14 tokens: with CAP they preempt."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(12):
        plen = int(rng.integers(5, 30))
        out.append(Request(rid=i, arrival=i * 0.01, prompt_len=plen,
                           output_len=14, spec=QoESpec(ttft=1.0, tds=4.8),
                           prompt_tokens=rng.integers(0, vocab, plen)))
    return out


def _burst(vocab, output_len, lens=(5, 9, 11, 20, 30, 3)):
    """Requests all due at 0 (staged together when they decode)."""
    rng = np.random.default_rng(1)
    return [Request(rid=100 + i, arrival=0.0, prompt_len=n,
                    output_len=output_len, spec=QoESpec(ttft=1.0, tds=4.8),
                    prompt_tokens=rng.integers(0, vocab, n))
            for i, n in enumerate(lens)]


def _named(log, name):
    return [s for s in log.spans() if s.name == name]


def _children(log, span):
    return sorted((s for s in log.spans() if s.parent == span.seq),
                  key=lambda s: s.seq)


def test_one_schedule_per_step(model):
    eng = _engine(model)
    eng.run(_decoding_trace(model[0].cfg.vocab_size), max_iterations=4000)
    steps = _named(eng.spans, "engine.step")
    scheds = _named(eng.spans, "engine.schedule")
    assert len(steps) == len(scheds) > 10
    by_seq = {s.seq: s for s in steps}
    assert all(by_seq[s.parent].name == "engine.step" for s in scheds)
    assert all(s.parent == -1 for s in steps)


@pytest.mark.parametrize("eager", [False, True], ids=["bucketed", "eager"])
def test_prefill_call_parts_nested_in_order(model, eager):
    """Wall clock: each call's parts are its children in call order, lie
    inside it and add up to no more than it; the forward's cache fill is
    the forward's child; the payload names the rids and valid lengths."""
    hot = HotpathConfig.baseline() if eager else HotpathConfig()
    eng = _engine(model, cap=4096, clock="wall", hotpath=hot)
    reqs = _burst(model[0].cfg.vocab_size, 1) + \
        _burst(model[0].cfg.vocab_size, 3, lens=(7, 12, 13))
    for i, r in enumerate(reqs):
        r.rid = 200 + i
    eng.run(reqs, max_iterations=100)
    log = eng.spans
    calls = _named(log, "engine.prefill_call")
    assert calls
    seen = {}
    for c in calls:
        kids = _children(log, c)
        assert all(c.start <= k.start <= k.end <= c.end for k in kids)
        assert sum(k.end - k.start for k in kids) <= c.end - c.start
        # the eager call's clock tick, between its write and readback,
        # may sleep on the wall clock
        kids = [k for k in kids if k.name != "engine.tick_sleep"]
        assert [k.name for k in kids] == (EAGER_PARTS if eager
                                          else CALL_PARTS)
        fwd = kids[2]
        fill = [k.name for k in _children(log, fwd)]
        assert fill == ["model.cache_fill"]
        p = c.payload
        assert len(p["rids"]) == len(p["lengths"]) <= p["rows"]
        if eager:
            assert p["rows"] == 1 and p["bucket"] == p["lengths"][0]
        assert max(p["lengths"]) <= p["bucket"]
        seen.update(zip(p["rids"], p["lengths"]))
    assert seen == {r.rid: r.prompt_len for r in reqs}
    assert any(len(c.payload["rids"]) > 1 for c in calls) != eager


def test_counters_match_padded_shapes_and_payloads(model, monkeypatch):
    shapes = []
    inner = BucketedPrefill._call

    def call(self, params, tokens, lengths, frames):
        shapes.append((tuple(tokens.shape), lengths.tolist()))
        return inner(self, params, tokens, lengths, frames)

    monkeypatch.setattr(BucketedPrefill, "_call", call)
    eng = _engine(model, cap=4096)
    reqs = _burst(model[0].cfg.vocab_size, 4) + \
        _burst(model[0].cfg.vocab_size, 1, lens=(40, 33))
    eng.run(reqs, max_iterations=200)
    c = eng.spans.counters
    assert c["prefill.calls"] == len(shapes) >= 3
    assert c["prefill.row_slots"] == sum(s[0] for s, _ in shapes)
    assert c["prefill.token_slots"] == sum(s[0] * s[1] for s, _ in shapes)
    assert c["prefill.rows"] == sum(sum(n > 0 for n in ls)
                                    for _, ls in shapes)
    assert c["prefill.tokens"] == sum(sum(ls) for _, ls in shapes)
    assert c["prefill.row_slots"] > c["prefill.rows"]      # row padding
    pays = [s.payload for s in _named(eng.spans, "engine.prefill_call")]
    assert c["prefill.calls"] == len(pays)
    assert c["prefill.rows"] == sum(len(p["lengths"]) for p in pays)
    assert c["prefill.row_slots"] == sum(p["rows"] for p in pays)
    assert c["prefill.tokens"] == sum(sum(p["lengths"]) for p in pays)
    assert c["prefill.token_slots"] == sum(p["rows"] * p["bucket"]
                                           for p in pays)
    eng.reset()
    assert eng.spans.counters == {} and eng.spans.spans() == []


def test_decode_and_swap_spans(model):
    eng = _engine(model, preemption_mode="swap")
    reqs = eng.run(_decoding_trace(model[0].cfg.vocab_size),
                   max_iterations=4000)
    log = eng.spans
    assert eng.preemptions > 0
    blocks = _named(log, "engine.decode_block")
    assert blocks and all(b.payload["rows"] >= 1 and b.payload["j"] >= 1
                          for b in blocks)
    assert any(b.payload["j"] > 1 for b in blocks)
    outs, ins = _named(log, "engine.swap_out"), _named(log, "engine.swap_in")
    assert len(outs) == eng.kv.swaps_out_total == eng.preemptions
    assert sorted(s.payload["rid"] for s in ins) == \
        sorted(s.payload["rid"] for s in outs)
    assert {s.payload["rid"] for s in outs} <= {r.rid for r in reqs
                                                if r.preemptions}


def test_decode_block_payload_carries_the_batch_width(model):
    """Every decode block names the batch width its decode computed: every
    slot, whatever the live count."""
    eng = _engine(model, cap=4096)
    eng.run(_decoding_trace(model[0].cfg.vocab_size), max_iterations=4000)
    blocks = _named(eng.spans, "engine.decode_block")
    assert blocks
    assert all(b.payload["slots"] == eng.kv.num_slots == 4 for b in blocks)
    assert any(b.payload["rows"] < b.payload["slots"] for b in blocks)


@pytest.fixture(scope="module")
def moe_model():
    tm = Model(get_smoke_config("qwen2-moe-a2.7b"), device="cpu")
    return tm, tm.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("reference", [False, True],
                         ids=["live", "reference"])
def test_moe_decode_counters(moe_model, reference):
    """``moe.routed_slots`` counts live tokens x top-k and
    ``moe.expert_rows`` experts x capacity, over every layer of every
    decode step a block ran: one slot per live row and expert by
    default; every slot, under the capacity over the batch, in the
    reference setting."""
    from repro_torch.models.moe import capacity
    tm = moe_model[0]
    m, L = tm.cfg.moe, tm.cfg.num_layers
    eng = _engine(moe_model, cap=4096, reference_decode=reference)
    eng.run(_decoding_trace(tm.cfg.vocab_size), max_iterations=4000)
    pays = [b.payload for b in _named(eng.spans, "engine.decode_block")]
    assert any(p["j"] > 1 for p in pays)
    c = eng.spans.counters
    if reference:
        rows = [p["slots"] for p in pays]
        caps = [capacity(p["slots"], tm.cfg) for p in pays]
    else:
        rows = caps = [p["rows"] for p in pays]
    assert c["moe.routed_slots"] == L * m.top_k * sum(
        p["j"] * n for p, n in zip(pays, rows))
    assert c["moe.expert_rows"] == L * m.num_experts * sum(
        p["j"] * n for p, n in zip(pays, caps))
    assert c["moe.routed_slots"] < c["moe.expert_rows"]


@pytest.mark.parametrize("which", ["dense", "moe"])
def test_the_decode_fix_adds_no_host_sync(model, moe_model, which):
    """The default engine and the reference setting sync with the host and
    dispatch to the device as often, step for step."""
    m = model if which == "dense" else moe_model
    vocab = m[0].cfg.vocab_size
    a, b = (_engine(m, reference_decode=r) for r in (False, True))
    a.run(_decoding_trace(vocab), max_iterations=4000)
    b.run(_decoding_trace(vocab), max_iterations=4000)
    assert a.iterations == b.iterations
    assert a.host_syncs == b.host_syncs > 0
    assert a.dispatches == b.dispatches
    assert a.hotpath_stats() == b.hotpath_stats()


def _fingerprint(reqs):
    return [(r.rid, tuple(r.output_tokens), tuple(r.emit_times),
             r.preemptions) for r in sorted(reqs, key=lambda r: r.rid)]


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_the_log_changes_nothing(model, mode):
    """An engine writing its log serves bit for bit what one whose log
    keeps nothing (NO_SPANS: the engine before the log) serves."""
    vocab = model[0].cfg.vocab_size
    on = _engine(model, preemption_mode=mode)
    off = _engine(model, preemption_mode=mode)
    off.spans = off._prefill.spans = NO_SPANS
    a = on.run(_decoding_trace(vocab), max_iterations=4000)
    b = off.run(_decoding_trace(vocab), max_iterations=4000)
    assert on.preemptions == off.preemptions > 0
    assert _fingerprint(a) == _fingerprint(b)
    assert on.hotpath_stats() == off.hotpath_stats()
    assert on.spans.spans() and off.spans.spans() == []
    assert NO_SPANS not in spans_lib.logs()


def test_ring_keeps_its_capacity():
    t = [0.0]
    log = SpanLog(capacity=8, clock=lambda: t[0])
    for i in range(20):
        outer = log.begin("outer", {"i": i})
        t[0] += 1.0
        log.begin("inner")           # left open: closed by its parent
        t[0] += 1.0
        log.end(outer)
        log.end(outer)               # closed already: nothing happens
    held = log.spans()
    assert len(held) == log.capacity == 8
    assert [s.payload["i"] for s in held if s.name == "outer"] == \
        list(range(16, 20))
    assert all(s.name == "inner" for s in held[::2])
    assert log.dropped_until == 32.0
    assert log.covers(32.5, 40.0) and not log.covers(31.0, 40.0)
    assert not log.covers(32.5, 41.0)
    assert spans_lib.logs()[-1] is log
    log.reset()
    assert log.spans() == [] and log.dropped_until == float("-inf")
    with pytest.raises(ValueError):
        SpanLog(capacity=0)


def test_wall_emit_hook_after_the_readback(model):
    """On the wall clock the first token's emit hook carries a time no
    earlier than the end of its readback; emit_times keep the staging
    tick."""
    class Hooks(Observer):
        def __init__(self):
            self.t = {}

        def emit(self, req, t, k=1, *, replica=-1):
            self.t.setdefault(req.rid, t)

    eng = _engine(model, cap=4096, clock="wall")
    hooks = Hooks()
    eng.observer = hooks
    reqs = eng.run(_burst(model[0].cfg.vocab_size, 3), max_iterations=100)
    log = eng.spans
    done = {}
    for c in _named(log, "engine.prefill_call"):
        rb = [k for k in _children(log, c) if k.name == "prefill.readback"]
        for rid in c.payload["rids"]:
            done[rid] = rb[0].end
    for r in reqs:
        assert hooks.t[r.rid] >= done[r.rid] >= r.emit_times[0]


def test_wall_hooks_keep_their_order(model):
    """On the wall clock a request's emit hooks come in order and none
    after its finish hook, also where a one-token request finishes on
    its staged first token (whose emit carries the readback's time)."""
    eng = _engine(model, cap=4096, clock="wall")
    tr = TraceRecorder()
    eng.observer = tr
    reqs = _burst(model[0].cfg.vocab_size, 1) + \
        _burst(model[0].cfg.vocab_size, 3, lens=(7, 12, 13))
    for i, r in enumerate(reqs):
        r.rid = 300 + i
    eng.run(reqs, max_iterations=100)
    for r in reqs:
        evs = [e for e in tr.events if e.rid == r.rid]
        emits = [e.t for e in evs if e.kind == "emit"]
        fin = [e.t for e in evs if e.kind == "finish"]
        assert len(emits) == r.output_len and len(fin) == 1, r.rid
        assert emits == sorted(emits) and emits[-1] <= fin[0], r.rid
        assert emits[0] >= r.emit_times[0]
    spans = {e["tid"]: e for e in tr.to_chrome_trace()["traceEvents"]
             if e["ph"] == "X"}
    for r in reqs:
        first = min(e.t for e in tr.events
                    if e.rid == r.rid and e.kind == "emit")
        x = spans[r.rid]
        assert x["ts"] + x["dur"] >= first * 1e6 - 1e-3


def test_profiler_ranges_line_up_with_the_log(model):
    """Under torch.profiler (CPU) every span is also a range of its name;
    after the anchor's offset the two agree within 100 us. The sublayer
    ranges exist only in the trace."""
    from torch.profiler import ProfilerActivity, profile
    eng = _engine(model, cap=4096, clock="wall")
    reqs = _burst(model[0].cfg.vocab_size, 1) + \
        _burst(model[0].cfg.vocab_size, 3, lens=(6, 8))
    before = len(spans_lib.anchors())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(reqs, max_iterations=100)
    assert len(spans_lib.anchors()) == before + 1
    evs = [e for e in prof.events() if e.name.startswith("repro_torch.")]
    anchor = [e for e in evs if e.name == spans_lib.ANCHOR]
    assert len(anchor) == 1
    offset = anchor[0].time_range.start - spans_lib.anchors()[-1] * 1e6
    log = eng.spans
    names = {s.name for s in log.spans()}
    assert {"engine.step", "engine.prefill_call", "model.prefill",
            "engine.decode_block"} <= names
    for name in names:
        mine = sorted(_named(log, name), key=lambda s: s.seq)
        theirs = sorted((e for e in evs if e.name == "repro_torch." + name),
                        key=lambda e: e.time_range.start)
        assert len(mine) == len(theirs), name
        for s, e in zip(mine, theirs):
            assert abs(log.to_host(s.start) * 1e6 + offset
                       - e.time_range.start) < 100.0, name
            assert abs(log.to_host(s.end) * 1e6 + offset
                       - e.time_range.end) < 100.0, name
    fine = {e.name for e in evs} - {"repro_torch." + n for n in names}
    assert fine == {spans_lib.ANCHOR, "repro_torch.norm",
                    "repro_torch.attention", "repro_torch.mlp"}
    layers = model[0].cfg.num_layers
    calls = len(_named(log, "engine.prefill_call"))
    assert sum(e.name == "repro_torch.attention" for e in evs) >= \
        layers * calls


def test_chrome_trace_draws_the_spans(model):
    eng = _engine(model, cap=4096)
    tr = TraceRecorder()
    eng.observer = tr
    eng.run(_burst(model[0].cfg.vocab_size, 2), max_iterations=100)
    out = tr.to_chrome_trace(eng.spans)
    drawn = [e for e in out["traceEvents"] if e.get("cat") == "span"]
    assert len(drawn) == len(eng.spans.spans())
    assert {e["pid"] for e in drawn} == {0}
    calls = [e for e in drawn if e["name"] == "engine.prefill_call"]
    assert sorted(r for e in calls for r in e["args"]["rids"]) == \
        list(range(100, 106))
    assert len(tr.to_chrome_trace()["traceEvents"]) < len(out["traceEvents"])


def test_counters_reach_the_servers_metrics(model):
    from repro_torch.obs.metrics import SPAN_COUNTER_GAUGES, parse_prometheus
    from repro_torch.server import (ServerConfig, ServingServer, collect,
                                    fetch)
    eng = _engine(model, cap=4096)
    srv = ServingServer(ServerConfig(clock="virtual", warmup=False),
                        backend=eng, model_cfg=model[0].cfg)
    srv.start()
    try:
        evs = collect("127.0.0.1", srv.port,
                      {"prompt_len": 9, "max_tokens": 4})
        assert evs[-1][0] == "finish"
        status, text = fetch("127.0.0.1", srv.port, "/metrics")
    finally:
        srv.shutdown(drain=False)
    assert status == 200
    parsed = parse_prometheus(text)
    for counter, gauge, _help in SPAN_COUNTER_GAUGES:
        got = eng.spans.counters.get(counter, 0)
        assert parsed[(gauge, ())] == got, gauge
    assert parsed[("engine_prefill_tokens_total", ())] == 9


def test_servers_trace_draws_the_spans(model):
    """GET /trace: the server's lifecycle events and the engine's spans in
    one Chrome trace."""
    import json
    from repro_torch.server import (ServerConfig, ServingServer, collect,
                                    fetch)
    eng = _engine(model, cap=4096)
    srv = ServingServer(ServerConfig(clock="virtual", warmup=False),
                        backend=eng, model_cfg=model[0].cfg)
    srv.start()
    try:
        evs = collect("127.0.0.1", srv.port,
                      {"prompt_len": 9, "max_tokens": 4})
        assert evs[-1][0] == "finish"
        status, text = fetch("127.0.0.1", srv.port, "/trace")
    finally:
        srv.shutdown(drain=False)
    assert status == 200
    out = json.loads(text)["traceEvents"]
    drawn = [e for e in out if e.get("cat") == "span"]
    calls = [e for e in drawn if e["name"] == "engine.prefill_call"]
    assert len(calls) == 1 and calls[0]["args"]["lengths"] == [9]
    assert {"engine.step", "model.prefill",
            "engine.decode_block"} <= {e["name"] for e in drawn}
    rid = calls[0]["args"]["rids"][0]
    assert any(e["ph"] == "X" and e.get("cat") != "span" and e["tid"] == rid
               for e in out)
