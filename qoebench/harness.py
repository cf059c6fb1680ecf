"""One run of one cell: set-up, a lead-in, the measured window, then the
check of what the window served.

The window drives ``ServingEngine.step()`` on the wall clock, as the
server's pump thread does, over requests submitted open-loop with their
due times. Every token, admission and finish is stamped on the harness's
own clock (``engine.wall_now()``, read inside the observer's hooks); the
hooks' own time arguments are not used. The engine paces and prices with
``LatencyModel(cfg, H100_ROOFLINE)``; the seconds it sleeps in ``_tick``
are recorded.
"""
from __future__ import annotations

import collections
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.observer import Observer

from qoebench import weights
from qoebench.frozen.hardware import hardware_spec

def log(msg: str) -> None:
    print(f"[qoebench] {msg}", file=sys.stderr, flush=True)


def model_config(cfgd: dict):
    """The port's ModelConfig of a configuration file's ``model`` block."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    m = dict(cfgd["model"])
    moe = m.pop("moe", None)
    if moe:
        m["moe"] = MoEConfig(num_experts=moe["num_experts"],
                             num_shared_experts=moe["num_shared_experts"],
                             top_k=moe["top_k"], d_expert=moe["d_expert"])
    return ModelConfig(name=cfgd["name"], source=cfgd["source"], **m)


class Stamps(Observer):
    """Stamps admissions, tokens and finishes on the harness's clock."""

    def __init__(self, clock):
        self.clock = clock
        self.emits: Dict[int, List[list]] = collections.defaultdict(list)
        self.admits: Dict[int, float] = {}
        self.finishes: Dict[int, float] = {}
        self.preempts: Dict[int, int] = collections.Counter()
        self.finish_order: List[int] = []

    def admit(self, req, t, *, replica=-1):
        self.admits[req.rid] = self.clock()

    def emit(self, req, t, k=1, *, replica=-1):
        self.emits[req.rid].append([self.clock(), int(k)])

    def finish(self, req, t, *, replica=-1):
        self.finishes[req.rid] = self.clock()
        self.finish_order.append(req.rid)

    def preempt(self, req, t, mode="swap", *, replica=-1):
        self.preempts[req.rid] += 1


class TickMeter:
    """Wraps the engine instance's ``_tick`` and records, on the engine's
    clock, when it slept and for how long."""

    def __init__(self, engine):
        self.engine = engine
        self.sleeps: List[tuple] = []
        inner = engine._tick

        def tick(seconds):
            w = time.monotonic() - engine._wall0
            gap = engine.now + seconds - w
            if engine.clock != "virtual" and gap > 0:
                self.sleeps.append((w, gap))
            return inner(seconds)

        engine._tick = tick

    def slept(self, t0: float, t1: float) -> float:
        return float(sum(g for w, g in self.sleeps if t0 <= w < t1))


def build(cfgd: dict, seed: int, device: str):
    """Model, weights, latency model, scheduler and engine of a config."""
    import torch
    from repro_torch.core.latency_model import LatencyModel
    from repro_torch.core.policies import make_scheduler
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine

    cfg = model_config(cfgd)
    dtype = getattr(torch, cfgd["dtype"])
    model = Model(cfg, device=device)
    params = weights.make_params(model.abstract_params(dtype), seed, device,
                                 dtype, cfgd.get("weights_std", 0.02))
    sv = cfgd["serving"]
    lat = LatencyModel(cfg, hardware_spec())
    sched = make_scheduler(sv["scheduler"], sv["pool_tokens"], lat)
    engine = ServingEngine(
        model, params, sched, lat, num_slots=sv["num_slots"],
        max_seq=sv["max_seq"], capacity_tokens=sv["pool_tokens"],
        preemption_mode=sv["preemption"], clock="wall", cache_dtype=dtype,
        page_size=sv["page_size"], device=device)
    return model, params, engine


def requests_of(trace):
    from repro_torch.core.qoe import QoESpec
    from repro_torch.core.request import Request
    return [Request(rid=t.rid, arrival=t.due, prompt_len=t.prompt_len,
                    spec=QoESpec(ttft=t.ttft, tds=t.tds),
                    output_len=t.output_len, prompt_tokens=t.prompt)
            for t in trace]


def warm_up(engine, cfgd: dict, mix: dict, seed: int) -> None:
    """Serve a small batch of the traffic's shapes before the clock that
    matters starts: one prompt per length bucket up to the mix's cap and,
    where the mix decodes, a group of 16 rows, each decoding two blocks
    (a mix of one-token requests asks for one token here too)."""
    from repro_torch.core.qoe import QoESpec
    from repro_torch.core.request import Request
    rng = np.random.default_rng(int(seed) % (1 << 63) + 1)
    vocab = cfgd["model"]["vocab_size"]
    lens, b = [], 16
    while b <= 1024:
        lens.append(b)
        b *= 2
    out = int(mix.get("output_len", 17))
    if out > 1:
        lens += [100] * 16
    engine.reset()
    for i, n in enumerate(lens):
        engine.submit(Request(
            rid=-(i + 1), arrival=0.0, prompt_len=n,
            spec=QoESpec(ttft=1.0, tds=5.0), output_len=out,
            prompt_tokens=rng.integers(0, vocab, n).astype(np.int32)))
    while engine.step():
        pass
    engine.reset()


def drive(engine, trace, mix: dict, seconds: float, t_start: float,
          tracer=None) -> dict:
    """Submit the trace (open loop: every request at its due time; closed
    loop: each client's first at 0 and its next when the last finishes),
    step through the lead-in and the window, and stop stepping once the
    engine's clock passes the window's end."""
    closed = mix["arrival"] == "closed"
    stamps = Stamps(engine.wall_now)
    engine.attach_observer(stamps)
    ticks = TickMeter(engine)
    if tracer is not None:
        tracer.install(engine)
    engine.reset()
    lead = float(mix["lead_in_s"])
    end = lead + float(seconds)
    sent, by_rid, client_of = [], {}, {}

    def send(t, due: float) -> None:
        t.due, t.in_window = float(due), due >= lead
        r = requests_of([t])[0]
        by_rid[t.rid] = r
        sent.append(t)
        engine.submit(r)

    if closed:
        queues = [list(q) for q in trace]
        for c, q in enumerate(queues):
            client_of[q[0].rid] = c
            send(q.pop(0), 0.0)
    else:
        for t in trace:
            send(t, t.due)
    seen = 0
    started = False
    snap: dict = {}
    kv_util: List[float] = []
    steps = 0
    while True:
        now = engine.wall_now()
        if now >= end:
            break
        if not started and now >= lead:
            started = True
            snap = dict(iterations=engine.iterations,
                        preemptions=engine.preemptions, t=now)
        if tracer is not None:
            tracer.tick(now)
            more = tracer.step(engine)
        else:
            more = engine.step()
        if started:
            steps += 1
            kv_util.append(engine.kv.utilization)
        if closed:
            while seen < len(stamps.finish_order):
                rid = stamps.finish_order[seen]
                seen += 1
                q = queues[client_of[rid]]
                if q:
                    client_of[q[0].rid] = client_of[rid]
                    send(q.pop(0), stamps.finishes[rid])
                    more = True
        if not more:
            rest = end - engine.wall_now()
            if rest > 0:
                time.sleep(rest)
            break
    stop = engine.wall_now()
    if tracer is not None:
        tracer.close(stop)
    if not started:
        snap = dict(iterations=engine.iterations,
                    preemptions=engine.preemptions, t=stop)
    setup_s = engine._wall0 + lead - t_start
    requests = []
    for t in sent:
        requests.append(dict(
            rid=t.rid, due=t.due, prompt_len=t.prompt_len,
            output_len=t.output_len, ttft=t.ttft, tds=t.tds,
            in_window=t.in_window, emits=stamps.emits.get(t.rid, []),
            admit=stamps.admits.get(t.rid), finish=stamps.finishes.get(t.rid),
            preemptions=stamps.preempts.get(t.rid, 0)))
    admitted = sum(1 for r in requests
                   if r["admit"] is not None and lead <= r["admit"] < end)
    record = dict(
        window=[lead, end], seconds=float(seconds), lead_in_s=lead,
        stopped_at=stop, setup_s=setup_s, requests=requests,
        steps=steps, kv_util=kv_util,
        iterations=engine.iterations - snap["iterations"],
        preemptions=engine.preemptions - snap["preemptions"],
        admitted=admitted,
        tick_sleep_s=ticks.slept(lead, end),
        tick_sleep_lead_s=ticks.slept(0.0, lead),
        swaps_out_total=engine.kv.swaps_out_total,
        peak_kv_util=engine.kv.peak_utilization,
    )
    record["failed"] = sorted(rid for rid, r in by_rid.items()
                              if r.cancelled)
    record["_served"] = {rid: (np.asarray(r.prompt_tokens, np.int32),
                               list(r.output_tokens),
                               stamps.finishes.get(rid) is not None)
                         for rid, r in by_rid.items()
                         if r.output_tokens}
    stamps.clock = None
    return record


def sample_served(record: dict, check: dict, seed: int) -> List[dict]:
    """The requests the check compares, drawn from the seed among those the
    run finished: the one with the most served tokens (of those, the
    longest prompt), up to
    ``check["preempted"]`` that were preempted and resumed, the rest at
    random, ``check["sample"]`` in all (topped up with unfinished ones,
    on what they were served, only if too few finished)."""
    served = record["_served"]
    rng = np.random.default_rng(int(seed) % (1 << 63) + 2)
    rids = sorted(i for i in served if served[i][2])
    if len(rids) < int(check["sample"]):
        extra = sorted(i for i in served if not served[i][2])
        rng.shuffle(extra)
        rids = sorted(rids + extra[: int(check["sample"]) - len(rids)])
    if not rids:
        return []
    by = {r["rid"]: r for r in record["requests"]}
    chosen = [max(rids, key=lambda i: (len(served[i][1]), len(served[i][0]),
                                       -i))]
    pre = [i for i in rids if by[i]["preemptions"] and i not in chosen]
    rng.shuffle(pre)
    chosen += pre[: int(check.get("preempted", 2))]
    rest = [i for i in rids if i not in chosen]
    rng.shuffle(rest)
    chosen += rest[: max(int(check["sample"]) - len(chosen), 0)]
    return [dict(rid=i, prompt=served[i][0], served=served[i][1],
                 preempted=bool(by[i]["preemptions"])) for i in chosen]


def check_served(cfgd: dict, params, sample: List[dict], device: str,
                 quant: Optional[str] = None) -> dict:
    """Widest logit gap of the served tokens under the float32 reference
    (and of the control's first choices, with `quant`)."""
    from qoebench.reference.model import served_gaps
    out = served_gaps(cfgd["model"], params, sample, quant=quant,
                      device=device)
    gaps = np.concatenate([o["served"] for o in out])
    res = {"widest_gap": float(gaps.max()),
           "flip_share": float(np.mean(gaps > 0)),
           "mean_gap": float(gaps.mean()),
           "tokens": int(gaps.size), "requests": len(out),
           "preempted": int(sum(s["preempted"] for s in sample)),
           "per_request": [[len(s["prompt"]), len(s["served"]),
                            float(o["served"].max()),
                            int(o["served"].argmax()),
                            int(np.sum(o["served"] > 0.1))]
                           for s, o in zip(sample, out)]}
    if quant:
        c = np.concatenate([o["control"] for o in out])
        res.update(control_widest_gap=float(c.max()),
                   control_flip_share=float(np.mean(c > 0)),
                   control_mean_gap=float(c.mean()))
    return res


def free_device_memory() -> None:
    """Return what the dropped program state held to the card."""
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
