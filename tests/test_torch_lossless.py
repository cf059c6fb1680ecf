"""The engine-layout flip referee against the engines it replays (CPU, f32).

``serving.lossless.engine_margin`` replays a request along an engine's
own layout at batch 1 — the prompt prefilled as the engine prefills it
(padded to its length bucket, or at its exact length on the eager hot
path), then one decode step per committed token where the engine pins
the row (``decode_length``) — and ``audit_flips(..., engine=)`` classifies flips by that
margin. A referee is only as good as its replay, so here the port's
engine and the JAX reference engine serve one trace at one slot (every
prefill and decode at batch 1, the replay's shape) with capacity to
spare (no preemption): the two engines emit the same tokens, and at
every emitted position the replay's logits are bitwise those the port's
engine computed there (its prefill and decode calls recorded in order)
and its greedy token is the one both engines emitted, over the bucketed
prefill and over the eager one. The audit record keeps the exact-length
margin beside the engine-layout one and classifies by the latter.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import LatencyModel as JLat
from repro.core import QoESpec as JSpec
from repro.core import SchedulerConfig as JSchedCfg
from repro.core import TPU_V5E as J_TPU_V5E
from repro.core import make_scheduler as j_make_scheduler
from repro.models import Model as JModel
from repro.serving import HotpathConfig as JHotpath
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.bridge import from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core import (TPU_V5E, LatencyModel, QoESpec,
                              SchedulerConfig, make_scheduler)
from repro_torch.models import Model
from repro_torch.serving import (HotpathConfig, Request, ServingEngine,
                                 audit_flips, classify_flip, engine_margin,
                                 exact_margin)
from repro_torch.serving.lossless import _engine_logits

torch.set_num_threads(1)
CAP = 1024          # KV capacity (tokens): nothing preempts
N_REQ = 5
OUT_LEN = 10


@pytest.fixture(scope="module")
def models():
    cfg = j_smoke("llama3-8b")
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config("llama3-8b"), device="cpu")
    tp = from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _trace(make, spec, vocab):
    rng = np.random.default_rng(3)
    out = []
    for i in range(N_REQ):
        plen = int(rng.integers(5, 30))
        out.append(make(rid=i, arrival=i * 0.01, prompt_len=plen,
                        output_len=OUT_LEN, spec=spec(ttft=1.0, tds=4.8),
                        prompt_tokens=rng.integers(0, vocab, plen)))
    return out


def _hot(cls, eager):
    return cls.baseline() if eager else None


def _run_jax(jm, jp, cfg, eager):
    lat = JLat(cfg, J_TPU_V5E)
    sched = j_make_scheduler("andes", CAP, lat, JSchedCfg(delta_t=2.0))
    eng = JEngine(jm, jp, sched, lat, num_slots=1, max_seq=64,
                  capacity_tokens=CAP, hotpath=_hot(JHotpath, eager))
    return eng.run(_trace(JRequest, JSpec, cfg.vocab_size),
                   max_iterations=4000)


def _run_torch(tm, tp, eager, rows=None, reference=True):
    """The port's engine at one slot, in the reference's decode layout
    (`reference`) or its own; with `rows`, the logits of every prefill
    and decode call it makes are appended there, in order."""
    lat = LatencyModel(tm.cfg, TPU_V5E)
    sched = make_scheduler("andes", CAP, lat, SchedulerConfig(delta_t=2.0))
    if rows is not None:
        for name in ("prefill", "decode_step"):
            def recorded(*a, _f=getattr(tm, name), **k):
                logits, cache = _f(*a, **k)
                rows.append(logits[0].clone())
                return logits, cache
            setattr(tm, name, recorded)
    try:
        eng = ServingEngine(tm, tp, sched, lat, num_slots=1, max_seq=64,
                            capacity_tokens=CAP,
                            hotpath=_hot(HotpathConfig, eager), device="cpu",
                            reference_decode=reference)
        out = eng.run(_trace(Request, QoESpec, tm.cfg.vocab_size),
                      max_iterations=4000)
    finally:
        if rows is not None:
            del tm.prefill, tm.decode_step
    return out, eng


@pytest.mark.parametrize("eager", [False, True], ids=["bucketed", "eager"])
def test_replay_reproduces_both_engines(models, eager):
    """At one slot the engine computes each emitted position once, at
    batch 1: the replay's logits are the engine's, bitwise, and its greedy
    token is the one both engines emitted."""
    cfg, jm, jp, tm, tp = models
    jout = _run_jax(jm, jp, cfg, eager)
    rows = []
    tout, eng = _run_torch(tm, tp, eager, rows)
    assert eng.preemptions == 0
    assert [r.output_tokens for r in tout] == \
        [r.output_tokens for r in jout]
    assert len(rows) == N_REQ * OUT_LEN
    seen = iter(rows)
    for r in sorted(tout, key=lambda r: r.emit_times[0]):
        assert r.generated == OUT_LEN
        for p, tok in enumerate(r.output_tokens):
            row = _engine_logits(eng, r.prompt_tokens, r.output_tokens[:p])
            assert torch.equal(row, next(seen)), (r.rid, p)
            assert int(torch.argmax(row)) == tok, (r.rid, p)


@pytest.mark.parametrize("eager", [False, True], ids=["bucketed", "eager"])
def test_replay_follows_the_default_engines_layout(models, eager):
    """The engine's own decode layout (each row pinned at its last
    committed position): the replay's logits are still the engine's,
    bitwise, at every emitted position."""
    _, _, _, tm, tp = models
    rows = []
    out, eng = _run_torch(tm, tp, eager, rows, reference=False)
    assert eng.decode_length(10) == 9
    seen = iter(rows)
    for r in sorted(out, key=lambda r: r.emit_times[0]):
        for p, tok in enumerate(r.output_tokens):
            row = _engine_logits(eng, r.prompt_tokens, r.output_tokens[:p])
            assert torch.equal(row, next(seen)), (r.rid, p)
            assert int(torch.argmax(row)) == tok, (r.rid, p)


def test_audit_classifies_by_the_engine_margin(models):
    _, _, _, tm, tp = models
    out, eng = _run_torch(tm, tp, False)
    r = out[2]
    pos = 4
    prefix = r.output_tokens[:pos]
    flipped = (r.output_tokens[pos] + 1) % tm.cfg.vocab_size
    other = types.SimpleNamespace(
        rid=r.rid, prompt_tokens=r.prompt_tokens,
        output_tokens=prefix + [flipped] + r.output_tokens[pos + 1:])
    m_eng = engine_margin(eng, r.prompt_tokens, prefix)
    m_exact = exact_margin(tm, tp, r.prompt_tokens, prefix)
    assert m_eng > 0 and m_exact > 0
    tol = 0.5 * (m_eng + m_exact)       # between the two margins
    (rec,) = audit_flips(tm, tp, [r], [other], tol=tol, engine=eng)
    assert rec["rid"] == r.rid and rec["position"] == pos
    assert rec["margin"] == m_eng and rec["exact_margin"] == m_exact
    assert rec["classification"] == classify_flip(m_eng, tol)
    (plain,) = audit_flips(tm, tp, [r], [other], tol=tol)
    assert plain["margin"] == m_exact and "exact_margin" not in plain
    assert plain["classification"] == classify_flip(m_exact, tol)
    assert plain["classification"] != rec["classification"] or \
        m_eng == m_exact
