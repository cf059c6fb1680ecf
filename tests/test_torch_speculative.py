"""Speculative decoding in the port against the JAX reference (CPU, f32).

Foundations first, as the reference's ``tests/test_speculative.py``
orders them: ``Model.verify_step`` is bitwise the same decode steps
taken one by one (within the port), its logits equal the JAX
``verify_step``'s to 2e-5, and ``propose_step``'s greedy ids equal the
JAX ones. Then the refusals: speculation is dense-only with a shared
vocab (ssm, hybrid, moe and a vocab mismatch raise), and the engine
refuses ``physical_pages=True``, ``prefill_chunk`` and a missing draft.

The engine against the JAX speculative engine for the exact, perturbed
and foreign drafts at k = 3 (k = 1 and 2 in
``test_torch_speculative_engine.py``): identical timing fingerprints,
tokens and acceptance counters, with any token flip classified by
``audit_flips``.

Within the port: spec ≡ non-spec token for token for every draft; k = 0
is the baseline engine bit for bit; the exact draft commits k+1 tokens a
round; requests that walk up to ``max_seq`` stay lossless; a forced swap
round trip parks and restores the target and draft slices bitwise
(stale rejected-draft entries included) and finishes token-exact, a
forced recompute continues as a non-spec engine preempted at the same
point does; the block of rounds equals single rounds bit for bit, with
and without an EOS landing inside a block; a rerun reproduces itself.

The shared set-up of the speculative differentials lives here too
(``test_torch_speculative_engine.py`` and
``test_torch_speculative_cluster.py`` import it): the llama3-8b smoke
target and its three drafts in both packages, the engine trace, and one
engine of each kind over it. Drafts, as the reference's
``tests/test_speculative.py`` builds them (made in JAX, carried to the
port with ``bridge.from_numpy``): exact (the target's own params),
perturbed (params + 1e-3 * normal(PRNGKey(9))) and foreign (a 1-layer
d-128 model, 4/2 heads, d_ff 256, from PRNGKey(7), same vocab). The trace
is the engine tests': 12 requests with staggered arrivals, EOS off, 4
slots, max_seq 64, Andes with delta_t 2 s and a KV capacity of 100
tokens, so requests preempt (swap unless a test says otherwise).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import QoESpec as JSpec
from repro.core import SchedulerConfig as JSchedCfg
from repro.core import SpeculativeLatencyModel as JSpecLat
from repro.core import TPU_V5E as J_TPU_V5E
from repro.core import make_scheduler as j_make_scheduler
from repro.models import Model as JModel
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving import all_flips_documented, audit_flips
from repro.serving import timing_fingerprint as j_timing
from repro_torch.bridge import from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core import (TPU_V5E, LatencyModel, QoESpec,
                              SchedulerConfig, SpeculativeLatencyModel,
                              make_scheduler)
from repro_torch.models import Model
from repro_torch.serving import (HotpathConfig, ReqState, Request,
                                 ServingEngine, check_speculation_compatible,
                                 timing_fingerprint)
from repro_torch.serving.engine import _read_slot

torch.set_num_threads(1)
VERIFY_TOL = 2e-5
CAP = 100
DELTA_T = 2.0
DRAFTS = ("exact", "perturbed", "foreign")
STATS = ("host_syncs", "dispatches", "multi_step_blocks", "multi_step_iters",
         "persistent_blocks", "persistent_iters", "prefill_shapes")
_CACHE = {}


# ---------------------------------------------------------------------------
# shared set-up (also imported by the other speculative test files)
# ---------------------------------------------------------------------------

def _small(cfg):
    return dataclasses.replace(cfg, name="llama3-8b-smoke-draft",
                               num_layers=1, d_model=128, num_heads=4,
                               num_kv_heads=2, d_ff=256)


def setup():
    """-> dict(cfg, jm, jp, tm, tp, drafts={name: ((jdm, jdp), (tdm,
    tdp))}), built once per process."""
    if "setup" not in _CACHE:
        cfg = j_smoke("llama3-8b")
        jm = JModel(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = Model(get_smoke_config("llama3-8b"), device="cpu")

        def carry(p):
            return from_numpy(jax.tree.map(np.asarray, p), device="cpu")

        tp = carry(jp)
        pert = jax.tree.map(lambda a: a + 1e-3 * jax.random.normal(
            jax.random.PRNGKey(9), a.shape, a.dtype), jp)
        jsm = JModel(_small(cfg))
        jsp = jsm.init(jax.random.PRNGKey(7))
        tsm = Model(_small(tm.cfg), device="cpu")
        _CACHE["setup"] = dict(
            cfg=cfg, jm=jm, jp=jp, tm=tm, tp=tp,
            drafts={"exact": ((jm, jp), (tm, tp)),
                    "perturbed": ((jm, pert), (tm, carry(pert))),
                    "foreign": ((jsm, jsp), (tsm, carry(jsp)))})
    return _CACHE["setup"]


def trace(make, spec, vocab, n=12, out_len=14, stagger=0.01, seed=0,
          plen=(5, 30)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen_i = int(rng.integers(*plen))
        out.append(make(rid=i, arrival=i * stagger, prompt_len=plen_i,
                        output_len=out_len, spec=spec(ttft=1.0, tds=4.8),
                        prompt_tokens=rng.integers(0, vocab, plen_i)))
    return out


def jax_spec_engine(draft, k, **kw):
    s = setup()
    dm, dp = s["drafts"][draft][0]
    lat = JSpecLat(s["cfg"], J_TPU_V5E, dm.cfg, k=k)
    sched = j_make_scheduler("andes", CAP, lat, JSchedCfg(delta_t=DELTA_T))
    return JEngine(s["jm"], s["jp"], sched, lat, num_slots=4, max_seq=64,
                   capacity_tokens=CAP, draft_model=dm, draft_params=dp,
                   spec_k=k, **kw)


def torch_spec_engine(draft, k, *, sched="andes", cap=CAP, **kw):
    s = setup()
    dm, dp = s["drafts"][draft][1]
    tm = s["tm"]
    lat = SpeculativeLatencyModel(tm.cfg, TPU_V5E, dm.cfg, k=k)
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_seq", 64)
    return ServingEngine(tm, s["tp"], make_scheduler(
        sched, cap, lat, SchedulerConfig(delta_t=DELTA_T)), lat,
        capacity_tokens=cap, draft_model=dm, draft_params=dp, spec_k=k,
        device="cpu", reference_decode=True, **kw)


def torch_base_engine(*, sched="andes", cap=CAP, **kw):
    s = setup()
    tm = s["tm"]
    lat = LatencyModel(tm.cfg, TPU_V5E)
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_seq", 64)
    return ServingEngine(tm, s["tp"], make_scheduler(
        sched, cap, lat, SchedulerConfig(delta_t=DELTA_T)), lat,
        capacity_tokens=cap, device="cpu", reference_decode=True, **kw)


def run_jax(eng, **tr):
    vocab = setup()["cfg"].vocab_size
    return eng.run(trace(JRequest, JSpec, vocab, **tr), max_iterations=4000)


def run_torch(eng, **tr):
    vocab = setup()["cfg"].vocab_size
    return eng.run(trace(Request, QoESpec, vocab, **tr), max_iterations=4000)


def assert_matches_reference(jout, jeng, tout, teng):
    """Tokens identical except for flips `audit_flips` (the JAX target as
    referee) classifies as documented near-ties. Without a flip the timing
    fingerprint, preemptions, acceptance counters and hot-path counters
    must be identical. A flip changes what the draft sees next, so it may
    move acceptance and with it the virtual clock: then only the flips'
    classification is asserted, and the run's summary says so."""
    s = setup()
    assert all(r.generated == r.output_len for r in tout)
    flips = audit_flips(s["jm"], s["jp"], jout, tout)
    assert all_flips_documented(flips), flips
    if flips:
        print(f"near-tie flips {flips}: acceptance {teng.spec_stats()} "
              f"(port) vs {jeng.spec_stats()} (reference)")
        return flips
    assert timing_fingerprint(tout) == j_timing(jout)
    assert teng.preemptions == jeng.preemptions
    assert teng.spec_stats() == jeng.spec_stats()
    stats, jstats = teng.hotpath_stats(), jeng.hotpath_stats()
    for key in STATS:
        assert stats[key] == jstats[key], key
    return flips


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _prefilled(tm, tp, jm=None, jp=None):
    """A B=3 cache prefilled with 12 prompt tokens per row, in the port
    (and in JAX when given), and a random 4-token window."""
    rng = np.random.default_rng(3)
    vocab = tm.cfg.vocab_size
    prompt = rng.integers(0, vocab, (3, 12)).astype(np.int32)
    window = rng.integers(0, vocab, (3, 4)).astype(np.int32)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)},
                       tm.init_cache(3, 64))
    jc = None
    if jm is not None:
        _, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt)},
                           jm.init_cache(3, 64))
    return tc, jc, window


# ---------------------------------------------------------------------------
# foundations
# ---------------------------------------------------------------------------

def test_verify_step_bitwise_matches_sequential_decode():
    s = setup()
    tm, tp = s["tm"], s["tp"]
    cache, _, window = _prefilled(tm, tp)
    seq = {k: v.clone() for k, v in cache.items()}
    fused, fused_cache = tm.verify_step(tp, torch.from_numpy(window),
                                        {k: v.clone() for k, v in
                                         cache.items()})
    steps = []
    for j in range(window.shape[1]):
        lg, seq = tm.decode_step(tp, torch.from_numpy(window[:, j]), seq)
        steps.append(lg)
    assert torch.equal(fused, torch.stack(steps, dim=1))
    for key in fused_cache:
        assert torch.equal(fused_cache[key], seq[key]), key


def test_verify_step_matches_reference():
    s = setup()
    tc, jc, window = _prefilled(s["tm"], s["tp"], s["jm"], s["jp"])
    jl, jc = s["jm"].verify_step(s["jp"], jnp.asarray(window), jc)
    tl, tc = s["tm"].verify_step(s["tp"], torch.from_numpy(window), tc)
    assert tl.shape == (3, 4, s["cfg"].vocab_size)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=VERIFY_TOL, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]),
                                   atol=VERIFY_TOL, rtol=0)
    np.testing.assert_array_equal(_np(tc["length"]), _np(jc["length"]))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("draft", DRAFTS)
def test_propose_step_matches_reference(draft, k):
    s = setup()
    (jdm, jdp), (tdm, tdp) = s["drafts"][draft]
    tc, jc, window = _prefilled(tdm, tdp, jdm, jdp)
    last = window[:, 0]
    jids, jc = jdm.propose_step(jdp, jnp.asarray(last), jc, k)
    tids, tc = tdm.propose_step(tdp, torch.from_numpy(last), tc, k)
    assert tids.dtype == torch.int32 and tids.shape == (3, k + 1)
    np.testing.assert_array_equal(_np(tids), _np(jids))
    np.testing.assert_array_equal(_np(tc["length"]), 12 + k + 1)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("other", ["falcon-mamba-7b", "zamba2-2.7b",
                                   "qwen2-moe-a2.7b", "vocab"])
def test_speculation_rejects_unsupported(other):
    tm = setup()["tm"]
    if other == "vocab":
        m = Model(dataclasses.replace(tm.cfg,
                                      vocab_size=tm.cfg.vocab_size * 2),
                  device="cpu")
        match = "vocab"
    else:
        m = Model(get_smoke_config(other), device="cpu")
        match = "dense"
    with pytest.raises(ValueError, match=match):
        check_speculation_compatible(tm, m)
    if other != "vocab":
        with pytest.raises(ValueError, match=match):
            check_speculation_compatible(m, tm)


@pytest.mark.parametrize("kw,match", [
    (dict(page_size=16, physical_pages=True), "physical_pages"),
    (dict(prefill_chunk=8), "chunked prefill"),
    (dict(draft_params=None), "draft_model"),
], ids=["physical-pages", "prefill-chunk", "missing-draft"])
def test_spec_engine_refusals(kw, match):
    s = setup()
    if "draft_params" in kw:
        with pytest.raises(ValueError, match=match):
            torch_base_engine(spec_k=2, draft_model=s["tm"])
        return
    with pytest.raises(ValueError, match=match):
        torch_spec_engine("exact", 2, **kw)
    # a paged spec engine falls back to page accounting, as the reference
    if "page_size" in kw:
        eng = torch_spec_engine("exact", 2, page_size=16)
        assert not eng.physical_pages and eng.kv.paged


# ---------------------------------------------------------------------------
# against the reference engine, k = 3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", DRAFTS)
def test_spec_engine_matches_reference(draft):
    jeng = jax_spec_engine(draft, 3)
    jout = run_jax(jeng)
    teng = torch_spec_engine(draft, 3)
    tout = run_torch(teng)
    assert teng.preemptions > 0, "the trace must preempt"
    assert teng.multi_step_blocks > 0 or draft == "foreign"
    assert_matches_reference(jout, jeng, tout, teng)
    assert teng.kv.tokens_used == 0
    assert not teng.kv.host_store and not teng.kv.draft_store


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------

def _uncontended(eng_fn, *a, **kw):
    return eng_fn(*a, sched="fcfs", cap=10_000, **kw)


def _tokens(out):
    return [r.output_tokens for r in out]


@pytest.mark.parametrize("draft", DRAFTS)
def test_spec_matches_nonspec_tokens(draft):
    base = _uncontended(torch_base_engine)
    base_out = run_torch(base, n=4, out_len=10, stagger=0.05, seed=1)
    spec = _uncontended(torch_spec_engine, draft, 3)
    spec_out = run_torch(spec, n=4, out_len=10, stagger=0.05, seed=1)
    assert _tokens(spec_out) == _tokens(base_out)
    assert all(r.generated == r.output_len for r in spec_out)
    assert spec.iterations <= base.iterations
    if spec.spec_stats()["accepted"]:
        assert spec.iterations < base.iterations


def test_draft_equals_target_is_full_acceptance():
    """The reference test's trace (prompts 5-19 tokens): every proposal
    verifies. Full acceptance is not guaranteed by construction — the
    draft holds committed[:-1], so it computes the last committed token
    one position below the target, whose prefill left padding k/v at the
    prompt's end — and on the engine trace (prompts 5-29) the exact draft
    accepts 26 of 27 in both packages (test_spec_engine_matches_reference
    [exact] pins the counts to the reference's)."""
    k = 3
    tr = dict(n=3, out_len=12, stagger=0.0, seed=2, plen=(5, 20))
    base = _uncontended(torch_base_engine)
    base_out = run_torch(base, **tr)
    spec = _uncontended(torch_spec_engine, "exact", k)
    spec_out = run_torch(spec, **tr)
    assert _tokens(spec_out) == _tokens(base_out)
    assert spec.spec_stats()["acceptance_rate"] == 1.0
    # 12 tokens = 1 at prefill + 11 decoded, k+1 = 4 a round: 3 rounds
    assert spec.iterations == max(-(-(r.output_len - 1) // (k + 1))
                                  for r in spec_out)


def test_spec_k0_reduces_to_baseline():
    base = _uncontended(torch_base_engine)
    base_out = run_torch(base, n=3, out_len=8, seed=4)
    k0 = _uncontended(torch_base_engine, spec_k=0)
    k0_out = run_torch(k0, n=3, out_len=8, seed=4)
    for a, b in zip(base_out, k0_out):
        assert a.output_tokens == b.output_tokens
        assert a.emit_times == b.emit_times
        assert a.final_qoe() == b.final_qoe()
    assert (base.iterations, base.now) == (k0.iterations, k0.now)
    assert k0.draft is None and k0._cache_seq == 64


@pytest.mark.parametrize("draft,k", [("exact", 3), ("perturbed", 4)])
def test_spec_lossless_at_max_seq_boundary(draft, k):
    """Contexts walk up to max_seq: the last windows cross it, where the
    cache's k+1 slack keeps every write unclamped and emission stops at
    the logical max_seq."""
    max_seq = 48
    vocab = setup()["cfg"].vocab_size
    rng = np.random.default_rng(13)
    proto = [Request(rid=i, arrival=0.0, prompt_len=p, output_len=14,
                     spec=QoESpec(ttft=1.0, tds=4.8),
                     prompt_tokens=rng.integers(0, vocab, p))
             for i, p in enumerate((max_seq - 14, max_seq - 15))]
    base = _uncontended(torch_base_engine, max_seq=max_seq)
    base_out = base.run([r.clone() for r in proto], max_iterations=200)
    spec = _uncontended(torch_spec_engine, draft, k, max_seq=max_seq)
    assert spec._cache_seq == max_seq + k + 1
    spec_out = spec.run([r.clone() for r in proto], max_iterations=200)
    assert _tokens(spec_out) == _tokens(base_out)
    for r in spec_out:
        assert r.prompt_len + r.generated <= max_seq


def _start_running(eng, r, steps=2):
    eng.submit(r)
    for _ in range(steps):
        assert eng.step()
    assert r.state == ReqState.RUNNING and r.generated > 0
    return r.engine_slot


def _slices_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _one_request(seed, out_len):
    vocab = setup()["cfg"].vocab_size
    rng = np.random.default_rng(seed)
    return Request(rid=0, arrival=0.0, prompt_len=12, output_len=out_len,
                   spec=QoESpec(ttft=1.0, tds=4.8),
                   prompt_tokens=rng.integers(0, vocab, 12))


def test_spec_swap_roundtrip_preserves_both_caches():
    """A forced swap mid-stream parks the target and draft slices bit for
    bit (rejected-draft entries past the committed length included), they
    come back bit for bit, and the request finishes with the baseline's
    tokens."""
    ref = _one_request(10, 20)
    _uncontended(torch_base_engine).run([ref], max_iterations=100)
    eng = _uncontended(torch_spec_engine, "perturbed", 2,
                       preemption_mode="swap")
    r = ref.clone()
    r.output_tokens, r.emit_times, r.generated = [], [], 0
    slot = _start_running(eng, r)
    assert eng.spec_steps > 0 and eng.spec_accepted < eng.spec_proposed
    before_t = _read_slot(eng.cache, slot)
    before_d = eng.draft.park(slot)
    used = eng.kv.tokens_used
    eng._preempt(r)
    assert r.state == ReqState.SWAPPED
    assert eng.kv.tokens_used == used - r.context_len
    assert _slices_equal(eng.kv.host_store[r.rid], before_t)
    assert _slices_equal(eng.kv.draft_store[r.rid], before_d)
    eng._swap_in(r)
    assert r.rid not in eng.kv.host_store and r.rid not in eng.kv.draft_store
    assert _slices_equal(_read_slot(eng.cache, r.engine_slot), before_t)
    assert _slices_equal(eng.draft.park(r.engine_slot), before_d)
    while eng.step():
        pass
    assert r.output_tokens == ref.output_tokens
    assert eng.kv.tokens_used == 0


def test_spec_recompute_matches_nonspec_recompute():
    """A forced recompute mid-stream continues as a non-spec engine
    preempted at the same generated count does (the draft's parked state
    is dropped, not parked)."""
    proto = _one_request(12, 18)
    spec = _uncontended(torch_spec_engine, "perturbed", 2,
                        preemption_mode="recompute")
    r_spec = proto.clone()
    spec.submit(r_spec)
    while r_spec.generated < 6:
        assert spec.step()
    cut = r_spec.generated
    spec._preempt(r_spec)
    assert not r_spec.prefilled and r_spec.rid not in spec.kv.draft_store
    while spec.step():
        pass
    base = _uncontended(torch_base_engine, preemption_mode="recompute")
    r_ref = proto.clone()
    base.submit(r_ref)
    while r_ref.generated < cut:
        assert base.step()
    assert r_ref.output_tokens == r_spec.output_tokens[:cut]
    base._preempt(r_ref)
    while base.step():
        pass
    assert r_spec.output_tokens == r_ref.output_tokens
    assert r_spec.generated == r_spec.output_len


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_spec_preemption_pressure(mode):
    """Andes and a tight KV budget preempt speculative requests (and
    their draft caches) mid-stream; in swap mode the streams equal an
    uncontended baseline's, in both modes the port equals itself rerun
    and releases everything, draft parking included."""
    base = _uncontended(torch_base_engine, num_slots=8)
    base_out = run_torch(base, n=8, out_len=15, seed=5)
    runs = []
    for _ in range(2):
        spec = torch_spec_engine("perturbed", 2, num_slots=2,
                                 preemption_mode=mode)
        out = run_torch(spec, n=8, out_len=15, seed=5)
        assert spec.preemptions > 0, "the trace must preempt"
        assert spec.kv.tokens_used == 0
        assert not spec.kv.host_store and not spec.kv.draft_store
        runs.append([(r.output_tokens, r.emit_times) for r in out])
    assert runs[0] == runs[1]
    if mode == "swap":
        assert [t for t, _ in runs[0]] == _tokens(base_out)


def _block_vs_single(eos_id=-1):
    res = {}
    for name, hp in (("block", HotpathConfig(multi_step=8)),
                     ("single", HotpathConfig(multi_step=8,
                                              persistent=False))):
        eng = torch_spec_engine("perturbed", 2, num_slots=8, cap=8 * 64,
                                eos_id=eos_id, hotpath=hp)
        out = run_torch(eng, n=8, out_len=18, stagger=0.05, seed=11)
        res[name] = ([(r.output_tokens, r.emit_times, r.preemptions)
                      for r in out], eng)
    return res


def test_spec_block_equals_single_round():
    res = _block_vs_single()
    assert res["block"][0] == res["single"][0]
    eb, es = res["block"][1], res["single"][1]
    assert eb.persistent_blocks > 0 and es.persistent_blocks == 0
    assert eb.host_syncs < es.host_syncs


def test_spec_block_eos_truncation():
    probe = _block_vs_single()["single"][0]
    mid = [t for toks, _, _ in probe for t in toks[2:-2]]
    eos = int(np.bincount(np.asarray(mid)).argmax())
    res = _block_vs_single(eos_id=eos)
    assert any(toks and toks[-1] == eos and len(toks) < 18
               for toks, _, _ in res["single"][0]), "EOS never fired"
    assert res["block"][0] == res["single"][0]
    assert res["block"][1].persistent_blocks > 0


def test_spec_rerun_is_reproducible():
    """reset() restores the acceptance EMA to its prior, so a second run()
    clocks and schedules as the first."""
    spec = torch_spec_engine("perturbed", 3)
    runs = []
    for _ in range(2):
        out = run_torch(spec, n=3, out_len=10, seed=14)
        runs.append(([r.output_tokens for r in out],
                     [r.emit_times for r in out], spec.now))
    assert runs[0] == runs[1]


def test_trace_helper_is_the_engine_tests_trace():
    """The shared trace matches the other engine differentials'."""
    vocab = setup()["cfg"].vocab_size
    a = trace(Request, QoESpec, vocab)
    assert len(a) == 12 and a[3].arrival == pytest.approx(0.03)
    assert all(5 <= r.prompt_len < 30 and r.output_len == 14 for r in a)
