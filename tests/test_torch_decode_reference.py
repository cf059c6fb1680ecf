"""The port's engine against the benchmark's plain float32 reference
(``qoebench/reference/model.py``: a causal language model over the prompt
and the served tokens, no cache, no batching) on the CPU at smoke size.

Every token the engine serves must be the reference's first choice at
its position, on each decode path (one step, with and without the fused
argmax; ``decode_multi``'s power-of-two blocks; the persistent blocks;
speculative rounds and blocks of rounds), over the contiguous cache and
the page pool, through swap and recompute preemption. The reference
setting (``reference_decode=True``: each row pinned one past its last
committed position, as the JAX engine pins it) serves other tokens, which
the same check catches.

The other kinds' default engines are held the same way to the port's own
cache-free forward (``Model.forward_train`` over the prompt and the
served tokens, with the request's encoder frames): the hybrid (zamba2:
Mamba-2 beside a shared attention block), the pure SSM (falcon-mamba),
the encoder-decoder (seamless-m4t) and the vision-language model
(pixtral). The engine serves a vlm text only; a vlm prompt behind an
image's patches is held at the model, each decode row pinned where the
engine pins it.

A moe engine's decode routes only its live rows, at one slot per live row
and expert: no slot drops, and each decoded token is routed as a call of
its own, as the reference routes it, whatever the batch's empty slots
hold.

Tolerance: ``GAP_TOL`` = 1e-4 on the widest logit gap (the reference's
best logit less the served token's). Both sides compute in float32 and
differ only in the order of their sums: the smoke models' logits are of
order 1-10, so rounding moves them by ~1e-6; a served token that is not
the reference's choice lies below it by the smoke models' typical gap
between candidates, ~1e-2 and up.
"""
import numpy as np
import pytest
import torch

from qoebench import harness, smoke, weights
from qoebench.reference.model import served_gaps
from repro_torch.configs import get_smoke_config
from repro_torch.core import (TPU_V5E, LatencyModel, QoESpec,
                              SchedulerConfig, make_scheduler)
from repro_torch.models import Model
from repro_torch.models import cache as cache_lib
from repro_torch.models import moe as moe_lib
from repro_torch.serving import (HotpathConfig, Request, ServingEngine,
                                 synthetic_frames, synthetic_patches)
from repro_torch.serving.engine import frames_row

torch.set_num_threads(2)
GAP_TOL = 1e-4
SEED = 11
TINY_MOE = dict(smoke.TINY["tiny-moe"], moe={
    "num_experts": 8, "num_shared_experts": 1, "top_k": 2, "d_expert": 128,
    "capacity_factor": 1.25})


def _setup(model_cfg, name):
    cfgd = {"name": name, "source": "smoke", "model": model_cfg}
    model = Model(harness.model_config(cfgd), device="cpu")
    params = weights.make_params(model.abstract_params(torch.float32), SEED,
                                 "cpu", torch.float32, 0.1)
    return model_cfg, model, params


@pytest.fixture(scope="module")
def dense():
    return _setup(smoke.TINY["tiny-dense"], "tiny-dense")


@pytest.fixture(scope="module")
def moe():
    return _setup(TINY_MOE, "tiny-moe-8x2")


def _trace(vocab, n=6, out=14, stagger=0.01, seed=0):
    rng = np.random.default_rng(seed)
    lens = [5, 16, 17, 31, 64, 100, 9, 40][:n]
    return [Request(rid=i, arrival=i * stagger, prompt_len=p,
                    output_len=out + 3 * (i % 3),
                    spec=QoESpec(ttft=1.0, tds=4.8),
                    prompt_tokens=rng.integers(0, vocab, p).astype(np.int32))
            for i, p in enumerate(lens)]


def _engine(model, params, *, num_slots=8, cap=4096, page_size=None,
            draft=False, **kw):
    lat = LatencyModel(model.cfg, TPU_V5E)
    sched = make_scheduler("andes", cap, lat, SchedulerConfig(delta_t=2.0))
    if draft:
        kw.update(draft_model=model, draft_params=params, spec_k=2)
    return ServingEngine(model, params, sched, lat, num_slots=num_slots,
                         max_seq=256, capacity_tokens=cap,
                         page_size=page_size, device="cpu", **kw)


def _widest(cfg, params, reqs):
    sample = [{"prompt": r.prompt_tokens, "served": r.output_tokens}
              for r in reqs]
    assert all(len(s["served"]) >= 2 for s in sample)
    out = served_gaps(cfg, params, sample, device="cpu")
    return float(max(o["served"].max() for o in out))


PATHS = {
    "single": dict(hotpath=HotpathConfig(multi_step=1)),
    "single_unfused": dict(hotpath=HotpathConfig(multi_step=1,
                                                 fused_sampling=False)),
    "multi": dict(hotpath=HotpathConfig(persistent=False)),
    "persistent": dict(),
    "eager_prefill": dict(hotpath=HotpathConfig(prefill_buckets=False)),
    "paged": dict(page_size=16),
    "spec_rounds": dict(draft=True, hotpath=HotpathConfig(multi_step=1)),
    "spec_block": dict(draft=True),
    "swap": dict(cap=160, preemption_mode="swap"),
    "recompute": dict(cap=160, preemption_mode="recompute"),
    "eager_recompute": dict(cap=160, preemption_mode="recompute",
                            hotpath=HotpathConfig(prefill_buckets=False)),
    "chunked_recompute": dict(cap=160, preemption_mode="recompute",
                              prefill_chunk=16),
    "spec_recompute": dict(draft=True, cap=160, preemption_mode="recompute"),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_dense_engine_serves_the_references_tokens(dense, path):
    cfg, model, params = dense
    kw = dict(PATHS[path])
    eng = _engine(model, params, **kw)
    reqs = eng.run(_trace(cfg["vocab_size"]), max_iterations=20_000)
    assert all(r.generated == r.output_len for r in reqs)
    if path in ("multi", "persistent", "paged", "spec_block"):
        assert eng.multi_step_blocks > 0
    if "swap" in path or "recompute" in path:
        assert eng.preemptions > 0
    if path == "paged":
        assert eng.physical_pages
    assert _widest(cfg, params, reqs) < GAP_TOL


@pytest.mark.parametrize("path", ["persistent", "spec_block"])
def test_the_reference_setting_serves_other_tokens(dense, path):
    """The JAX engine's decode (rows pinned one past their last committed
    position) attends the prefill's padding at position len(prompt): its
    tokens fail the check the default engine passes. Outside speculation
    (whose clock follows the draft's acceptance) the two settings' clocks
    agree."""
    from repro_torch.serving import timing_fingerprint
    cfg, model, params = dense
    kw = PATHS[path]
    fixed = _engine(model, params, **kw)
    ref = _engine(model, params, reference_decode=True, **kw)
    a = fixed.run(_trace(cfg["vocab_size"]), max_iterations=20_000)
    b = ref.run(_trace(cfg["vocab_size"]), max_iterations=20_000)
    if "draft" not in kw:
        assert timing_fingerprint(a) == timing_fingerprint(b)
    assert _widest(cfg, params, b) > 100 * GAP_TOL


def test_decode_length_is_one_below_the_context(dense):
    _cfg, model, params = dense
    assert _engine(model, params).decode_length(10) == 9
    assert _engine(model, params, reference_decode=True).decode_length(10) \
        == 10


@pytest.mark.parametrize("path", ["single", "persistent", "paged",
                                  "swap"])
def test_moe_engine_serves_the_references_tokens(moe, path):
    """The chat-shaped mix through a moe engine whose 8 experts take 2
    tokens each: each prompt is one call of its own tokens (the eager
    exact-length prefill, capacity as the reference counts it) and each
    decoded token routes alone. (A recompute resume re-prefills prompt
    and served tokens as one call, under one capacity: not the
    reference's function.)"""
    cfg, model, params = moe
    eng = _engine(model, params, **PATHS[path])
    reqs = eng.run(_trace(cfg["vocab_size"], n=8), max_iterations=20_000)
    assert all(r.generated == r.output_len for r in reqs)
    assert _widest(cfg, params, reqs) < GAP_TOL


def test_moe_tokens_do_not_depend_on_the_empty_slots(moe):
    """The same requests, all due at once, beside 4 and beside 64 empty
    slots: the same tokens, each the reference's."""
    cfg, model, params = moe
    outs = []
    for empty in (4, 64):
        eng = _engine(model, params, num_slots=6 + empty)
        reqs = eng.run(_trace(cfg["vocab_size"], stagger=0.0),
                       max_iterations=20_000)
        assert _widest(cfg, params, reqs) < GAP_TOL
        outs.append([list(r.output_tokens) for r in reqs])
    assert outs[0] == outs[1]


def test_live_routing_drops_no_slot(moe):
    """Every live row sends both its slots to the same two experts, and
    the live rows sit after the empty ones: at one slot per live row each
    live slot is kept; under the reference's capacity over the whole
    batch, with the empty rows routed first, live slots drop."""
    _cfg, model, _params = moe
    mcfg = model.cfg
    E, d, b = mcfg.moe.num_experts, mcfg.d_model, 32
    router = torch.zeros(d, E)
    router[0, :2] = 10.0
    x = torch.zeros(b, d)
    x[:, 0] = 1.0
    valid = torch.zeros(b, dtype=torch.bool)
    valid[-12:] = True
    plan = moe_lib.route(router, x, mcfg, valid, cap=int(valid.sum()))
    keep = plan["keep"].view(b, -1)
    assert bool(keep[valid].all())
    ref = moe_lib.route(router, x, mcfg)
    assert not bool(ref["keep"].view(b, -1)[valid].all())


def test_live_decode_step_is_each_row_alone(moe):
    """One moe decode step over 16 slots, 5 of them live at scattered
    rows, with ``LiveRows``: each live row's logits are those of the row
    decoded alone (a call of its own)."""
    _cfg, model, params = moe
    B, live_rows = 16, [1, 4, 5, 11, 15]
    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(1)
    k = torch.randn(model.init_cache(B, 64)["k"].shape, generator=gen)
    v = torch.randn(k.shape, generator=gen)
    lengths = np.zeros(B, np.int32)
    lengths[live_rows] = rng.integers(3, 40, len(live_rows))
    tokens = torch.as_tensor(rng.integers(0, 512, B).astype(np.int32))

    def cache(rows):
        # (layers, batch, seq, kv, hd) planes; fresh copies, since a
        # decode step writes its token's k/v in place
        return {"k": k[:, rows].clone(), "v": v[:, rows].clone(),
                "length": torch.as_tensor(lengths[rows])}
    every = list(range(B))
    live = moe_lib.LiveRows(torch.as_tensor(lengths > 0), len(live_rows))
    with torch.no_grad():
        logits, _ = model.decode_step(params, tokens, cache(every), live)
        for r in live_rows:
            alone, _ = model.decode_step(params, tokens[r:r + 1],
                                         cache([r]))
            # float32; the batch's width changes the order of the sums
            torch.testing.assert_close(logits[r], alone[0], atol=GAP_TOL,
                                       rtol=0)


# ---------------------------------------------------------------- the other kinds
KIND_ARCHS = {"hybrid": "zamba2-2.7b", "ssm": "falcon-mamba-7b",
              "audio": "seamless-m4t-medium", "vlm": "pixtral-12b"}
_KIND_MODELS = {}


def _kind_model(kind):
    if kind not in _KIND_MODELS:
        model = Model(get_smoke_config(KIND_ARCHS[kind]), device="cpu")
        _KIND_MODELS[kind] = (model, model.init(
            torch.Generator().manual_seed(SEED)))
    return _KIND_MODELS[kind]


def _kind_trace(model, n=6):
    reqs = _trace(model.cfg.vocab_size, n=n)
    enc_seq = model.enc_seq(256)
    for r in reqs:
        if enc_seq:
            r.frames = synthetic_frames(model.cfg, [r.rid], enc_seq)[0]
    return reqs


def _forward_widest(model, params, reqs, patches=None):
    """The widest gap by which a served token's logit lies below the best
    of the cache-free forward over the prompt and the served tokens (the
    request's frames padded as the engine pads them; `patches` before the
    text of a vlm)."""
    enc_seq, d = model.enc_seq(256), model.cfg.d_model
    widest = 0.0
    with torch.no_grad():
        for r in reqs:
            served = [int(t) for t in r.output_tokens]
            assert len(served) >= 2
            seq = list(np.asarray(r.prompt_tokens)) + served[:-1]
            batch = {"tokens": torch.as_tensor(np.asarray(seq, np.int32))[None]}
            if enc_seq:
                batch["frames"] = frames_row(r.frames, enc_seq, d)[None]
            if patches is not None:
                batch["patch_embeds"] = patches
            logits, _ = model.forward_train(params, batch)
            rows = logits[0, r.prompt_len - 1:].float()
            got = rows.gather(1, torch.as_tensor(served)[:, None])[:, 0]
            widest = max(widest, float((rows.max(-1).values - got).max()))
    return widest


KIND_PATHS = [(kind, path) for kind in KIND_ARCHS
              for path in ("single", "persistent", "swap", "recompute")
              ] + [("hybrid", "eager_prefill"), ("hybrid", "eager_recompute"),
                   ("hybrid", "chunked_recompute"), ("vlm", "paged")]


@pytest.mark.parametrize("kind,path", KIND_PATHS,
                         ids=[f"{k}-{p}" for k, p in KIND_PATHS])
def test_other_kinds_serve_the_forwards_tokens(kind, path):
    model, params = _kind_model(kind)
    eng = _engine(model, params, **PATHS[path])
    reqs = eng.run(_kind_trace(model), max_iterations=20_000)
    assert all(r.generated == r.output_len for r in reqs)
    if "swap" in path or "recompute" in path:
        assert eng.preemptions > 0
    if path == "paged":
        assert eng.physical_pages
    assert _forward_widest(model, params, reqs) < GAP_TOL


@pytest.mark.parametrize("reference", [False, True],
                         ids=["default", "reference_decode"])
@pytest.mark.parametrize("kind", list(KIND_ARCHS))
def test_decode_pin_against_the_forward(kind, reference):
    """Three prompts (a vlm's behind 7 image patches, which the cache's
    length counts; an encoder-decoder's over its frames) prefilled, then
    decoded one token a step with the row pinned at the engine's
    ``decode_length`` of its committed context: the logits of every
    position equal the cache-free forward's. The reference pin attends a
    position nothing wrote, in every kind that attends (a pure SSM reads
    no length)."""
    model, params = _kind_model(kind)
    eng = _engine(model, params, reference_decode=reference)
    enc_seq, d = model.enc_seq(256), model.cfg.d_model
    n_patch = 7 if kind == "vlm" else 0
    extra = {}
    if n_patch:
        extra["patch_embeds"] = synthetic_patches(model.cfg, [3], n_patch)
    widest = 0.0
    for req in _kind_trace(model, n=3):
        prompt = torch.as_tensor(np.asarray(req.prompt_tokens, np.int32))
        batch = dict(extra, tokens=prompt[None])
        if enc_seq:
            batch["frames"] = frames_row(req.frames, enc_seq, d)[None]
        with torch.no_grad():
            logits, cache = model.prefill(
                params, batch, model.init_cache(1, 256, enc_seq=enc_seq))
            assert int(cache["length"][0]) == n_patch + req.prompt_len
            got, served = [logits[0]], [int(logits[0].argmax())]
            while len(served) < 12:
                ctx = n_patch + req.prompt_len + len(served)
                cache = cache_lib.with_lengths(cache,
                                               [eng.decode_length(ctx)])
                logits, cache = model.decode_step(
                    params, torch.tensor([served[-1]], dtype=torch.int32),
                    cache)
                got.append(logits[0])
                served.append(int(logits[0].argmax()))
            seq = torch.cat([prompt, torch.as_tensor(served[:-1],
                                                     dtype=torch.int32)])
            want, _ = model.forward_train(params, dict(batch,
                                                       tokens=seq[None]))
        diff = (torch.stack(got) - want[0, req.prompt_len - 1:]).abs()
        widest = max(widest, float(diff.max()))
    if reference and kind != "ssm":
        # the vlm's prefix of patches dilutes the one stray position most
        assert widest > 10 * GAP_TOL
    else:
        assert widest < GAP_TOL
