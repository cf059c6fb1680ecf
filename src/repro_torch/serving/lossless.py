"""Losslessness fingerprints and the near-tie flip classifier.

The hot-path benchmark and the differential test suites all make
the same two promises about an engine rewrite:

* **exact** — token ids, emission timestamps, preemptions, and final QoE
  reproduce the reference bit-for-bit (`fingerprint`);
* **timing-exact** — the virtual-clock half alone (`timing_fingerprint`),
  used against the pre-PR-5 legacy engine whose *prefill numerics* differ:
  padded, lengths-masked bucketed prefill is mathematically equivalent to
  exact-length prefill but not bitwise equal (last-ulp reduction-order
  differences), so a greedy argmax near-tie can flip a token id.

This module is the single owner of what "documented ulp flip" means.
The initial perturbation is last-ulp scale (the padded-vs-exact logit
gap measures ~1e-6 on the smoke model, pinned in
tests/test_lossless_flips.py), but it does not stay there: the cache
rows it lands in feed every subsequent decode step, so by the position
where a token actually flips the accumulated divergence can reach the
1e-3 scale. A flip is therefore ACCEPTABLE iff, at the first diverging
position, the exact-length model's top-2 logit margin is below
`FLIP_TOL` — the two paths disagreed only where the model sat in its
indecision tail, where amplified float noise is the deciding vote.
Anything larger is a real numerical divergence and the benchmark gate
(and the pinned test in tests/test_lossless_flips.py) fails.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

#: largest exact-path top-2 logit margin a padded-vs-exact prefill flip
#: may hide behind. Measured on the smoke model's 50-request benchmark
#: trace: all observed flips sit at margins 4e-4..9e-3, while the
#: model's typical margins run p10 ~1.1e-2 / median ~6e-2 — the gate
#: sits in the gap, above every amplified-noise flip and below the
#: decided bulk of the margin distribution.
FLIP_TOL = 1e-2


def fingerprint(out) -> list:
    """Everything exact losslessness promises: token ids, emit
    timestamps, preemptions, final QoE."""
    return [(r.rid, tuple(r.output_tokens), tuple(r.emit_times),
             r.preemptions, r.final_qoe()) for r in out]


def timing_fingerprint(out) -> list:
    """The virtual-clock half of the promise (token-id-agnostic)."""
    return [(r.rid, r.generated, tuple(r.emit_times), r.preemptions,
             r.final_qoe()) for r in out]


def first_divergence(a_tokens, b_tokens) -> Optional[int]:
    """Index of the first position where two token streams disagree
    (length mismatch counts at the shared-prefix boundary); None when
    identical."""
    n = min(len(a_tokens), len(b_tokens))
    for i in range(n):
        if a_tokens[i] != b_tokens[i]:
            return i
    return None if len(a_tokens) == len(b_tokens) else n


def _enc_batch(model, batch, frames, enc_seq: int):
    """An encoder-decoder's batch gains the request's frames (zeros, which
    the encoder maps to zero memory, where it has none); other kinds'
    batches pass through."""
    from repro_torch.models.transformer import ENCDEC_KINDS
    from repro_torch.serving.engine import frames_row
    if model.cfg.kind not in ENCDEC_KINDS:
        return batch
    f = frames_row(frames, enc_seq, model.cfg.d_model)
    return dict(batch, frames=f[None].to(model.device))


def exact_margin(model, params, prompt_tokens, prefix, frames=None) -> float:
    """Top-2 logit margin of the EXACT-LENGTH path at the position that
    emitted token `len(prefix)`: prefill `prompt + prefix` at its true
    length (batch 1, no padding) on the port's model and measure how
    decided the model was. An encoder-decoder's prefill takes the
    request's `frames` (the reference's has none and raises there).

    This is the reference the flip classifier trusts: the exact-length
    forward is the numerics both engines are approximating, so its margin
    at the divergence point is the honest size of the tie."""
    toks = np.concatenate([
        np.asarray(prompt_tokens, np.int32),
        np.asarray(list(prefix), np.int32),
    ]) if len(prefix) else np.asarray(prompt_tokens, np.int32)
    s = int(toks.shape[0])
    enc_seq = max(model.enc_seq(s + 1), 1)
    cache = model.init_cache(1, s + 1, enc_seq=enc_seq)
    tokens = torch.as_tensor(toks[None, :]).to(model.device)
    batch = _enc_batch(model, {"tokens": tokens}, frames, enc_seq)
    logits, _ = model.prefill(params, batch, cache)
    row = logits[0].double().cpu().numpy()
    top2 = np.partition(row, -2)[-2:]
    return float(top2[1] - top2[0])


def engine_margin(engine, prompt_tokens, prefix, frames=None) -> float:
    """Top-2 logit margin at the position that emitted token `len(prefix)`,
    replayed along `engine`'s own layout (`_engine_logits`)."""
    row = _engine_logits(engine, prompt_tokens, prefix,
                         frames).double().numpy()
    top2 = np.partition(row, -2)[-2:]
    return float(top2[1] - top2[0])


def _engine_logits(engine, prompt_tokens, prefix,
                   frames=None) -> torch.Tensor:
    """The logits (vocab,) on the host at the position that emitted token
    `len(prefix)`, replayed along `engine`'s own layout at batch 1: the
    prompt prefilled as the engine prefills it (padded to its length
    bucket, the padding's k/v left in the cache; at its exact length on
    the eager path), then one decode step per committed token with the
    cache's length gate where the engine's decode pins it
    (``ServingEngine.decode_length`` of the context length). Under
    ``reference_decode`` the first emitted token's k/v is never written
    (its decode writes at len(prompt) + 1), so every decode attends what
    the prefill left at position len(prompt), which the exact-length path
    never sees.

    The referee for flips between two engines that group the same
    prompts into prefills of other shapes (a speculative engine against
    its baseline): where a model's greedy tokens depend on that position,
    as a random-weight model's do at full width, `exact_margin` measures
    another function. Replays a request that ran without preemption (a
    recompute re-prefills prompt + generated). An encoder-decoder's
    prefill takes `frames` padded as the engine pads them (zeros where
    there are none)."""
    from repro_torch.models import cache as cache_lib
    model, dev = engine.model, engine.model.device
    toks = np.asarray(prompt_tokens, np.int32)
    n = int(toks.shape[0])
    if engine.hotpath.prefill_buckets and engine._prefill_bucketable:
        padded = np.zeros((1, engine._prefill.bucket(n)), np.int32)
        padded[0, :n] = toks
        batch = {"tokens": torch.as_tensor(padded).to(dev),
                 "lengths": torch.as_tensor([n], dtype=torch.int32).to(dev)}
    else:
        batch = {"tokens": torch.as_tensor(toks[None]).to(dev)}
    enc_seq = engine._prefill.enc_seq
    cache = model.init_cache(1, engine._cache_seq, enc_seq=enc_seq,
                             dtype=engine._prefill.cache_dtype)
    batch = _enc_batch(model, batch, frames, enc_seq)
    logits, cache = model.prefill(engine.params, batch, cache)
    for i, tok in enumerate(prefix):
        cache = cache_lib.with_lengths(cache,
                                       [engine.decode_length(n + 1 + i)])
        logits, cache = model.decode_step(
            engine.params, torch.as_tensor([int(tok)], dtype=torch.int32)
            .to(dev), cache)
    return logits[0].cpu()


def classify_flip(margin: float, tol: float = FLIP_TOL) -> str:
    """'documented_ulp_flip' when the exact path was indifferent at
    float-noise scale; 'real_divergence' otherwise."""
    return "documented_ulp_flip" if abs(margin) <= tol else "real_divergence"


def audit_flips(model, params, out_a, out_b, tol: float = FLIP_TOL,
                engine=None) -> List[dict]:
    """Compare two runs of the same workload request-by-request and
    classify every token-id mismatch. Returns one record per diverging
    request: rid, first diverging position, the exact-path top-2 margin
    there, and the classification. An empty list means token-identical.
    An encoder-decoder's margins are taken with each request's frames
    (`frames` on the requests of `out_a`).

    With `engine`, the margin that classifies is `engine_margin` along
    that engine's layout (`model` and `params` must be the engine's); the
    exact-path margin stays in the record as `exact_margin`."""
    flips = []
    by_rid = {r.rid: r for r in out_b}
    for ra in out_a:
        rb = by_rid.get(ra.rid)
        if rb is None:
            continue
        pos = first_divergence(ra.output_tokens, rb.output_tokens)
        if pos is None:
            continue
        prefix = ra.output_tokens[:pos]
        frames = getattr(ra, "frames", None)
        margin = exact_margin(model, params, ra.prompt_tokens, prefix,
                              frames)
        rec = {"rid": int(ra.rid), "position": int(pos)}
        if engine is not None:
            rec["exact_margin"] = margin
            margin = engine_margin(engine, ra.prompt_tokens, prefix, frames)
        rec["margin"] = margin
        rec["classification"] = classify_flip(margin, tol)
        flips.append(rec)
    return flips


def all_flips_documented(flips: List[dict]) -> bool:
    """The benchmark's tolerance gate: every observed flip must be a
    documented ulp flip (margin within FLIP_TOL); vacuously true when
    the runs were token-identical."""
    return all(f["classification"] == "documented_ulp_flip" for f in flips)
