"""Draft-model side of speculative decoding inside a ServingEngine.

The counterpart of ``src/repro/serving/speculative.py``. A
`DraftProposer` owns a second model (same vocab as the target) and a
second static-slot cache with the target's slot layout, so the request ->
slot mapping, preemption and swap round trips stay one decision the
engine's KVSlotManager makes once.

Per round the proposer greedily autoregresses k+1 tokens
(`Model.propose_step`, no host sync inside); the engine verifies the
window [last_committed, d_1..d_k] against the target (`Model.verify_step`)
and commits the longest matching prefix plus the correction/bonus token —
lossless under greedy sampling.

Draft-cache bookkeeping reduces to one invariant, restored every round:

    the draft cache's valid prefix is always committed[: context_len - 1]

The draft has consumed every committed token but the last, which is the
next round's first input. The proposal consumes k+1 inputs (the last
committed token, then its own d_1..d_k); after a tokens are accepted the
consumed d_1..d_a are the newly committed tokens and the rest is stale,
so re-pinning the draft's `length` to the new context_len - 1 is the
whole rollback (the length gate of models/cache.py). No per-request draft
state lives outside the cache, so park and restore are slot-slice copies.

SSM and hybrid state has no length gate to roll back through, and
capacity-routed MoE couples slots within a batch; only dense attention
models speculate, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import cache as cache_lib
from repro_torch.models.model import Model


def check_speculation_compatible(target: Model, draft: Model) -> None:
    """Both models must be dense attention models sharing the vocab."""
    for role, m in (("target", target), ("draft", draft)):
        if m.cfg.kind != "dense":
            raise ValueError(
                f"speculative decoding supports dense attention models; "
                f"{role} is kind={m.cfg.kind!r} (SSM state cannot be "
                f"length-rolled-back; MoE capacity routing couples slots)")
    if target.cfg.vocab_size != draft.cfg.vocab_size:
        raise ValueError(
            f"draft must share the target's vocab: "
            f"{draft.cfg.vocab_size} != {target.cfg.vocab_size}")


class DraftProposer:
    """Slot-parallel greedy proposer over a shared draft (model, params).

    `bucketed` (a serving.engine.BucketedPrefill over the draft model)
    routes draft prefills through the engine's shape-bucketed path: the
    admissions flushed in one step build their draft k/v in one padded
    call and one slot scatter per bucket group (`prefill_batch`). None
    (hot path off) keeps the eager exact-length batch-1 path."""

    def __init__(self, model: Model, params, *, num_slots: int, max_seq: int,
                 cache_dtype=torch.float32, bucketed=None):
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.bucketed = bucketed
        self.cache = model.init_cache(num_slots, max_seq, dtype=cache_dtype)

    # ---- per-slot cache lifecycle (mirrors the engine's target cache) ------
    def prefill(self, slot: int, tokens: np.ndarray) -> None:
        """Build the draft k/v of a request's committed-minus-last prefix."""
        if self.bucketed is not None:
            self.prefill_batch([slot], [tokens])
            return
        from repro_torch.serving.engine import _write_slot
        one = self.model.init_cache(1, self.max_seq,
                                    dtype=self.cache["k"].dtype)
        toks = torch.as_tensor(np.asarray(tokens, np.int32))[None]
        _, one = self.model.prefill(
            self.params, {"tokens": toks.to(self.model.device)}, one)
        self.cache = _write_slot(self.cache, one, slot)

    def prefill_batch(self, slots, toks_list) -> int:
        """Bucketed multi-row draft prefill (the engine's grouped flush;
        the draft needs no first-token ids, so nothing is fetched).
        Returns the number of bucket groups dispatched."""
        self.cache, _, _, n_groups = self.bucketed.prefill_into(
            self.params, self.cache, list(slots), list(toks_list),
            need_first=False)
        return n_groups

    def park(self, slot: int) -> dict:
        """Copy a slot's draft slice to the host (preemption swap-out)."""
        from repro_torch.serving.engine import _read_slot
        return _read_slot(self.cache, slot)

    def restore(self, slot: int, host_slice: dict) -> None:
        from repro_torch.serving.engine import _write_slot
        self.cache = _write_slot(self.cache, host_slice, slot)

    # ---- proposal ----------------------------------------------------------
    def propose(self, last_tokens: np.ndarray, draft_lengths: np.ndarray,
                k: int) -> np.ndarray:
        """Greedy k-token proposals for every slot (host arrays in and
        out; one sync). last_tokens (num_slots,): the last committed token
        per slot; draft_lengths (num_slots,): committed context_len - 1
        per active slot. Returns proposals (num_slots, k); the (k+1)-th
        token is cache upkeep and is dropped."""
        self.cache = cache_lib.with_lengths(self.cache, draft_lengths)
        dev = self.model.device
        toks, self.cache = self.model.propose_step(
            self.params, torch.as_tensor(np.asarray(last_tokens,
                                                    np.int32)).to(dev),
            self.cache, k)
        return toks.cpu().numpy()[:, :k]


__all__ = ["DraftProposer", "check_speculation_compatible"]
