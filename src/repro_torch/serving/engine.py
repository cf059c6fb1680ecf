"""Continuous-batching engine over the port's PyTorch model.

The counterpart of ``src/repro/serving/engine.py`` (whose module
docstring explains the design in full): the same Scheduler / FluidQoE /
Request machinery drives a real model — each iteration schedules,
preempts (swap to host memory or recompute), admits through bucketed,
batched prefill (chunked when ``prefill_chunk`` is set), and decodes
greedily over every occupied slot, one step or a certified multi-step
block at a time. The virtual clock advances by the LatencyModel, so with
EOS off the emitted timestamps depend only on lengths and batch
composition and match the reference engine's exactly.

What differs from the reference, and why:

* PyTorch runs eagerly, so the jitted entry points are the model's
  methods themselves, and the persistent decode block is j device steps
  with argmax feedback and one host sync (``Model.decode_persistent``).
* Caches are updated in place; JAX's out-of-range rules are spelled out
  where the reference leans on them (dropped scatters for the sentinel
  slot / page, clamped gathers and writes — models/cache.py).
* Speculative decoding (``spec_k > 0``, a ``draft_model`` and its
  params): the reference's fused round and its device ``while_loop`` of
  rounds become plain functions on tensors — a round is the draft's k+1
  decode steps, the window's concatenation and the target's k+1 verify
  steps, the greedy argmax and the accepted-prefix count, all on the
  device; a block runs exactly `s` rounds (a host int) with lengths,
  accepted counts and the next token kept on the device, and syncs once.
  Dispatch and sync counters are the reference's (``spec_fused``,
  ``spec_block``, ``propose``, ``verify``, ``draft_prefill``, ``write``).
* MoE models keep the eager exact-length prefill (capacity depends on the
  padded token count), as in the reference.

Observers (``repro_torch.obs``) attach as in the reference: ``observer``
/ ``set_observer`` install one, ``attach_observer`` composes another
beside it, and the legacy ``event_sink`` callable is wrapped in an
``EventSinkAdapter``; ``_rewire_obs`` keeps the engine, the scheduler and
the prefill compile hook on one composed stream. ``cancel(rid)`` aborts a
pending, running or swapped request (a server's client disconnect), and
``wall_now()`` reads the engine's clock for arrivals stamped from
outside.

Spans (``repro_torch.obs.spans``): the engine always writes its
``SpanLog``, ``spans``, on its own clock, cleared by ``reset()``: ``engine.step`` over its
``engine.schedule``; ``engine.prefill_call`` per bucket group (see
``BucketedPrefill``) or eager call, with its parts; ``engine.decode_block``
per decode entry point (payload j, rows); ``engine.swap_out`` and
``engine.swap_in`` (payload rid); ``engine.tick_sleep`` when ``_tick``
sleeps; and the prefill counters.

On a CUDA device the model's attention runs on the hand-written kernels
(kernels/csrc); on the CPU on their plain versions.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.qoe import FluidQoE
from repro_torch.core.request import Request, ReqState
from repro_torch.core.scheduler import Scheduler
from repro_torch.device import resolve_device
from repro_torch.models import cache as cache_lib
from repro_torch.models.model import Model
from repro_torch.obs.observer import EventSinkAdapter, compose
from repro_torch.obs.spans import NO_SPANS, SpanLog
from repro_torch.serving.kv_manager import KVSlotManager
from repro_torch.serving.simulator import SimResult
from repro_torch.serving.speculative import (DraftProposer,
                                             check_speculation_compatible)


@dataclasses.dataclass(frozen=True)
class HotpathConfig:
    """Engine hot-path switches (all lossless and ON by default, as in the
    reference; ``HotpathConfig.baseline()`` is the eager baseline)."""
    prefill_buckets: bool = True    # bucketed/batched prefill
    bucket_min: int = 16            # smallest prompt-length bucket
    fused_sampling: bool = True     # on-device argmax
    multi_step: int = 8             # max decode iters per dispatch (1 = off)
    persistent: bool = True         # unquantized j-step device blocks
                                    # instead of the power-of-two grid
    wall_multi_step: bool = True    # let wall-clock engines run blocks

    @staticmethod
    def baseline() -> "HotpathConfig":
        """Eager exact-length batch-1 prefill, full-logit host argmax, one
        decode iteration per dispatch."""
        return HotpathConfig(prefill_buckets=False, fused_sampling=False,
                             multi_step=1)


def _slot_axis(leaf: torch.Tensor) -> int:
    """A leaf's slot axis, by its rank as in the reference: 0 for the
    per-slot vectors (length, enc_length (B,)), 1 for the stacked
    planes (L, B, ...)."""
    return 0 if leaf.ndim == 1 else 1


def _write_slot(cache, src, slot: int):
    """Insert batch-1 `src` rows into `cache` at slot `slot` (in place)."""
    for key, s in src.items():
        c = cache[key]
        if _slot_axis(c) == 0:
            c[slot] = s[0].to(device=c.device, dtype=c.dtype)
        else:
            c[:, slot] = s[:, 0].to(device=c.device, dtype=c.dtype)
    return cache


def _write_slots(cache, src, slots: np.ndarray):
    """Insert an N-row `src` into `cache` at slots `slots` (host ints) —
    one scatter per leaf. Rows whose slot is the sentinel num_slots (row
    bucket padding) are dropped, as the reference's mode="drop"."""
    n_slots = cache["length"].shape[0]
    rows = np.nonzero(slots < n_slots)[0]
    if not len(rows):
        return cache
    dev = cache["length"].device
    dst = torch.as_tensor(slots[rows], dtype=torch.long).to(dev)
    sel = torch.as_tensor(rows, dtype=torch.long).to(dev)
    for key, s in src.items():
        c = cache[key]
        if _slot_axis(c) == 0:
            c[dst] = s[sel].to(c.dtype)
        else:
            c[:, dst] = s[:, sel].to(c.dtype)
    return cache


def _read_slot(cache, slot: int):
    """Slot `slot`'s leaves (batch axis kept, length 1), copied to host."""
    out = {}
    for key, c in cache.items():
        if key == "block_tables":
            continue
        ax = _slot_axis(c)
        out[key] = c.narrow(ax, slot, 1).to("cpu", copy=True)
    return out


def _paged_commit(cache, bt_rows, starts, k_seg, v_seg, counts):
    """Scatter contiguous k/v token segments into the page pool (the paged
    image of `_write_slots`): row i holds counts[i] tokens landing at
    absolute positions starts[i].. through the pages bt_rows[i] names.
    Sentinel-routed positions drop."""
    cache_lib.paged_write_tokens(cache["k"], bt_rows, starts, k_seg, counts)
    cache_lib.paged_write_tokens(cache["v"], bt_rows, starts, v_seg, counts)
    return cache


def _paged_read_row(cache, table_row, slot: int, *, max_seq: int):
    """Gather one slot's pages back into a contiguous host row — same leaf
    shapes and bytes as `_read_slot` on a contiguous cache."""
    return {
        "length": cache["length"][slot:slot + 1].to("cpu", copy=True),
        "k": cache_lib.paged_gather_rows(
            cache["k"], table_row, max_seq).to("cpu", copy=True),
        "v": cache_lib.paged_gather_rows(
            cache["v"], table_row, max_seq).to("cpu", copy=True),
    }


def _accept(window, logits, k: int):
    """Greedy ids of a verified window and each row's accepted-prefix
    length: window (B, k+1), logits (B, k+1, V) -> (greedy (B, k+1),
    accepted (B,)) int32, on the device."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    match = (window[:, 1:] == greedy[:, :k]).to(torch.int32)
    accepted = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
    return greedy, accepted


class BucketedPrefill:
    """Shape-bucketed prefill front-end for one model.

    Pads a group of prompts (all mapping to the same length bucket — the
    caller groups) to (row_bucket, len_bucket), runs one ``Model.prefill``
    with per-row ``lengths`` masking, takes the first-token argmax on the
    device, and returns (first_ids (N,), cache rows) for one fused
    `_write_slots` scatter. `shapes_seen` records the padded shapes run.
    An encoder-decoder's rows also take frames, padded to
    (rows, enc_seq, d) f32 with zeros for a row that has none.

    Into its span log `spans` (the engine's; by default ``NO_SPANS``,
    which keeps nothing), each bucket group writes one
    ``engine.prefill_call`` span, payload rids, valid lengths, padded
    rows and bucket, over its parts in call order: ``prefill.stage``
    (host padding and H2D), ``prefill.cache_init``, the model's
    ``model.prefill``, ``prefill.write`` (the slot scatter) and
    ``prefill.readback`` (the first tokens' copy to the host); and the
    counters ``prefill.calls``, ``prefill.rows`` (real rows),
    ``prefill.row_slots`` (padded rows), ``prefill.tokens`` (valid
    tokens) and ``prefill.token_slots`` (rows x bucket) grow by the
    call's shape."""

    def __init__(self, model: Model, cache_seq: int, cache_dtype, *,
                 max_seq: int, bucket_min: int = 16,
                 spans: SpanLog = NO_SPANS):
        self.model = model
        self.cache_seq = cache_seq
        self.cache_dtype = cache_dtype
        self.enc_seq = model.enc_seq(max_seq)
        # geometric (x2) grid from bucket_min; the terminal bucket is
        # clamped to the physical cache depth and still covers max_seq
        self.buckets: List[int] = []
        b = max(2, int(bucket_min))
        while b < max_seq and b < cache_seq:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(min(b, cache_seq))
        self.shapes_seen = set()        # (rows, len_bucket) signatures
        self.on_compile = None          # optional fn(key) on a new shape
        self.spans = spans

    def note_shape(self, key) -> None:
        if key not in self.shapes_seen:
            self.shapes_seen.add(key)
            if self.on_compile is not None:
                self.on_compile(key)

    def bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    @staticmethod
    def row_bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def _call(self, params, tokens, lengths, frames):
        sp = self.spans
        tok = sp.begin("prefill.cache_init")
        cache = self.model.init_cache(tokens.shape[0], self.cache_seq,
                                      enc_seq=self.enc_seq,
                                      dtype=self.cache_dtype)
        sp.end(tok)
        batch = {"tokens": tokens, "lengths": lengths}
        if self.enc_seq:
            batch["frames"] = frames
        logits, cache = self.model.prefill(params, batch, cache)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    def prefill_into(self, params, cache, slots, toks_list,
                     frames_list=None, *, need_first=True, write=None,
                     rids=None):
        """Grouped flush: prefill every (slot, tokens) pair and scatter the
        rows into `cache` — one padded multi-row call and one fused write
        per bucket group. Returns (cache', first_ids (N,) int32 aligned
        with the inputs, host sync rounds, bucket groups dispatched).
        `write` overrides the slot-row scatter (the physically paged
        engine's page-pool committer; rows map to slots through the same
        padded id array, sentinel = num_slots). `rids`, aligned with the
        inputs, label the call spans."""
        if write is None:
            write = _write_slots
        groups: dict = {}
        for i, t in enumerate(toks_list):
            groups.setdefault(self.bucket(len(t)), []).append(i)
        first_out = np.zeros(len(toks_list), np.int32)
        oob = cache["length"].shape[0]          # row-pad scatter sentinel
        syncs = 0
        sp = self.spans
        for bucket in sorted(groups):
            idxs = groups[bucket]
            toks = [toks_list[i] for i in idxs]
            call = self._begin_call(
                tuple(map(rids.__getitem__, idxs)) if rids else (),
                tuple(map(len, toks)), bucket)
            first, src = self.run(
                params, toks,
                [frames_list[i] for i in idxs] if frames_list else None)
            rows = src["length"].shape[0]
            pad = np.full((rows,), oob, np.int32)
            pad[: len(idxs)] = [slots[i] for i in idxs]
            tok = sp.begin("prefill.write")
            cache = write(cache, src, pad)
            sp.end(tok)
            if need_first:
                tok = sp.begin("prefill.readback")
                first = first.cpu().numpy()
                sp.end(tok)
                syncs += 1
                for j, i in enumerate(idxs):
                    first_out[i] = first[j]
            sp.end(call)
        return cache, first_out, syncs, len(groups)

    def _begin_call(self, rids: tuple, lengths: tuple, bucket: int) -> int:
        """Open an ``engine.prefill_call`` span and count its shape."""
        sp = self.spans
        real = len(lengths)
        rows = self.row_bucket(real)
        sp.count(("prefill.calls", 1), ("prefill.rows", real),
                 ("prefill.row_slots", rows), ("prefill.tokens", sum(lengths)),
                 ("prefill.token_slots", rows * bucket))
        return sp.begin("engine.prefill_call",
                        {"rids": rids, "lengths": lengths, "rows": rows,
                         "bucket": bucket})

    def run(self, params, toks_list, frames_list=None):
        """Prefill one same-bucket group. toks_list: per-request token
        arrays; frames_list: per-request (enc_seq, d) frames or None;
        returns (first_ids (rows,) on the device, padded rows)."""
        sp = self.spans
        tok = sp.begin("prefill.stage")
        rows = self.row_bucket(len(toks_list))
        seq = self.bucket(max(len(t) for t in toks_list))
        tokens = np.zeros((rows, seq), np.int32)
        lengths = np.zeros((rows,), np.int32)
        for i, t in enumerate(toks_list):
            tokens[i, : len(t)] = t
            lengths[i] = len(t)
        dev = self.model.device
        frames = None
        if self.enc_seq:
            d = self.model.cfg.d_model
            frames = torch.zeros((rows, self.enc_seq, d))
            for i, f in enumerate(frames_list or ()):
                frames[i] = frames_row(f, self.enc_seq, d)
            frames = frames.to(dev)
        self.note_shape((rows, seq))
        tokens = torch.as_tensor(tokens).to(dev)
        lengths = torch.as_tensor(lengths).to(dev)
        sp.end(tok)
        return self._call(params, tokens, lengths, frames)


def frames_row(f, enc_seq: int, d: int) -> torch.Tensor:
    """A request's frames (a tensor, an array, or None: zeros) as an
    (enc_seq, d) f32 host tensor, as the engine feeds its encoder."""
    if f is None:
        return torch.zeros((enc_seq, d))
    if not isinstance(f, torch.Tensor):
        f = torch.as_tensor(np.asarray(f))
    return f.to("cpu", torch.float32)


@dataclasses.dataclass
class _StagedPrefill:
    """One admission whose host bookkeeping is done but whose device work
    (prefill + slot write + first-token id) is deferred to the batched
    flush. `emit_t` is the already-ticked first-token timestamp (None for
    recompute resumes, which emit nothing at prefill)."""
    req: Request
    slot: int
    toks: np.ndarray
    emit_t: Optional[float]
    frames: Optional[object] = None


class ServingEngine:
    """Continuous-batching engine over the port's model.

    Incremental API (identical to the reference's):
      submit(req)  enqueue an arrival
      step()       one scheduling+decode iteration; False when out of work
      has_work     pending or live requests remain
      result()     SimResult over every request ever submitted
    Batch API: run(workload) submits all and steps to completion.
    """

    def __init__(
        self,
        model: Model,
        params,
        scheduler: Scheduler,
        lat: LatencyModel,
        *,
        num_slots: int = 8,
        max_seq: int = 256,
        capacity_tokens: Optional[int] = None,
        preemption_mode: str = "swap",
        clock: str = "virtual",
        eos_id: int = -1,
        cache_dtype=torch.float32,
        draft_model: Optional[Model] = None,
        draft_params=None,
        spec_k: int = 0,
        hotpath: Optional[HotpathConfig] = None,
        prefill_chunk: int = 0,
        page_size: Optional[int] = None,
        physical_pages: Optional[bool] = None,
        device="cuda",
    ):
        if resolve_device(device).type != model.device.type:
            raise ValueError(f"engine device {device!r} differs from the "
                             f"model's ({model.device})")
        self.model = model
        self.params = params
        self.sched = scheduler
        self.lat = lat
        self.preemption_mode = preemption_mode
        self.clock = clock
        self.eos_id = eos_id
        self.hotpath = hotpath if hotpath is not None else HotpathConfig()
        self._observer = None
        self._event_sink = None
        self.obs = None
        self.max_seq = max_seq
        self._num_slots = num_slots
        self._capacity_tokens = capacity_tokens
        self._rollback_ok = cache_lib.supports_length_rollback(model.cfg)

        # ---- speculative decoding (optional) ----------------------------
        self.spec_k = int(spec_k)
        # a verify window writes up to k+1 positions past a slot's
        # committed context: the physical cache is that much deeper so the
        # writes are never clamped onto position max_seq-1; max_seq stays
        # the logical per-request bound
        self._cache_seq = max_seq + (self.spec_k + 1 if self.spec_k else 0)
        if self.spec_k:
            if draft_model is None or draft_params is None:
                raise ValueError(
                    "spec_k > 0 requires draft_model/draft_params")
            check_speculation_compatible(model, draft_model)
            self.draft = DraftProposer(
                draft_model, draft_params, num_slots=num_slots,
                max_seq=self._cache_seq, cache_dtype=cache_dtype,
                bucketed=(BucketedPrefill(
                    draft_model, self._cache_seq, cache_dtype,
                    max_seq=max_seq, bucket_min=self.hotpath.bucket_min,
                ) if self.hotpath.prefill_buckets else None))
            self._verify = model.verify_step
            self._spec_fused = self._make_spec_fused()
            self._spec_block = self._make_spec_block()
        else:
            self.draft = None

        # ---- physical paging: a real device page pool -------------------
        paged = page_size is not None and 0 < int(page_size) < max_seq
        if physical_pages is None:
            physical_pages = (paged and not self.spec_k
                              and model.supports_physical_paging())
        elif physical_pages:
            if not paged:
                raise ValueError(
                    "physical_pages=True requires a paged engine "
                    "(0 < page_size < max_seq)")
            if self.spec_k:
                raise ValueError(
                    "physical_pages=True is incompatible with speculative "
                    "decoding (verify windows write past the block table)")
            if not model.supports_physical_paging():
                raise ValueError(
                    f"model kind {model.cfg.kind!r} does not support a "
                    "physically paged KV cache")
        self.physical_pages = bool(physical_pages)
        if self.physical_pages:
            # the physical pool IS the admission capacity: every page id
            # the manager hands out names a real device row
            cap_tokens = capacity_tokens or num_slots * max_seq
            self._pool_pages = -(-cap_tokens // page_size)
            self._max_pages = -(-self._cache_seq // page_size)
            self.cache = model.init_paged_cache(
                num_slots, self._pool_pages, page_size, self._cache_seq,
                dtype=cache_dtype)
        else:
            self._pool_pages = 0
            self._max_pages = 0
            self.cache = model.init_cache(num_slots, self._cache_seq,
                                          enc_seq=model.enc_seq(max_seq),
                                          dtype=cache_dtype)
        # the device entry points (the reference jits these)
        self._decode = model.decode_step
        self._decode_tok = model.decode_tokens
        self._decode_multi = model.decode_multi
        self._decode_persist = model.decode_persistent
        self.spans = SpanLog(
            clock=None if clock == "wall" else (lambda: self.now))
        self._prefill = BucketedPrefill(
            model, self._cache_seq, cache_dtype, max_seq=max_seq,
            bucket_min=self.hotpath.bucket_min, spans=self.spans)
        # MoE capacity depends on the padded token count (and on the rows
        # batched beside a prompt), so MoE keeps the eager exact-length path
        self._prefill_bucketable = model.cfg.kind != "moe"
        # ---- chunked prefill + paged KV accounting ----------------------
        self.prefill_chunk = int(prefill_chunk)
        self._page_size = page_size
        if self.prefill_chunk:
            if self.spec_k:
                raise ValueError("chunked prefill requires spec_k=0")
            if not (self.hotpath.prefill_buckets
                    and self._prefill_bucketable):
                raise ValueError(
                    "chunked prefill requires the bucketed prefill path "
                    "(hotpath.prefill_buckets=True, non-MoE model)")
        self.reset()
        if self.kv.paged and not self.sched.cfg.page_size:
            self.sched.cfg.page_size = self.kv.page_size
        if self.prefill_chunk and not self.sched.cfg.prefill_chunk:
            self.sched.cfg.prefill_chunk = self.prefill_chunk

    # ------------------------------------------------------------------ state
    def reset(self) -> None:
        """Clear all serving state (the device cache is reused; live slots
        are always re-written at prefill/swap-in time)."""
        if getattr(self, "kv", None) is None:
            self.kv = KVSlotManager(self._num_slots, self.max_seq,
                                    self._capacity_tokens,
                                    burst_reserve=(self.spec_k + 1
                                                   if self.spec_k else 0),
                                    page_size=self._page_size)
        else:
            self.kv.reset()
        self.sched.reset()
        self.fluid = FluidQoE()
        self.spec_steps = 0          # verify rounds per slot
        self.spec_proposed = 0       # draft tokens proposed (k each)
        self.spec_accepted = 0       # draft tokens accepted by the target
        if hasattr(self.lat, "reset"):
            self.lat.reset()
        self.now = 0.0
        self.slot_req: Dict[int, Request] = {}
        self.preemptions = 0
        self.total_tokens = 0
        self.iterations = 0
        self.batch_sizes: List[int] = []
        self._pending: List[Request] = []    # sorted arrivals; admitted
        self._pending_pos = 0                #   prefix tracked by cursor
        self.live: List[Request] = []
        self.seen: List[Request] = []        # submit order
        self.stuck = False
        self.host_syncs = 0                  # device→host transfer rounds
        self.dispatches = 0                  # model-forward launches
        self.multi_step_blocks = 0
        self.multi_step_iters = 0
        self.persistent_blocks = 0
        self.persistent_iters = 0
        self.page_gathers = 0                # pool→contiguous row gathers
        self.page_scatters = 0               # contiguous→pool scatters
        self.page_gather_bytes = 0
        self._kv_version_seen = -1
        self._bt_host = None
        self._wall0 = time.monotonic()
        self.spans.reset(self._wall0)

    # ------------------------------------------------------------ observers
    @property
    def observer(self):
        """Installed Observer (repro_torch.obs); None = observability off."""
        return self._observer

    @observer.setter
    def observer(self, obs) -> None:
        self._observer = obs
        self._rewire_obs()

    @property
    def event_sink(self):
        """Legacy lifecycle callable `sink(kind, req, t, k)` (deprecated;
        kept as an EventSinkAdapter shim — prefer `observer`)."""
        return self._event_sink

    @event_sink.setter
    def event_sink(self, sink) -> None:
        self._event_sink = sink
        self._rewire_obs()

    def set_observer(self, obs) -> None:
        self.observer = obs

    def attach_observer(self, obs) -> None:
        """Add `obs` alongside any already-installed observer."""
        self.observer = compose(self._observer, obs)

    def _rewire_obs(self) -> None:
        """Point the engine, the scheduler and the prefill compile hook at
        one stream: the installed observer composed with the legacy sink."""
        sink_obs = (EventSinkAdapter(self._event_sink)
                    if self._event_sink is not None else None)
        self.obs = compose(self._observer, sink_obs)
        self.sched.obs = self.obs
        obs = self.obs
        cb = ((lambda key: obs.jit_compile(self.now, key))
              if obs is not None else None)
        self._prefill.on_compile = cb
        if self.spec_k and self.draft.bucketed is not None:
            self.draft.bucketed.on_compile = cb

    def _sync(self, n: int = 1) -> None:
        if n:
            self.host_syncs += n
            if self.obs is not None:
                self.obs.sync(self.now, n)

    def _begin_decode(self, j: int, rows: int) -> int:
        return self.spans.begin("engine.decode_block", {"j": j, "rows": rows})

    def _dispatch(self, kind: str, n: int = 1) -> None:
        if n:
            self.dispatches += n
            if self.obs is not None:
                self.obs.dispatch(self.now, kind, n)

    # ------------------------------------------------------ physical paging
    def _refresh_block_tables(self) -> None:
        """Re-pin the device block tables to the manager's page assignment
        (only when kv.version moved). Row `slot` holds that slot's table,
        sentinel = pool size past its end; the extra all-sentinel last row
        is the scatter target of row-bucket padding. Raises on overdraft
        ids, which name no device row."""
        if not self.physical_pages or self.kv.version == self._kv_version_seen:
            return
        P = self._pool_pages
        bt = np.full((self.kv.num_slots + 1, self._max_pages), P, np.int32)
        for rid, table in self.kv.block_table.items():
            slot = self.kv.slot_of.get(rid)
            if slot is None:
                continue
            if table and max(table) >= P:
                raise RuntimeError(
                    f"physical page pool overdrawn (page id {max(table)} "
                    f">= pool size {P}): the scheduler admitted more "
                    "context than the device pool holds")
            if len(table) > self._max_pages:
                raise RuntimeError(
                    f"request {rid} holds {len(table)} pages but a slot "
                    f"spans at most {self._max_pages} "
                    f"(max_seq={self.max_seq}): its prompt_len + "
                    "output_len exceeds the engine's context budget")
            bt[slot, : len(table)] = table
        self._bt_host = bt
        self.cache = cache_lib.with_block_tables(self.cache, bt[:-1])
        self._kv_version_seen = self.kv.version

    def _paged_writer(self, cache, src, pad):
        """Scatter a contiguous prefill result into the page pool — the
        paged image of `_write_slots`. counts = length + 1: the contiguous
        path writes the FULL padded row, and the one junk position a fresh
        request ever attends is index `prompt` (its first emitted token's
        KV is never written), so the +1 copies that position's content."""
        rows = np.asarray(pad, np.int32)
        bt_rows = torch.as_tensor(self._bt_host[rows])
        counts = src["length"].to(torch.int32) + 1
        starts = torch.zeros_like(counts)
        self.page_scatters += 1
        return _paged_commit(cache, bt_rows, starts, src["k"], src["v"],
                             counts)

    def submit(self, req: Request) -> None:
        i = bisect.bisect_right(self._pending, req.arrival,
                                lo=self._pending_pos,
                                key=lambda r: r.arrival)
        self._pending.insert(i, req)
        self.seen.append(req)
        if self.obs is not None:
            self.obs.submit(req, req.arrival)
        self.stuck = False

    def cancel(self, rid: int) -> bool:
        """Abort a request by rid (client disconnect / explicit cancel).

        The request is finalized at once with whatever it has emitted:
        marked ``cancelled`` + FINISHED, its KV slot (or its parked host
        slices, for a swapped request; the device cache is not touched)
        freed, and the scheduler notified, so the next step()'s knapsack
        prices the freed memory. Returns False if the rid is unknown or
        already finished (a cancel racing normal completion is a no-op)."""
        t = self.wall_now()
        for i in range(self._pending_pos, len(self._pending)):
            r = self._pending[i]
            if r.rid == rid:
                # never admitted: no fluid slot, scheduler never saw it
                del self._pending[i]
                r.cancelled = True
                r.state = ReqState.FINISHED
                r.finish_time = t
                if self.obs is not None:
                    self.obs.cancel(r, t)
                return True
        for r in self.live:
            if r.rid == rid:
                if r.state == ReqState.RUNNING:
                    slot = r.engine_slot
                    self.kv.release(r)
                    self.slot_req.pop(slot, None)
                elif r.state == ReqState.SWAPPED:
                    self.kv.host_store.pop(r.rid, None)
                    self.kv.draft_store.pop(r.rid, None)
                r.cancelled = True
                r.state = ReqState.FINISHED
                r.finish_time = t
                r.prefill_cursor = 0
                self.sched.on_request_finish(r)
                self.live = [x for x in self.live if x is not r]
                self.stuck = False   # freed memory may unblock the rest
                if self.obs is not None:
                    self.obs.cancel(r, t)
                return True
        return False

    @property
    def pending(self) -> List[Request]:
        """Submitted-but-not-admitted requests (protocol view; the hot loop
        uses the cursor directly)."""
        return self._pending[self._pending_pos:]

    @property
    def has_work(self) -> bool:
        return self._pending_pos < len(self._pending) or bool(self.live)

    def hotpath_stats(self) -> dict:
        shapes = set(self._prefill.shapes_seen)
        if self.spec_k and self.draft.bucketed is not None:
            shapes |= self.draft.bucketed.shapes_seen
        return {
            "host_syncs": self.host_syncs,
            "dispatches": self.dispatches,
            "prefill_shapes": sorted(shapes),
            "prefill_compiles": len(shapes),
            "prefill_bucket_grid": list(self._prefill.buckets),
            "multi_step_blocks": self.multi_step_blocks,
            "multi_step_iters": self.multi_step_iters,
            "persistent_blocks": self.persistent_blocks,
            "persistent_iters": self.persistent_iters,
            "page_gathers": self.page_gathers,
            "page_scatters": self.page_scatters,
            "page_gather_bytes": self.page_gather_bytes,
        }

    # ---------------------------------------------------------------- clock
    def _tick(self, seconds: float) -> None:
        """Virtual: now += seconds. Wall: sleep off what the host left of
        the modeled duration, then stamp a real monotonic reading."""
        if self.clock == "virtual":
            self.now += seconds
        else:
            deadline = self.now + seconds
            w = time.monotonic() - self._wall0
            if deadline > w:
                tok = self.spans.begin("engine.tick_sleep")
                time.sleep(deadline - w)
                self.spans.end(tok)
                w = time.monotonic() - self._wall0
            self.now = w

    def wall_now(self) -> float:
        """Current time on this engine's clock for *external* events
        (arrival stamping by a live frontend): a fresh monotonic reading
        in wall mode, `self.now` in virtual mode."""
        if self.clock == "virtual":
            return self.now
        return time.monotonic() - self._wall0

    # -------------------------------------------------------------- prefill
    def _prompt_tokens(self, r: Request) -> np.ndarray:
        """Prompt (synthesized from the rid for token-less requests) plus
        any generated prefix (recompute resume)."""
        if r.prompt_tokens is None:
            rng = np.random.default_rng(r.rid)
            r.prompt_tokens = rng.integers(
                0, self.model.cfg.vocab_size, r.prompt_len
            ).astype(np.int32)
        return np.concatenate([
            np.asarray(r.prompt_tokens, np.int32),
            np.asarray(r.output_tokens[: r.generated], np.int32),
        ])

    def _frames_of(self, r: Request):
        """The request's encoder frames (None: zeros), for an
        encoder-decoder only."""
        return getattr(r, "frames", None) if self._prefill.enc_seq else None

    def _can_stage_prefill(self, r: Request) -> bool:
        if not self.hotpath.prefill_buckets or not self._prefill_bucketable:
            return False
        return r.generated > 0 or (self.eos_id < 0 and r.output_len > 1)

    def _stage_prefill(self, r: Request) -> _StagedPrefill:
        toks = self._prompt_tokens(r)
        slot = self.kv.allocate(r)
        self.slot_req[slot] = r
        self._tick(self.lat.prefill_latency(len(toks)))
        if self.obs is not None:
            self.obs.prefill(r, self.now, len(toks))
        emit_t = None
        if r.generated == 0:
            emit_t = self.now
            r.generated = 1
            r.emit_times.append(emit_t)
            self.fluid.emit(r.fluid_idx, emit_t, 1)
            self.kv.grow(r)
            self.total_tokens += 1
        return _StagedPrefill(r, slot, toks, emit_t, self._frames_of(r))

    # ------------------------------------------------------ chunked prefill
    def _should_chunk(self, r: Request) -> bool:
        return (self.prefill_chunk > 0
                and r.context_len > self.prefill_chunk
                and self._can_stage_prefill(r))

    def _stage_chunk(self, r: Request) -> _StagedPrefill:
        toks = self._prompt_tokens(r)
        total = len(toks)
        if r.prefill_cursor == 0:                  # admission: first chunk
            slot = self.kv.allocate(r, tokens=0)
            self.slot_req[slot] = r
        else:
            slot = r.engine_slot
        step = min(self.prefill_chunk, total - r.prefill_cursor)
        r.prefill_cursor += step
        self.kv.grow(r, step)
        self._tick(self.lat.prefill_chunk_latency(step, r.prefill_cursor))
        if self.obs is not None:
            self.obs.prefill_chunk(r, self.now, r.prefill_cursor, total)
        prefix = toks[: r.prefill_cursor]
        emit_t = None
        if r.prefill_cursor >= total:              # final chunk
            r.prefill_cursor = 0
            if self.obs is not None:
                self.obs.prefill(r, self.now, total)
            if r.generated == 0:
                emit_t = self.now
                r.generated = 1
                r.emit_times.append(emit_t)
                self.fluid.emit(r.fluid_idx, emit_t, 1)
                self.kv.grow(r)
                self.total_tokens += 1
        return _StagedPrefill(r, slot, prefix, emit_t, self._frames_of(r))

    def _flush_prefills(self, staged: List[_StagedPrefill]
                        ) -> Optional[float]:
        """Run every staged admission's device work; first-token emissions
        finalize in admission order. On the wall clock the `emit` hook of
        a staged first token gets the time the host holds the token,
        after its readback, which this returns (None on the virtual
        clock, where the hook gets the staging tick); `emit_times` and
        the fluid state keep the staging tick."""
        if not staged:
            return None
        writer = None
        if self.physical_pages:
            self._refresh_block_tables()
            writer = self._paged_writer
        slots = [rec.slot for rec in staged]
        self.cache, first, syncs, n_groups = self._prefill.prefill_into(
            self.params, self.cache, slots, [rec.toks for rec in staged],
            [rec.frames for rec in staged], write=writer,
            rids=[rec.req.rid for rec in staged])
        self._sync(syncs)
        self._dispatch("prefill", n_groups)
        self._dispatch("write", n_groups)
        if self.spec_k:
            # draft invariant committed[:-1]: the full staged context for
            # fresh prefills (their first token was committed at stage
            # time), minus the trailing token on a recompute resume
            n_draft = self.draft.prefill_batch(
                slots, [rec.toks if rec.emit_t is not None else rec.toks[:-1]
                        for rec in staged])
            self._dispatch("draft_prefill", n_draft)
            self._dispatch("write", n_draft)
        obs = self.obs
        t_held = self.wall_now() if self.clock != "virtual" else None
        for i, rec in enumerate(staged):
            if rec.emit_t is not None:
                rec.req.output_tokens.append(int(first[i]))
                if obs is not None:
                    obs.emit(rec.req, rec.emit_t if t_held is None
                             else t_held, 1)
        return t_held

    def _prefill_request(self, r: Request) -> None:
        """One request, one prefill, one slot write. With bucketed prefill
        on, the staged machinery applied to a single request; otherwise
        the eager exact-length path (the benchmark baseline)."""
        if self.hotpath.prefill_buckets and self._prefill_bucketable:
            rec = self._stage_prefill(r)
            t_held = self._flush_prefills([rec])
            if rec.emit_t is not None:
                tok = r.output_tokens[-1]
                if (r.generated >= r.output_len
                        or (self.eos_id >= 0 and tok == self.eos_id)):
                    self._finish(r, t_held)
            return
        toks = self._prompt_tokens(r)
        sp = self.spans
        call = self._prefill._begin_call((r.rid,), (len(toks),), len(toks))
        tok = sp.begin("prefill.cache_init")
        kv_dtype = (self.cache["k"].dtype if "k" in self.cache
                    else self.cache["ssm_conv"].dtype)
        enc_seq = self.model.enc_seq(self.max_seq)
        one = self.model.init_cache(1, self._cache_seq, enc_seq=enc_seq,
                                    dtype=kv_dtype)
        sp.end(tok)
        tok = sp.begin("prefill.stage")
        dev = self.model.device
        batch = {"tokens": torch.as_tensor(toks)[None].to(dev)}
        if enc_seq:
            batch["frames"] = frames_row(getattr(r, "frames", None), enc_seq,
                                         self.model.cfg.d_model)[None].to(dev)
        sp.end(tok)
        logits, one = self.model.prefill(self.params, batch, one)
        self._prefill.note_shape((1, len(toks)))
        self._dispatch("prefill")
        tok = sp.begin("prefill.write")
        slot = self.kv.allocate(r)
        if self.physical_pages:
            if r.generated == 0:
                # own the page under position len(toks) now: the first
                # emitted token's KV never lands there, so the decode
                # window reads whatever this scatter leaves (zeros from the
                # scratch row — the contiguous path's content)
                self.kv.ensure_pages(r, len(toks) + 1)
            self._refresh_block_tables()
            self.page_scatters += 1
            self.cache = _paged_commit(
                self.cache, torch.as_tensor(self._bt_host[[slot]]),
                torch.zeros((1,), dtype=torch.int32), one["k"], one["v"],
                torch.as_tensor([len(toks) + 1], dtype=torch.int32))
        else:
            self.cache = _write_slot(self.cache, one, slot)
        self._dispatch("write")
        sp.end(tok)
        self.slot_req[slot] = r
        if self.spec_k:
            # the draft holds committed[:-1]: a fresh request's first token
            # is emitted just below; a recompute resume drops its last
            # committed token, the next round's input
            self.draft.prefill(slot, toks if r.generated == 0 else toks[:-1])
            self._dispatch("draft_prefill")
            self._dispatch("write")
        self._tick(self.lat.prefill_latency(len(toks)))
        if self.obs is not None:
            self.obs.prefill(r, self.now, len(toks))
        if r.generated == 0:
            tok = sp.begin("prefill.readback")
            first = int(torch.argmax(logits[0]))
            sp.end(tok)
            self._sync()
            self._emit(r, first)
        sp.end(call)

    # ---------------------------------------------------------------- emit
    def _emit(self, r: Request, tok: int) -> None:
        r.output_tokens.append(tok)
        r.generated += 1
        r.emit_times.append(self.now)
        self.fluid.emit(r.fluid_idx, self.now, 1)
        self.kv.grow(r)
        self.total_tokens += 1
        if self.obs is not None:
            self.obs.emit(r, self.now, 1)
        done = (r.generated >= r.output_len
                or (self.eos_id >= 0 and tok == self.eos_id))
        if done:
            self._finish(r)

    def _emit_burst(self, r: Request, toks) -> int:
        """Commit a verify round's accepted tokens, all at self.now (one
        burst), truncated at output_len or EOS where one-token steps would
        have stopped. Returns the number emitted."""
        emitted = []
        for tok in toks:
            if r.generated >= r.output_len:
                break
            tok = int(tok)
            emitted.append(tok)
            r.output_tokens.append(tok)
            r.generated += 1
            r.emit_times.append(self.now)
            if self.eos_id >= 0 and tok == self.eos_id:
                break
        if emitted:
            self.fluid.emit(r.fluid_idx, self.now, len(emitted))
            self.kv.grow(r, len(emitted))
            self.total_tokens += len(emitted)
            if self.obs is not None:
                self.obs.emit(r, self.now, len(emitted))
        done = (r.generated >= r.output_len
                or (self.eos_id >= 0 and emitted
                    and emitted[-1] == self.eos_id))
        if done:
            self._finish(r)
        return len(emitted)

    def _finish(self, r: Request, t_held: Optional[float] = None) -> None:
        """`t_held`: the time the `emit` hook of the request's last token
        got (`_flush_prefills`), which its `finish` hook does not precede;
        `finish_time` keeps the engine's clock."""
        r.state = ReqState.FINISHED
        r.finish_time = self.now
        self.sched.on_request_finish(r)
        slot = r.engine_slot
        self.kv.release(r)
        self.slot_req.pop(slot, None)
        if self.obs is not None:
            self.obs.finish(r, self.now if t_held is None
                            else max(self.now, t_held))

    # ------------------------------------------------------------ preempt
    def _preempt(self, r: Request) -> None:
        r.preemptions += 1
        self.preemptions += 1
        slot = r.engine_slot
        if self.preemption_mode == "swap":
            sp = self.spans
            tok = sp.begin("engine.swap_out", {"rid": r.rid})
            self._dispatch("read")
            if self.physical_pages:
                # gather the victim's pages into one contiguous host row —
                # same leaf shapes and bytes as the `_read_slot` slice
                self._refresh_block_tables()
                host_slice = _paged_read_row(
                    self.cache, torch.as_tensor(self._bt_host[[slot]]), slot,
                    max_seq=self._cache_seq)
                self.page_gathers += 1
                self.page_gather_bytes += sum(
                    v.nbytes for k, v in host_slice.items() if k != "length")
            else:
                host_slice = _read_slot(self.cache, slot)
            self._sync()
            draft_slice = self.draft.park(slot) if self.spec_k else None
            self.kv.swap_out(r, host_slice, draft_slice)
            sp.end(tok)
            r.state = ReqState.SWAPPED
            self._tick(self.lat.swap_latency(
                r.prefill_cursor or r.context_len))
        else:
            self.kv.drop(r)
            r.state = ReqState.WAITING
            r.prefilled = False
            r.prefill_cursor = 0        # recompute rewinds the chunk cursor
        self.slot_req.pop(slot, None)
        self.sched.record_preemptions(1)
        if self.obs is not None:
            self.obs.preempt(r, self.now, self.preemption_mode)

    def _swap_in(self, r: Request) -> None:
        tok = self.spans.begin("engine.swap_in", {"rid": r.rid})
        host_slice = self.kv.swap_in(r)
        draft_slice = self.kv.swap_in_draft(r)
        slot = self.kv.allocate(r, tokens=(r.prefill_cursor or None))
        if self.physical_pages:
            self._refresh_block_tables()
            self.page_scatters += 1
            dev = self.cache["k"].device
            self.cache = _paged_commit(
                self.cache, torch.as_tensor(self._bt_host[[slot]]),
                torch.zeros((1,), dtype=torch.int32),
                host_slice["k"].to(dev), host_slice["v"].to(dev),
                torch.as_tensor([r.prefill_cursor or r.context_len],
                                dtype=torch.int32))
        else:
            self.cache = _write_slot(self.cache, host_slice, slot)
        self._dispatch("write")
        if draft_slice is not None:
            self.draft.restore(slot, draft_slice)
            self._dispatch("write")
        self.spans.end(tok)
        self.slot_req[slot] = r
        r.state = ReqState.RUNNING
        self._tick(self.lat.swap_latency(r.prefill_cursor or r.context_len))
        if self.obs is not None:
            self.obs.swap_in(r, self.now)

    # ------------------------------------------------------- speculative
    def _make_spec_fused(self):
        """One speculative round on the device: draft propose, window
        concat, target verify, greedy argmax and the accepted-prefix
        length (cumprod of matches), so `_speculative_iteration` syncs
        once on three small int tensors instead of (slots, k+1, vocab)
        logits."""
        model, k = self.model, self.spec_k
        dmodel = self.draft.model

        def fn(params, dparams, tokens, target_cache, draft_cache):
            props, draft_cache = dmodel.propose_step(dparams, tokens,
                                                     draft_cache, k)
            window = torch.cat([tokens[:, None], props[:, :k]], dim=1)
            logits, target_cache = model.verify_step(params, window,
                                                     target_cache)
            greedy, accepted = _accept(window, logits, k)
            return window, greedy, accepted, target_cache, draft_cache

        return fn

    def _make_spec_block(self):
        """`_make_spec_fused`'s round, run exactly `s` times (s a host int;
        the reference's device while_loop). Each round re-pins both caches'
        length gates as the host does between single rounds — the target
        holds the committed context, the draft committed[:-1] — then
        advances the committed length by accepted + 1 and feeds the
        correction/bonus token to the next round's draft. Lengths, counts
        and tokens stay on the device; returns the per-round windows,
        greedy ids and accepted counts, (s, B, k+1) / (s, B)."""
        round_ = self._make_spec_fused()

        def fn(params, dparams, tokens, lengths, tcache, dcache, s):
            tok, ln = tokens, lengths
            ws, gs, accs = [], [], []
            for _ in range(s):
                dcache = dict(dcache, length=torch.clamp(ln - 1, min=0))
                tcache = dict(tcache, length=ln)
                window, greedy, accepted, tcache, dcache = round_(
                    params, dparams, tok, tcache, dcache)
                tok = greedy.gather(1, accepted[:, None].long())[:, 0]
                ln = ln + accepted + 1
                ws.append(window)
                gs.append(greedy)
                accs.append(accepted)
            return (torch.stack(ws), torch.stack(gs), torch.stack(accs),
                    tcache, dcache)

        return fn

    def _spec_block_plan(self, active) -> int:
        """Rounds of speculative verify that may run unsupervised in one
        dispatch — the decode `_multi_step_plan` adapted to an
        acceptance-dependent clock (reference docstring): the idle_steps
        certificate is spent in tokens (a round commits up to k+1), the
        block is sized so neither output_len nor max_seq can truncate it,
        and the latency trigger is re-checked at the acceptance floor.
        Returns 1 when any condition fails."""
        cap = self.hotpath.multi_step
        if cap <= 1 or not self.hotpath.persistent:
            return 1
        if not self.hotpath.fused_sampling:
            return 1
        if self.clock != "virtual" and not self.hotpath.wall_multi_step:
            return 1
        if len(active) != len(self.live):
            return 1
        if not self._rollback_ok:
            return 1
        k1 = self.spec_k + 1
        s_max = min(
            cap,
            min((r.output_len - r.generated) // k1 for r in active.values()),
            min((self.max_seq - r.context_len) // k1
                for r in active.values()))
        if s_max < 2:
            return 1
        stiffest = max((r.spec.tds for r in active.values()), default=0.0)
        if stiffest > 0 and \
                self.lat.iter_latency(len(self.live)) > 1.0 / stiffest:
            return 1
        s_tok = self.sched.idle_steps(self.live, s_max * k1 - 1) + 1
        s_max = min(s_max, s_tok // k1)
        return s_max if s_max >= 2 else 1

    def _commit_round(self, items, window, greedy, accepted) -> int:
        """Commit one round's bursts, slot by slot in `items` order, with
        the reference's acceptance bookkeeping; returns the accepted
        total."""
        k = self.spec_k
        step_accepted = 0
        for slot, r in items:
            d, g = window[slot, 1:], greedy[slot]
            a = int(accepted[slot])
            # logical max_seq bound: committed context never exceeds what
            # a baseline engine could hold
            m_safe = max(1, self.max_seq - r.context_len)
            toks = (list(d[:a]) + [int(g[a])])[:m_safe]
            self.spec_steps += 1
            self.spec_proposed += k
            self.spec_accepted += a
            step_accepted += a
            if hasattr(self.lat, "observe_acceptance"):
                self.lat.observe_acceptance(a)
            self._emit_burst(r, toks)
        return step_accepted

    def _speculative_block(self, active, lengths, tokens, s: int,
                           until: Optional[float]) -> int:
        """Run `s` speculative rounds in one dispatch and replay the
        acceptance-dependent clock on the host off one sync: round r's
        tick is priced at the context the ledger reached after round
        r-1's commits, as single rounds do. Returns rounds committed (< s
        when an EOS landed, a pending arrival came due, or the driver's
        `until` was crossed: the tail is discarded and both length gates
        roll the caches back)."""
        k = self.spec_k
        dev = self.model.device
        span = self._begin_decode(s, len(active))
        # the block pins both caches' lengths itself, round by round
        W, G, A, self.cache, self.draft.cache = self._spec_block(
            self.params, self.draft.params, torch.as_tensor(tokens).to(dev),
            torch.as_tensor(lengths).to(dev), self.cache, self.draft.cache,
            s)
        self._dispatch("spec_block")
        n_w = W.numel()
        host = torch.cat([W.reshape(-1), G.reshape(-1),
                          A.reshape(-1)]).cpu().numpy()   # ONE sync
        W = host[:n_w].reshape(W.shape)
        G = host[n_w:2 * n_w].reshape(G.shape)
        A = host[2 * n_w:].reshape(A.shape)
        self._sync()
        self.spans.end(span)
        self.multi_step_blocks += 1
        self.persistent_blocks += 1
        items = list(active.items())
        b = len(items)
        committed = 0
        for rnd in range(s):
            if rnd:
                self.batch_sizes.append(b)
            ctx = sum(r.context_len for _slot, r in items)
            self._tick(self.lat.iter_latency(b, ctx))
            step_accepted = self._commit_round(items, W[rnd], G[rnd], A[rnd])
            finished = any(not r.is_live for _slot, r in items)
            if self.obs is not None:
                self.obs.spec(self.now, k * b, step_accepted)
            committed += 1
            if committed < s:
                if finished:
                    break
                if (self._pending_pos < len(self._pending)
                        and self._pending[self._pending_pos].arrival
                        <= self.now):
                    break
                if until is not None and not (self.now < until):
                    break
        self.multi_step_iters += committed
        self.persistent_iters += s
        self.sched.skip_iterations(committed - 1)
        if self.obs is not None:
            self.obs.multi_step(self.now, s, committed)
            self.obs.persistent_loop(self.now, s, s)
        return committed

    def _speculative_iteration(self, active, lengths, tokens,
                               total_ctx: int) -> None:
        """Draft-propose k tokens per running slot, verify the window in
        the target, commit the longest greedy-matching prefix plus the
        correction/bonus token (lossless; 1..k+1 tokens per round)."""
        k = self.spec_k
        # the draft holds committed[:-1]: its next write goes one position
        # below the target's
        draft_lengths = np.maximum(lengths - 1, 0).astype(np.int32)
        dev = self.model.device
        span = self._begin_decode(1, len(active))
        if self.hotpath.fused_sampling:
            self.draft.cache = cache_lib.with_lengths(self.draft.cache,
                                                      draft_lengths)
            window, greedy, accepted, self.cache, self.draft.cache = \
                self._spec_fused(self.params, self.draft.params,
                                 torch.as_tensor(tokens).to(dev),
                                 self.cache, self.draft.cache)
            self._dispatch("spec_fused")
            self._tick(self.lat.iter_latency(len(active), total_ctx))
            t = window.shape[1]
            host = torch.cat([window, greedy, accepted[:, None]],
                             dim=1).cpu().numpy()       # ONE sync
            window, greedy = host[:, :t], host[:, t:2 * t]
            accepted = host[:, 2 * t]
            self._sync()
        else:
            proposals = self.draft.propose(tokens, draft_lengths, k)
            self._dispatch("propose")
            self._sync()
            window = np.concatenate([tokens[:, None], proposals], axis=1)
            logits, self.cache = self._verify(
                self.params, torch.as_tensor(window).to(dev), self.cache)
            self._dispatch("verify")
            # one round's cost: k+1 draft decodes and the verify (the
            # SpeculativeLatencyModel's iter_latency)
            self._tick(self.lat.iter_latency(len(active), total_ctx))
            greedy = torch.argmax(logits, dim=-1).cpu().numpy()
            self._sync()
            accepted = np.zeros(len(window), np.int64)
            for s in active:
                d, g = window[s, 1:], greedy[s]
                a = 0
                while a < k and d[a] == g[a]:
                    a += 1
                accepted[s] = a
        self.spans.end(span)
        step_accepted = self._commit_round(list(active.items()), window,
                                           greedy, accepted)
        if self.obs is not None:
            self.obs.spec(self.now, k * len(active), step_accepted)

    def spec_stats(self) -> dict:
        """Acceptance-side counters (speculative engines only)."""
        return {
            "spec_k": self.spec_k,
            "spec_steps": self.spec_steps,
            "proposed": self.spec_proposed,
            "accepted": self.spec_accepted,
            "acceptance_rate": (self.spec_accepted / self.spec_proposed
                                if self.spec_proposed else 0.0),
        }

    # ------------------------------------------------------ multi-step decode
    def _multi_step_plan(self, active, total_ctx: int,
                         until: Optional[float]) -> int:
        """Largest j for which running j decode iterations unsupervised is
        provably identical to single-stepping (reference docstring).
        Returns 1 whenever any condition fails."""
        cap = self.hotpath.multi_step
        if cap <= 1 or self.spec_k:
            return 1
        if self.clock != "virtual" and not (
                self.hotpath.wall_multi_step and self._rollback_ok):
            return 1
        if len(active) != len(self.live):
            return 1
        if self.eos_id >= 0 and not self._rollback_ok:
            return 1
        margin = min(r.output_len - r.generated for r in active.values())
        j_max = min(cap, margin)
        if j_max < 2:
            return 1
        j_max = min(j_max, self.sched.idle_steps(self.live, j_max - 1) + 1)
        if j_max < 2:
            return 1
        bound = np.inf
        if self._pending_pos < len(self._pending):
            bound = self._pending[self._pending_pos].arrival
        if until is not None:
            bound = min(bound, until)
        j = 1
        if bound != np.inf:
            t = self.now
            ticks = self.lat.iter_latency_schedule(
                len(active), total_ctx, j_max)
            while j < j_max:
                t = t + ticks[j - 1]                    # end of step j
                if not (t < bound):
                    break
                j += 1
        else:
            j = j_max
        if j < 2:
            return 1
        if self.hotpath.persistent:
            return j
        return 1 << (j.bit_length() - 1)        # power-of-two grid

    def _commit_block(self, active, ids, total_ctx: int, j: int) -> int:
        """Replay a block's per-step bookkeeping exactly as the one-step
        loop performs it. Returns iterations committed."""
        items = list(active.items())
        b = len(items)
        ticks = self.lat.iter_latency_schedule(b, total_ctx, j)
        committed = 0
        for s in range(j):
            if s:
                self.batch_sizes.append(b)
            self._tick(ticks[s])
            finished = False
            for slot, r in items:
                self._emit(r, int(ids[s, slot]))
                finished = finished or not r.is_live
            committed += 1
            if committed < j:
                if finished:
                    break
                if (self.clock != "virtual"
                        and self._pending_pos < len(self._pending)
                        and self._pending[self._pending_pos].arrival
                        <= self.now):
                    break
        return committed

    def _multi_step_decode(self, active, tokens, total_ctx: int,
                           j: int) -> int:
        span = self._begin_decode(j, len(active))
        ids, self.cache = self._decode_multi(
            self.params, torch.as_tensor(tokens).to(self.model.device),
            self.cache, j)
        self._dispatch("decode_multi")
        ids = ids.cpu().numpy()                 # ONE sync for j iterations
        self._sync()
        self.spans.end(span)
        self.multi_step_blocks += 1
        committed = self._commit_block(active, ids, total_ctx, j)
        self.multi_step_iters += committed
        self.sched.skip_iterations(committed - 1)
        if self.obs is not None:
            self.obs.multi_step(self.now, j, committed)
        return committed

    def _persistent_decode(self, active, tokens, total_ctx: int,
                           j: int) -> int:
        span = self._begin_decode(j, len(active))
        ids, self.cache, steps = self._decode_persist(
            self.params, torch.as_tensor(tokens).to(self.model.device),
            self.cache, j, j_cap=self.hotpath.multi_step)
        self._dispatch("decode_persistent")
        ids = ids.cpu().numpy()                 # ONE sync for the block
        self._sync()
        self.spans.end(span)
        self.multi_step_blocks += 1
        self.persistent_blocks += 1
        committed = self._commit_block(active, ids, total_ctx, j)
        self.multi_step_iters += committed
        self.persistent_iters += int(steps)
        self.sched.skip_iterations(committed - 1)
        if self.obs is not None:
            self.obs.multi_step(self.now, j, committed)
            self.obs.persistent_loop(self.now, j, int(steps))
        return committed

    # ----------------------------------------------------------- main loop
    def _admit_arrivals(self) -> None:
        pend = self._pending
        pos = self._pending_pos
        obs = self.obs
        while pos < len(pend) and pend[pos].arrival <= self.now:
            r = pend[pos]
            pos += 1
            r.fluid_idx = self.fluid.add(r.arrival, r.spec)
            r.state = ReqState.WAITING
            self.live.append(r)
            self.sched.on_request_arrival(r)
            if obs is not None:
                obs.admit(r, self.now)
        self._pending_pos = pos
        if pos and pos * 2 >= len(pend):
            del pend[:pos]
            self._pending_pos = 0

    def step(self, until: Optional[float] = None) -> bool:
        """One continuous-batching iteration (schedule → preempt →
        swap-in/prefill → decode over all occupied slots). Returns False
        when there is nothing left to do."""
        if self.stuck or not self.has_work:
            return False
        if not self.live and self._pending_pos < len(self._pending):
            nxt = self._pending[self._pending_pos].arrival
            if self.clock != "virtual" and nxt > self.now:
                w = time.monotonic() - self._wall0
                if nxt > w:
                    time.sleep(nxt - w)
                self.now = max(self.now, time.monotonic() - self._wall0)
            else:
                self.now = max(self.now, nxt)
        sp = self.spans
        tok = sp.begin("engine.step")
        try:
            return self._iterate(until)
        finally:
            sp.end(tok)

    def _iterate(self, until: Optional[float]) -> bool:
        """`step()`'s work once the clock has reached an arrival."""
        self._admit_arrivals()
        if not self.live:
            return True

        tok = self.spans.begin("engine.schedule")
        target = self.sched.schedule(self.now, self.live, self.fluid)
        self.spans.end(tok)
        target_ids = {id(r) for r in target}

        n_preempted = 0
        for r in list(self.slot_req.values()):
            if id(r) not in target_ids and r.state == ReqState.RUNNING:
                self._preempt(r)
                n_preempted += 1
        n_admitted = 0
        staged: List[_StagedPrefill] = []
        for r in target:
            if r.state == ReqState.SWAPPED and self.kv.can_allocate(
                    r, tokens=(r.prefill_cursor or None)):
                self._swap_in(r)
                n_admitted += 1
            elif r.state == ReqState.RUNNING and r.prefill_cursor:
                staged.append(self._stage_chunk(r))
                n_admitted += 1
            elif r.state == ReqState.WAITING:
                if self._should_chunk(r):
                    if self.kv.can_allocate(r, tokens=self.prefill_chunk):
                        r.state = ReqState.RUNNING
                        r.prefilled = True
                        staged.append(self._stage_chunk(r))
                        n_admitted += 1
                elif self.kv.can_allocate(r):
                    r.state = ReqState.RUNNING
                    r.prefilled = True
                    if self._can_stage_prefill(r):
                        staged.append(self._stage_prefill(r))
                    else:
                        self._flush_prefills(staged)
                        staged = []
                        self._prefill_request(r)
                    n_admitted += 1
        self._flush_prefills(staged)

        # ---- decode over all occupied slots ---------------------------
        active = {s: r for s, r in self.slot_req.items()
                  if r.state == ReqState.RUNNING and not r.prefill_cursor}
        self.batch_sizes.append(len(active))
        committed_iters = 1
        if active:
            lengths = np.zeros(self.kv.num_slots, np.int32)
            tokens = np.zeros(self.kv.num_slots, np.int32)
            for s, r in active.items():
                lengths[s] = r.context_len
                tokens[s] = r.output_tokens[-1] if r.output_tokens else 0
            self.cache = cache_lib.with_lengths(self.cache, lengths)
            total_ctx = int(lengths.sum())
            if self.spec_k:
                s_rounds = self._spec_block_plan(active)
                if s_rounds > 1:
                    committed_iters = self._speculative_block(
                        active, lengths, tokens, s_rounds, until)
                else:
                    self._speculative_iteration(active, lengths, tokens,
                                                total_ctx)
            else:
                j = self._multi_step_plan(active, total_ctx, until)
                if self.physical_pages:
                    # pre-reserve every page the block will write (step s
                    # writes position ctx+s), then pin the tables
                    for _s, r in active.items():
                        self.kv.ensure_pages(
                            r, min(r.context_len + j, self._cache_seq))
                    self._refresh_block_tables()
                if j > 1:
                    if self.hotpath.persistent:
                        committed_iters = self._persistent_decode(
                            active, tokens, total_ctx, j)
                    else:
                        committed_iters = self._multi_step_decode(
                            active, tokens, total_ctx, j)
                    if self.physical_pages:
                        for r in list(active.values()):
                            if r.is_live:
                                self.kv.trim_pages(r)
                else:
                    span = self._begin_decode(1, len(active))
                    dev_tokens = torch.as_tensor(tokens).to(self.model.device)
                    if self.hotpath.fused_sampling:
                        ids, self.cache = self._decode_tok(
                            self.params, dev_tokens, self.cache)
                        self._dispatch("decode")
                        self._tick(self.lat.iter_latency(len(active),
                                                         total_ctx))
                        nxt = ids.cpu().numpy()
                    else:
                        logits, self.cache = self._decode(
                            self.params, dev_tokens, self.cache)
                        self._dispatch("decode")
                        self._tick(self.lat.iter_latency(len(active),
                                                         total_ctx))
                        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
                    self._sync()
                    self.spans.end(span)
                    for s, r in list(active.items()):
                        self._emit(r, int(nxt[s]))
        else:
            self._tick(self.lat.hw.overhead)

        self.iterations += committed_iters
        self.live = [r for r in self.live if r.is_live]
        n_live = len(self.live)
        self._admit_arrivals()
        newly_arrived = len(self.live) > n_live

        # ---- deadlock guard: nothing moved and nothing can arrive -------
        if not active and not n_admitted and not n_preempted \
                and not newly_arrived \
                and self._pending_pos >= len(self._pending):
            self.stuck = True
            return False
        return True

    def result(self) -> SimResult:
        return SimResult(
            requests=list(self.seen),
            makespan=self.now,
            total_tokens=self.total_tokens,
            preemptions=self.preemptions,
            iterations=self.iterations,
            batch_sizes=self.batch_sizes,
        )

    def run(self, workload: List[Request], max_iterations: int = 100_000):
        """Serve the workload to completion (reset + submit all + step
        until drained). Returns the requests."""
        self.reset()
        for r in sorted(workload, key=lambda r: r.arrival):
            self.submit(r)
        while self.iterations < max_iterations:
            if not self.step():
                break
        return workload
