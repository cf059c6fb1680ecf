"""Unified model API: init / train / prefill / decode.

  model = Model(cfg, device="cuda")
  params = model.init(torch.Generator("cuda").manual_seed(0), torch.bfloat16)
  logits, aux = model.forward_train(params, batch)
  loss = model.loss(params, batch)       # differentiable (torch autograd)
  cache = model.init_cache(batch=B, max_seq=S)
  logits, cache = model.prefill(params, {"tokens": t, "lengths": n}, cache)
  logits, cache = model.decode_step(params, tokens, cache)
  logits, cache = model.verify_step(params, window, cache)   # speculative
  proposals, cache = model.propose_step(params, tokens, cache, k)
  params = model.abstract_params()        # meta tensors: shapes, dtypes
  specs = model.input_specs(get_shape("decode_32k"))

The counterpart of ``src/repro/models/model.py`` for every family:
dense, vlm (a vision-patch prefix), moe, ssm (Mamba-1), hybrid (Mamba-2
+ shared attention) and the encoder-decoders (encdec, audio), whose
caches hold `enc_seq(max_seq)` positions of encoder memory:

  cache = model.init_cache(B, S, enc_seq=model.enc_seq(S))
  logits, cache = model.prefill(params, {"tokens": t, "frames": f}, cache)

Params are the reference's stacked tree as a dict of tensors
(``repro_torch.bridge``). Caches are updated in place.

With ``kv_repeat`` r > 1 (KV-head replication up to the tensor-parallel
degree, the reference's serving option) the serving entry points repeat
each k/v head r times after the projections and the caches hold
KV * r heads; ``forward_train`` and ``loss`` do not take it, as the
reference's do not.

With ``moe_ep_mesh`` (a ``DeviceMesh`` with a ``model`` axis) a moe
model's prefill and training forwards run expert-parallel
(``distributed.moe_ep.moe_apply_ep``): each rank passes its data shard
of the batch and holds the full params, of which it runs its E/tp
experts. Decode keeps ``moe_apply``, as the reference's does.

A prefill into a cache its caller holds (``hold_cache``: the bucketed
path's, one per row count, zeroed before each call) runs, on CUDA and
for the kinds in ``GRAPH_KINDS``, from a CUDA graph of its shape: the
first call of a shape runs eagerly on a side stream and captures the
same forward; every later one copies tokens and lengths into the graph's
static inputs and replays it (``Model.prefill``).
"""
from __future__ import annotations

import gc
import weakref
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import cuda as cuda_kernels
from repro_torch.models import cache as cache_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import unembed
from repro_torch.obs import spans as spans_lib


def _argmax_ids(logits: torch.Tensor) -> torch.Tensor:
    # first max wins on ties, as jnp.argmax
    return torch.argmax(logits, dim=-1).to(torch.int32)


#: kinds whose prefill forward into a held cache is captured once per
#: shape as a CUDA graph and replayed bitwise (tests/test_torch_cuda.py
#: holds each against the eager call on the card)
GRAPH_KINDS = ("dense",)

# ``model.prefill``'s payloads: replayed from a graph, or run eagerly (a
# capture's call included: its outputs are its eager warm-up's)
_EAGER = {"graph": 0}
_REPLAY = {"graph": 1}


def _leaves(tree):
    """The tensors of a params tree, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class _PrefillGraph:
    """One captured prefill forward: its static inputs, the graph, the
    outputs each replay overwrites (the logits and the cache leaves the
    forward returns anew) and the kernel launches a replay runs."""

    def __init__(self, inputs, graph, logits, leaves, launches):
        self.inputs = inputs
        self.graph = graph
        self.logits = logits
        self.leaves = leaves
        self.launches = launches

    def replay(self, batch, cache):
        for key, t in self.inputs.items():
            t.copy_(batch[key])
        self.graph.replay()
        cuda_kernels.add_launches(self.launches)
        return self.logits, dict(cache, **self.leaves)


class Model:
    def __init__(self, cfg: ModelConfig, *, window: Optional[int] = None,
                 moe_seq_chunk: int = 0, remat: bool = False,
                 moe_ep_mesh=None, kv_repeat: int = 1, device="cuda"):
        tfm.check_kind(cfg)
        self.cfg = cfg
        self.window = window
        # per-layer rematerialisation under autograd (transformer.remat_call)
        self.remat = remat
        # sequence-chunked MoE dispatch (moe.moe_apply_chunked); 0 = one
        # capacity over the whole call, the reference's default
        self.moe_seq_chunk = moe_seq_chunk
        # expert-parallel dispatch over this mesh's model axis
        # (distributed/moe_ep.py); None = moe_apply on every rank
        self.moe_ep_mesh = moe_ep_mesh
        # KV-head replication; 1 = the paper-faithful baseline
        self.kv_repeat = kv_repeat
        self.device = resolve_device(device)
        # id of each held cache's `length` leaf (while it lives) ->
        # {call key: graph}
        self._graphs = {}
        self._graph_pool = None         # one memory pool for every shape
        self._capture_stream = None

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator, dtype=torch.float32):
        from repro_torch.bridge import init_params
        return init_params(self.cfg, generator, self.device, dtype)

    def abstract_params(self, dtype=torch.float32):
        """`init`'s tree as ``meta`` tensors (shapes and dtypes, nothing
        drawn or allocated): the reference's ``jax.eval_shape`` of its
        init."""
        from repro_torch.bridge import abstract_params
        return abstract_params(self.cfg, dtype)

    # ----------------------------------------------------------------- train
    def forward_train(self, params, batch):
        """batch {"tokens" (B, S)} plus "patch_embeds" (vlm) or "frames"
        (encoder-decoder) -> (logits (B, S, V), aux)."""
        return tfm.forward(params, self.cfg, batch, window=self.window,
                           remat=self.remat,
                           moe_seq_chunk=self.moe_seq_chunk,
                           moe_ep_mesh=self.moe_ep_mesh)

    def loss(self, params, batch, *, ce_chunk: int = 1024):
        """Next-token cross-entropy (labels < 0 masked) + the MoE aux loss,
        as ``src/repro/models/model.py:Model.loss``: the CE runs over
        sequence chunks (`ce_chunk`, halved until it divides S), each
        checkpointed under remat, so the (tokens, vocab) logits never
        exist beyond one chunk. Returns tot / max(cnt, 1) + aux, a f32
        scalar."""
        h, aux = tfm.forward(params, self.cfg, batch, window=self.window,
                             remat=self.remat, return_hidden=True,
                             moe_seq_chunk=self.moe_seq_chunk,
                             moe_ep_mesh=self.moe_ep_mesh)
        labels = batch["labels"]
        s = h.shape[1]
        chunk = min(ce_chunk, s)
        while s % chunk:
            chunk //= 2

        def ce(hc, lc):
            logits = unembed(params, hc).float()
            mask = lc >= 0
            lab = torch.clamp(lc, min=0).long()
            nll = -torch.log_softmax(logits, dim=-1).gather(
                -1, lab[..., None])[..., 0]
            return (torch.where(mask, nll, torch.zeros_like(nll)).sum(),
                    mask.sum().float())

        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for c0 in range(0, s, chunk):
            t, n = tfm.remat_call(ce, self.remat, h[:, c0:c0 + chunk],
                              labels[:, c0:c0 + chunk])
            tot, cnt = tot + t, cnt + n
        return tot / torch.clamp(cnt, min=1.0) + aux

    # ----------------------------------------------------------------- serve
    def enc_seq(self, max_seq: int) -> int:
        """Encoder-memory depth a serving cache reserves beside a
        `max_seq`-token decoder context (0 for every kind but encdec and
        audio). The one copy of the ratio: the engine's cache and both its
        prefill paths size the frames by it."""
        return max_seq // 4 if self.cfg.kind in tfm.ENCDEC_KINDS else 0

    def init_cache(self, batch: int, max_seq: int, *, enc_seq: int = 0,
                   dtype=torch.float32, abstract: bool = False):
        return cache_lib.init_cache(self.cfg, batch, max_seq,
                                    enc_seq=enc_seq, dtype=dtype,
                                    device=self.device, abstract=abstract,
                                    kv_repeat=self.kv_repeat)

    def hold_cache(self, batch: int, max_seq: int, *, enc_seq: int = 0,
                   dtype=torch.float32):
        """``init_cache``'s zeroed cache, registered as one its caller
        holds and reuses for every prefill of `batch` rows, zeroing each
        leaf before each call (the bucketed path's,
        ``serving.engine.BucketedPrefill``). A prefill into it may run from
        a CUDA graph (``prefill``); the graphs live as long as the cache."""
        cache = self.init_cache(batch, max_seq, enc_seq=enc_seq, dtype=dtype)
        length = cache["length"]
        self._graphs[id(length)] = {}
        weakref.finalize(length, self._graphs.pop, id(length), None)
        return cache

    def supports_physical_paging(self) -> bool:
        return cache_lib.supports_physical_paging(self.cfg)

    def init_paged_cache(self, batch: int, num_pages: int, page_size: int,
                         max_seq: int, *, dtype=torch.float32,
                         abstract: bool = False):
        return cache_lib.init_paged_cache(
            self.cfg, batch, num_pages, page_size, max_seq, dtype=dtype,
            device=self.device, abstract=abstract, kv_repeat=self.kv_repeat)

    def prefill(self, params, batch, cache):
        """Run the prompt, fill the cache, return last-token logits.

        batch: {"tokens": (B, S) [, "lengths": (B,)]} plus, for a vlm,
        "patch_embeds" (B, P, d) and, for an encoder-decoder, "frames"
        (B, Se, d) [, "enc_lengths" (B,), default Se]. cache from
        init_cache (depth >= P + S): k/v written in place at positions
        [0, P + S) — the whole padded row, as the reference's
        dynamic_update_slice — the ssm leaves with each row's state at
        its last valid token, and an encoder-decoder's cross planes and
        enc_length replaced. Writes cast to the cache's dtypes. The
        cache's length counts a vlm's P prefix positions; the logits are
        those of each row's last text position.
        Returns (logits (B, V), cache').

        Into a held cache (``hold_cache``) on CUDA, for a kind in
        GRAPH_KINDS, with tokens and lengths alone and nothing requiring
        grad (``_graph_slot``, the one place that decides), the call runs
        from a CUDA graph of its shape and the params' storage: the
        first such call runs the forward eagerly and captures it
        (``_capture``), every later one replays it. A replay runs the
        eager call's kernels in its order on the current stream, so its
        outputs are bitwise the eager call's; the logits and the
        returned ``length`` are the graph's, which the next replay of any
        shape may overwrite: consume them first, on the same stream.
        Every other call runs the eager body.

        Called with a span open in a log on this thread (the engine's
        ``engine.prefill_call``), it writes ``model.prefill`` there, the
        enqueue of the whole call, payload ``{"graph": 1}`` for a replay
        and ``{"graph": 0}`` otherwise; on an eager call (a capture's
        included) ``model.cache_fill``, the copies of the layers' planes
        into the cache, inside it; and the counters
        ``prefill.graph_captures`` and ``prefill.graph_replays``."""
        log = spans_lib.active()
        graphs, key = self._graph_slot(params, batch, cache)
        graph = graphs.get(key) if graphs is not None else None
        span = spans_lib.begin(log, "model.prefill",
                               _EAGER if graph is None else _REPLAY)
        if graphs is None:
            out = self._prefill(params, batch, cache, log)
        elif graph is None:
            graphs[key], out = self._capture(params, batch, cache, log)
        else:
            out = graph.replay(batch, cache)
        if log is not None and graphs is not None:
            log.count(("prefill.graph_captures" if graph is None
                       else "prefill.graph_replays", 1))
        spans_lib.end(log, span)
        return out

    def _graph_slot(self, params, batch, cache):
        """(the held cache's graphs, the call's key) when the call runs
        from a graph, else (None, None): the device is CUDA, the kind in
        GRAPH_KINDS, the cache held (``hold_cache``), the batch tokens and
        lengths alone, and grad mode off or no param requiring grad. The
        key is the inputs' shapes and dtypes and the params' storage."""
        if self.cfg.kind not in GRAPH_KINDS or self.device.type != "cuda":
            return None, None
        graphs = self._graphs.get(id(cache["length"]))
        if graphs is None or batch.keys() != {"tokens", "lengths"}:
            return None, None
        leaves = list(_leaves(params))
        if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
            return None, None
        tokens, lengths = batch["tokens"], batch["lengths"]
        key = (tuple(tokens.shape), tokens.dtype, tuple(lengths.shape),
               lengths.dtype, tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                                    for t in leaves))
        return graphs, key

    def _capture(self, params, batch, cache, log):
        """The first call of a shape: the forward eagerly on the capture
        stream, which is the warm-up a capture needs and gives this call's
        outputs, then the same forward captured on that stream into a
        graph in the model's one memory pool. The captured launches run
        nothing, so they leave the launch counters as they were and are
        added on each replay. The garbage collector is off while it
        captures. A failed capture raises.
        Returns (the graph, this call's outputs)."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        stream, main = self._capture_stream, torch.cuda.current_stream()
        inputs = {key: t.clone() for key, t in batch.items()}
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            logits, out = self._prefill(params, inputs, cache, log)
        graph = torch.cuda.CUDAGraph()
        # a collection during the capture could free another graph (an
        # engine's cycles hold them), which a capture forbids; the
        # capture's entry collects first
        collecting = gc.isenabled()
        gc.disable()
        try:
            with cuda_kernels.recorded_launches() as launches, \
                    torch.cuda.graph(graph, pool=self._graph_pool,
                                     stream=stream,
                                     capture_error_mode="thread_local"):
                g_logits, g_out = self._prefill(params, inputs, cache, None)
        finally:
            if collecting:
                gc.enable()
        main.wait_stream(stream)
        fresh = {k: t for k, t in out.items() if cache.get(k) is not t}
        for t in (logits, *fresh.values()):
            t.record_stream(main)
        g_fresh = {k: t for k, t in g_out.items() if cache.get(k) is not t}
        return (_PrefillGraph(inputs, graph, g_logits, g_fresh, launches),
                (logits, out))

    def _prefill(self, params, batch, cache, log):
        """``prefill``'s eager body, writing ``model.cache_fill`` into
        `log` (None: nowhere)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        lengths = batch.get("lengths")
        if lengths is None:
            lengths = torch.full((b,), s, dtype=torch.int32,
                                 device=tokens.device)
        n_patch = 0
        if cfg.kind == "vlm" and "patch_embeds" in batch:
            n_patch = batch["patch_embeds"].shape[1]
        ctx_lengths = lengths + n_patch     # cache positions incl. patches
        h, _, parts = tfm.forward(params, cfg, batch, window=self.window,
                                  collect_cache=True, lengths=ctx_lengths,
                                  return_hidden=True,
                                  moe_seq_chunk=self.moe_seq_chunk,
                                  moe_ep_mesh=self.moe_ep_mesh,
                                  kv_repeat=self.kv_repeat)
        fill = spans_lib.begin(log, "model.cache_fill")
        for key in ("k", "v"):
            for i, part in enumerate(parts.get(key, ())):
                cache[key][i, :, :part.shape[1]] = part
        for key in ("ssm_h", "ssm_conv"):
            for i, part in enumerate(parts.get(key, ())):
                cache[key][i] = part
        spans_lib.end(log, fill)
        if cfg.kind in tfm.ENCDEC_KINDS:
            enc_len = batch.get("enc_lengths")
            if enc_len is None:
                enc_len = torch.full((b,), batch["frames"].shape[1],
                                     dtype=torch.int32, device=tokens.device)
            cache = dict(cache, enc_length=enc_len.to(torch.int32), **{
                key: torch.stack(parts[key]).to(cache[key].dtype)
                for key in ("cross_k", "cross_v")})
        cache = dict(cache, length=ctx_lengths.to(torch.int32))
        # last valid position per row; the unembed runs on those rows only
        last = torch.clamp(lengths.long() - 1, 0, s - 1)
        h_last = h[torch.arange(b, device=h.device), last]
        logits = unembed(params, h_last)
        return logits, cache

    def decode_step(self, params, tokens, cache, live=None):
        """tokens (B,) int32 -> (logits (B, V), cache'). `live`
        (``moe.LiveRows``): the rows a moe model routes
        (``transformer.decode_step``); None routes every row."""
        return tfm.decode_step(params, self.cfg, tokens, cache,
                               window=self.window, kv_repeat=self.kv_repeat,
                               live=live)

    def decode_tokens(self, params, tokens, cache, live=None):
        """Fused greedy decode: tokens (B,) -> (next_ids (B,) int32, cache'),
        argmax on the device (first max wins on ties)."""
        logits, cache = self.decode_step(params, tokens, cache, live)
        return _argmax_ids(logits), cache

    def decode_multi(self, params, tokens, cache, j: int, live=None):
        """j greedy decode iterations with the argmax fed back on the
        device: tokens (B,) -> (ids (j, B) int32, cache'). No host sync
        inside; the caller syncs once on `ids`."""
        out = []
        tok = tokens
        for _ in range(j):
            tok, cache = self.decode_tokens(params, tok, cache, live)
            out.append(tok)
        return torch.stack(out), cache

    def decode_persistent(self, params, tokens, cache, j: int, *,
                          j_cap: int, live=None):
        """The reference's device while_loop as j device steps with the
        argmax fed back (torch has no device loop with a dynamic bound) and
        no host sync inside. It does not stop early at EOS: callers commit
        the prefix they need and roll the rest back by `length`. Returns
        (ids (j_cap, B) int32 — rows past j are zeros, cache', steps=j)."""
        ids, cache = self.decode_multi(params, tokens, cache, j, live)
        out = torch.zeros((j_cap, tokens.shape[0]), dtype=torch.int32,
                          device=ids.device)
        out[:j] = ids
        return out, cache, j

    def verify_step(self, params, tokens, cache):
        """Speculative verify: tokens (B, T) int32 -> (logits (B, T, V),
        cache'), bitwise T sequential `decode_step` calls."""
        return tfm.verify_step(params, self.cfg, tokens, cache,
                               window=self.window, kv_repeat=self.kv_repeat)

    def propose_step(self, params, tokens, cache, k: int):
        """Draft-side greedy proposal: tokens (B,) int32 -> (proposals
        (B, k+1) int32, cache')."""
        return tfm.propose_step(params, self.cfg, tokens, cache, k,
                                window=self.window,
                                kv_repeat=self.kv_repeat)

    # ------------------------------------------------------------- dry-run IO
    def input_specs(self, shape: ShapeConfig, *, act_dtype=torch.bfloat16):
        """``meta`` tensors standing in for the inputs of the phase's step
        (the reference's ShapeDtypeStructs): tokens and labels (int32) for
        train, frames (encoder-decoder) or patch_embeds (vlm) in
        `act_dtype`, and for decode one token per row and an abstract
        cache `shape.seq_len` deep in `act_dtype`."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def meta(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        encdec = cfg.kind in tfm.ENCDEC_KINDS
        if shape.phase in ("train", "prefill"):
            train = shape.phase == "train"
            if encdec:
                dec = s // 4 if train else 1
                specs = {"frames": meta(b, s, cfg.d_model, dtype=act_dtype),
                         "tokens": meta(b, dec)}
                if train:
                    specs["labels"] = meta(b, dec)
                return specs
            if cfg.kind == "vlm":
                p = min(1024, s // 4)
                specs = {"tokens": meta(b, s - p),
                         "patch_embeds": meta(b, p, cfg.d_model,
                                              dtype=act_dtype)}
                if train:
                    specs["labels"] = meta(b, s - p)
                return specs
            specs = {"tokens": meta(b, s)}
            if train:
                specs["labels"] = meta(b, s)
            return specs
        # decode: one token against a seq_len-deep cache
        return {"tokens": meta(b),
                "cache": self.init_cache(b, s, enc_seq=self.enc_seq(s),
                                         dtype=act_dtype, abstract=True)}
