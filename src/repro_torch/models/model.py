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

The counterpart of ``src/repro/models/model.py`` for every family:
dense, vlm (a vision-patch prefix), moe, ssm (Mamba-1), hybrid (Mamba-2
+ shared attention) and the encoder-decoders (encdec, audio), whose
caches hold `enc_seq(max_seq)` positions of encoder memory:

  cache = model.init_cache(B, S, enc_seq=model.enc_seq(S))
  logits, cache = model.prefill(params, {"tokens": t, "frames": f}, cache)

Params are the reference's stacked tree as a dict of tensors
(``repro_torch.bridge``). Caches are updated in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import cache as cache_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import unembed


def _argmax_ids(logits: torch.Tensor) -> torch.Tensor:
    # first max wins on ties, as jnp.argmax
    return torch.argmax(logits, dim=-1).to(torch.int32)


class Model:
    def __init__(self, cfg: ModelConfig, *, window: Optional[int] = None,
                 moe_seq_chunk: int = 0, remat: bool = False,
                 device="cuda"):
        tfm.check_kind(cfg)
        self.cfg = cfg
        self.window = window
        # per-layer rematerialisation under autograd (transformer.remat_call)
        self.remat = remat
        # sequence-chunked MoE dispatch (moe.moe_apply_chunked); 0 = one
        # capacity over the whole call, the reference's default
        self.moe_seq_chunk = moe_seq_chunk
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator, dtype=torch.float32):
        from repro_torch.bridge import init_params
        return init_params(self.cfg, generator, self.device, dtype)

    # ----------------------------------------------------------------- train
    def forward_train(self, params, batch):
        """batch {"tokens" (B, S)} plus "patch_embeds" (vlm) or "frames"
        (encoder-decoder) -> (logits (B, S, V), aux)."""
        return tfm.forward(params, self.cfg, batch, window=self.window,
                           remat=self.remat,
                           moe_seq_chunk=self.moe_seq_chunk)

    def loss(self, params, batch, *, ce_chunk: int = 1024):
        """Next-token cross-entropy (labels < 0 masked) + the MoE aux loss,
        as ``src/repro/models/model.py:Model.loss``: the CE runs over
        sequence chunks (`ce_chunk`, halved until it divides S), each
        checkpointed under remat, so the (tokens, vocab) logits never
        exist beyond one chunk. Returns tot / max(cnt, 1) + aux, a f32
        scalar."""
        h, aux = tfm.forward(params, self.cfg, batch, window=self.window,
                             remat=self.remat, return_hidden=True,
                             moe_seq_chunk=self.moe_seq_chunk)
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
                   dtype=torch.float32):
        return cache_lib.init_cache(self.cfg, batch, max_seq,
                                    enc_seq=enc_seq, dtype=dtype,
                                    device=self.device)

    def supports_physical_paging(self) -> bool:
        return cache_lib.supports_physical_paging(self.cfg)

    def init_paged_cache(self, batch: int, num_pages: int, page_size: int,
                         max_seq: int, *, dtype=torch.float32):
        return cache_lib.init_paged_cache(
            self.cfg, batch, num_pages, page_size, max_seq, dtype=dtype,
            device=self.device)

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
        Returns (logits (B, V), cache')."""
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
                                  moe_seq_chunk=self.moe_seq_chunk)
        for key in ("k", "v"):
            for i, part in enumerate(parts.get(key, ())):
                cache[key][i, :, :part.shape[1]] = part
        for key in ("ssm_h", "ssm_conv"):
            for i, part in enumerate(parts.get(key, ())):
                cache[key][i] = part
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
        return unembed(params, h_last), cache

    def decode_step(self, params, tokens, cache):
        """tokens (B,) int32 -> (logits (B, V), cache')."""
        return tfm.decode_step(params, self.cfg, tokens, cache,
                               window=self.window)

    def decode_tokens(self, params, tokens, cache):
        """Fused greedy decode: tokens (B,) -> (next_ids (B,) int32, cache'),
        argmax on the device (first max wins on ties)."""
        logits, cache = self.decode_step(params, tokens, cache)
        return _argmax_ids(logits), cache

    def decode_multi(self, params, tokens, cache, j: int):
        """j greedy decode iterations with the argmax fed back on the
        device: tokens (B,) -> (ids (j, B) int32, cache'). No host sync
        inside; the caller syncs once on `ids`."""
        out = []
        tok = tokens
        for _ in range(j):
            tok, cache = self.decode_tokens(params, tok, cache)
            out.append(tok)
        return torch.stack(out), cache

    def decode_persistent(self, params, tokens, cache, j: int, *,
                          j_cap: int):
        """The reference's device while_loop as j device steps with the
        argmax fed back (torch has no device loop with a dynamic bound) and
        no host sync inside. It does not stop early at EOS: callers commit
        the prefix they need and roll the rest back by `length`. Returns
        (ids (j_cap, B) int32 — rows past j are zeros, cache', steps=j)."""
        ids, cache = self.decode_multi(params, tokens, cache, j)
        out = torch.zeros((j_cap, tokens.shape[0]), dtype=torch.int32,
                          device=ids.device)
        out[:j] = ids
        return out, cache, j

    def verify_step(self, params, tokens, cache):
        """Speculative verify: tokens (B, T) int32 -> (logits (B, T, V),
        cache'), bitwise T sequential `decode_step` calls."""
        return tfm.verify_step(params, self.cfg, tokens, cache,
                               window=self.window)

    def propose_step(self, params, tokens, cache, k: int):
        """Draft-side greedy proposal: tokens (B,) int32 -> (proposals
        (B, k+1) int32, cache')."""
        return tfm.propose_step(params, self.cfg, tokens, cache, k,
                                window=self.window)
