"""Unified model API for serving: init / prefill / decode.

  model = Model(cfg, device="cuda")
  params = model.init(torch.Generator("cuda").manual_seed(0), torch.bfloat16)
  cache = model.init_cache(batch=B, max_seq=S)
  logits, cache = model.prefill(params, {"tokens": t, "lengths": n}, cache)
  logits, cache = model.decode_step(params, tokens, cache)
  logits, cache = model.verify_step(params, window, cache)   # speculative
  proposals, cache = model.propose_step(params, tokens, cache, k)

The counterpart of ``src/repro/models/model.py`` for the dense, moe,
ssm (Mamba-1) and hybrid (Mamba-2 + shared attention) families.
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
                 moe_seq_chunk: int = 0, device="cuda"):
        tfm.check_kind(cfg)
        self.cfg = cfg
        self.window = window
        # sequence-chunked MoE dispatch (moe.moe_apply_chunked); 0 = one
        # capacity over the whole call, the reference's default
        self.moe_seq_chunk = moe_seq_chunk
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator, dtype=torch.float32):
        from repro_torch.bridge import init_params
        return init_params(self.cfg, generator, self.device, dtype)

    # ----------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_seq: int, *, dtype=torch.float32):
        return cache_lib.init_cache(self.cfg, batch, max_seq, dtype=dtype,
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

        batch: {"tokens": (B, S) [, "lengths": (B,)]}; cache from
        init_cache (depth >= S): k/v written in place at positions
        [0, S) — the whole padded row, as the reference's
        dynamic_update_slice — and the ssm leaves with each row's state at
        its last valid token. Writes cast to the cache's dtypes.
        Returns (logits (B, V), cache')."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        lengths = batch.get("lengths")
        if lengths is None:
            lengths = torch.full((b,), s, dtype=torch.int32,
                                 device=tokens.device)
        h, _, parts = tfm.forward(params, cfg, batch, window=self.window,
                                  collect_cache=True, lengths=lengths,
                                  return_hidden=True,
                                  moe_seq_chunk=self.moe_seq_chunk)
        for key in ("k", "v"):
            for i, part in enumerate(parts.get(key, ())):
                cache[key][i, :, :s] = part
        for key in ("ssm_h", "ssm_conv"):
            for i, part in enumerate(parts.get(key, ())):
                cache[key][i] = part
        cache = dict(cache, length=lengths.to(torch.int32))
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
