"""Token-generation latency model (paper Appendix B) — roofline-derived.

The paper observes decode-iteration latency is (nearly) linear in batch
size B (Pearson 0.997 between B and total context tokens lets them drop the
latter). We keep that linear form but derive its coefficients from the
architecture + hardware roofline instead of fitting to A100 traces:

  iter_latency(B) = overhead
      + max( FLOPs(B) / (chips · peak · eff),  bytes(B) / (chips · bw · eff) )

  FLOPs(B)  = 2 · N_active · B            (one token per running request)
  bytes(B)  = param_bytes + B · avg_ctx · kv_bytes_per_token + B · state_bytes

Decode is memory-bound at practical batch sizes, which is exactly why the
paper's "generation speed ≫ user digest speed" slack exists. The same model
gives prefill latency (compute-bound) and the swap cost of Appendix D.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # per chip, bf16/fp16 FLOP/s
    hbm_bw: float              # per chip, bytes/s
    link_bw: float             # per chip ICI/NVLink, bytes/s
    chips: int = 1
    host_dma_bw: float = 25e9  # device<->host for KV swap, bytes/s
    efficiency: float = 0.55   # achieved fraction of roofline
    overhead: float = 0.004    # fixed per-iteration launch/scheduling (s)


TPU_V5E = HardwareSpec("tpu-v5e", 197e12, 819e9, 50e9)
TPU_V5E_POD = dataclasses.replace(TPU_V5E, chips=256)
# Calibrated to the paper's observed OPT-66B behavior on 4xA100 with vLLM
# (Fig. 3b: ~6.6 tok/s per-request generation speed at operating batch,
# aggregate ~700 tok/s at rate 3.3; pairwise-NVLink topology makes TP
# all-reduces expensive, hence the modest achieved roofline fraction).
A100_4X = HardwareSpec("4xA100", 312e12, 2.0e12, 300e9, chips=4,
                       efficiency=0.35, overhead=0.015)
A100_1X = dataclasses.replace(A100_4X, chips=1, efficiency=0.50,
                              overhead=0.006)
A40_4X = HardwareSpec("4xA40", 150e12, 696e9, 64e9, chips=4,
                      efficiency=0.40, overhead=0.015)


class LatencyModel:
    """Analytic latency for decode / prefill / swap on a given deployment."""

    def __init__(
        self,
        cfg: ModelConfig,
        hw: HardwareSpec,
        *,
        dtype_bytes: int = 2,
        avg_ctx: int = 512,
    ):
        self.cfg = cfg
        self.hw = hw
        self.dtype_bytes = dtype_bytes
        self.avg_ctx = avg_ctx
        self.param_bytes = cfg.param_count() * dtype_bytes
        self.active_params = cfg.active_param_count()
        self.kv_tok_bytes = cfg.kv_bytes_per_token(dtype_bytes)
        self.state_bytes = cfg.ssm_state_bytes()
        self._agg_flops = hw.peak_flops * hw.chips * hw.efficiency
        self._agg_bw = hw.hbm_bw * hw.chips * hw.efficiency

    # -- decode ---------------------------------------------------------------

    def iter_latency(self, batch_size: int, total_ctx: int | None = None) -> float:
        """One continuous-batching decode iteration (s)."""
        if batch_size <= 0:
            return self.hw.overhead
        ctx = total_ctx if total_ctx is not None else batch_size * self.avg_ctx
        flops = 2.0 * self.active_params * batch_size
        bytes_ = (
            self.param_bytes
            + ctx * self.kv_tok_bytes
            + batch_size * self.state_bytes
        )
        return self.hw.overhead + max(flops / self._agg_flops,
                                      bytes_ / self._agg_bw)

    def token_rate(self, batch_size: int, total_ctx: int | None = None) -> float:
        """Per-request decode speed (tokens/s) at batch size B."""
        return 1.0 / self.iter_latency(batch_size, total_ctx)

    def iter_latency_schedule(self, batch_size: int, total_ctx: int,
                              steps: int) -> "list[float]":
        """Per-iteration latencies of `steps` consecutive decode iterations
        at a fixed batch: every iteration emits one token per request, so
        the context term grows by batch_size per step. Deterministic — this
        is what lets the engine's multi-step decode fast path reconstruct
        per-step virtual-clock emit timestamps EXACTLY (the same
        `iter_latency` calls, in the same order, the one-step loop makes)
        and what the planner uses to bound a block by the next pending
        arrival before dispatching it."""
        out = []
        ctx = total_ctx
        for _ in range(steps):
            out.append(self.iter_latency(batch_size, ctx))
            ctx += batch_size
        return out

    def per_token_latency(self, batch_size: int,
                          total_ctx: int | None = None) -> float:
        """Seconds per *emitted* token. For the one-token-per-iteration
        baseline this IS iter_latency (the scheduler's pacing checks call
        this so the speculative model can report iter/E[tokens] instead
        without perturbing baseline float behavior bit-for-bit)."""
        return self.iter_latency(batch_size, total_ctx)

    def verify_latency(self, batch_size: int, total_ctx: int | None = None,
                       k: int = 0) -> float:
        """One speculative verify pass: k+1 positions per request in a
        single forward. FLOPs scale with the window ((k+1)x decode), but
        HBM traffic is still dominated by the one weight/KV pass — that
        asymmetry (decode is memory-bound, Appendix B) is the entire
        speculative-decoding bargain: ~one iteration's wall time buys up
        to k+1 tokens."""
        if batch_size <= 0:
            return self.hw.overhead
        ctx = total_ctx if total_ctx is not None else batch_size * self.avg_ctx
        flops = 2.0 * self.active_params * batch_size * (k + 1)
        bytes_ = (
            self.param_bytes
            + (ctx + batch_size * (k + 1)) * self.kv_tok_bytes
            + batch_size * self.state_bytes
        )
        return self.hw.overhead + max(flops / self._agg_flops,
                                      bytes_ / self._agg_bw)

    # -- prefill ----------------------------------------------------------------

    def prefill_latency(self, prompt_tokens: int) -> float:
        """Prompt processing (compute-bound)."""
        flops = 2.0 * self.active_params * prompt_tokens
        bytes_ = self.param_bytes
        return self.hw.overhead + max(flops / self._agg_flops,
                                      bytes_ / self._agg_bw)

    def prefill_chunk_latency(self, chunk_tokens: int,
                              ctx_tokens: int) -> float:
        """One chunked-prefill step: process `chunk_tokens` new prompt
        tokens whose attention spans `ctx_tokens` of accumulated context.
        Every chunk pays the fixed launch overhead, a full weight pass,
        and the KV traffic of the prefix it attends over — so the summed
        chunk cost strictly dominates the monolithic `prefill_latency`
        and a chunked prompt's own TTFT under contention is honest (the
        win is the residents it stops stalling, not its own latency)."""
        flops = 2.0 * self.active_params * chunk_tokens
        bytes_ = self.param_bytes + ctx_tokens * self.kv_tok_bytes
        return self.hw.overhead + max(flops / self._agg_flops,
                                      bytes_ / self._agg_bw)

    def chunked_prefill_latency(self, total_tokens: int, chunk: int,
                                start: int = 0) -> float:
        """Total remaining prefill cost of a prompt split at `chunk`
        tokens, resuming from a cursor at `start`. Prompts that fit one
        chunk take the monolithic path (same float path as
        `prefill_latency` — the engine's degenerate-case oracle).
        `QoEPricer.serve_delay` prices a partially-prefilled resident by
        the chunks it still owes through this."""
        if chunk <= 0 or total_tokens <= chunk:
            return self.prefill_latency(total_tokens - start)
        t = 0.0
        cur = start
        while cur < total_tokens:
            step = min(chunk, total_tokens - cur)
            cur += step
            t += self.prefill_chunk_latency(step, cur)
        return t

    # -- preemption (Appendix D) --------------------------------------------------

    def swap_latency(self, ctx_tokens: int) -> float:
        """Move a request's KV/state to (or from) host RAM."""
        bytes_ = ctx_tokens * self.kv_tok_bytes + self.state_bytes
        return bytes_ / self.hw.host_dma_bw

    def recompute_latency(self, ctx_tokens: int) -> float:
        return self.prefill_latency(ctx_tokens)

    # -- capacity ----------------------------------------------------------------

    def max_batch_from_latency(self, max_iter_latency: float) -> int:
        """Largest B whose iteration latency stays under the bound
        (used for B_min pruning: tokens must flow at the stiffest TDS)."""
        lo, hi = 1, 1 << 20
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.iter_latency(mid) <= max_iter_latency:
                lo = mid
            else:
                hi = mid - 1
        return lo


class SpeculativeLatencyModel(LatencyModel):
    """Cost model for a speculative engine step: k+1 greedy draft decodes
    plus one (k+1)-position target verify, yielding 1..k+1 tokens.

    The scheduler prices QoE gains in tokens/s; with speculation that rate
    is E[accepted+1] / step_latency, where the expected accepted length is
    a deterministic EMA of the engine's observed acceptance counts
    (`observe_acceptance`, updated after every verify). All pacing entry
    points the Andes scheduler uses — `token_rate` for Q_serve(B),
    `per_token_latency` for the latency-pressure trigger,
    `max_batch_from_latency` for B_min — account for the expected burst,
    so knapsack pricing and preemption decisions see the true delivery
    speed of a speculative replica. `prefill_latency` / `swap_latency`
    include the draft's share: a speculative request prefills and parks
    *two* caches (Appendix D accounting, extended).
    """

    def __init__(
        self,
        cfg: ModelConfig,
        hw: HardwareSpec,
        draft_cfg: ModelConfig,
        *,
        k: int,
        dtype_bytes: int = 2,
        avg_ctx: int = 512,
        accept_prior: float = 0.5,
        ema_alpha: float = 0.05,
    ):
        super().__init__(cfg, hw, dtype_bytes=dtype_bytes, avg_ctx=avg_ctx)
        if k < 1:
            raise ValueError(f"speculation needs k >= 1, got {k}")
        self.k = int(k)
        self.draft = LatencyModel(draft_cfg, hw, dtype_bytes=dtype_bytes,
                                  avg_ctx=avg_ctx)
        self._exp_accept0 = float(accept_prior) * self.k
        self._exp_accept = self._exp_accept0
        self._alpha = float(ema_alpha)

    def observe_acceptance(self, accepted: int) -> None:
        """Feed one verify outcome (0..k accepted) into the EMA."""
        self._exp_accept += self._alpha * (accepted - self._exp_accept)

    def reset(self) -> None:
        """Restore the acceptance EMA to its prior. ServingEngine.reset()
        calls this so back-to-back run() calls on one speculative engine
        price (and therefore clock) exactly like a fresh engine."""
        self._exp_accept = self._exp_accept0

    @property
    def expected_step_tokens(self) -> float:
        """E[tokens emitted per step] = E[accepted] + 1 (correction/bonus)."""
        return 1.0 + self._exp_accept

    # -- one speculative step -------------------------------------------------

    def iter_latency(self, batch_size: int, total_ctx: int | None = None) -> float:
        if batch_size <= 0:
            return self.hw.overhead
        return ((self.k + 1) * self.draft.iter_latency(batch_size, total_ctx)
                + self.verify_latency(batch_size, total_ctx, self.k))

    def token_rate(self, batch_size: int, total_ctx: int | None = None) -> float:
        return self.expected_step_tokens / self.iter_latency(batch_size, total_ctx)

    def per_token_latency(self, batch_size: int,
                          total_ctx: int | None = None) -> float:
        return self.iter_latency(batch_size, total_ctx) / self.expected_step_tokens

    # -- both caches move -----------------------------------------------------

    def prefill_latency(self, prompt_tokens: int) -> float:
        return (super().prefill_latency(prompt_tokens)
                + self.draft.prefill_latency(prompt_tokens))

    def swap_latency(self, ctx_tokens: int) -> float:
        return (super().swap_latency(ctx_tokens)
                + self.draft.swap_latency(ctx_tokens))

    def max_batch_from_latency(self, max_iter_latency: float) -> int:
        """Largest B whose *per-token* latency stays under the bound."""
        lo, hi = 1, 1 << 20
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.per_token_latency(mid) <= max_iter_latency:
                lo = mid
            else:
                hi = mid - 1
        return lo
