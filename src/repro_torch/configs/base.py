"""Configuration system: model architecture configs, input shapes, registry.

Every assigned architecture gets a module in this package defining a
``CONFIG`` (full production scale, exercised only via the dry-run) and a
``smoke_config()`` (reduced variant of the same family for CPU tests).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

ARCH_KINDS = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts
    num_shared_experts: int = 0     # always-on experts
    top_k: int = 0
    d_expert: int = 0               # per-expert FFN hidden size
    router_aux_loss_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                 # d_inner = expand * d_model
    version: int = 1                # 1 = Mamba (selective scan), 2 = Mamba2 (SSD)
    headdim: int = 64               # Mamba2 head dim
    chunk: int = 256                # Mamba2 chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description covering all assigned families."""

    name: str
    kind: str                       # one of ARCH_KINDS
    num_layers: int
    d_model: int
    num_heads: int                  # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    qkv_bias: bool = False
    gated_mlp: bool = True          # SwiGLU (3 mats) vs GeLU (2 mats)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position: int = 1 << 20
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: indices of layers that are attention blocks (shared weights if
    # hybrid_shared_attn); everything else is an SSM block.
    hybrid_attn_every: int = 0      # 0 = not hybrid
    hybrid_shared_attn: bool = False
    # enc-dec
    num_encoder_layers: int = 0
    # sliding-window used by long-context serve variant (and zamba2 long mode)
    sliding_window: int = 8192
    # modality frontend stub (audio frames / vision patches)
    frontend: Optional[str] = None  # None | "audio" | "vision"
    source: str = ""                # citation

    def __post_init__(self):
        assert self.kind in ARCH_KINDS, self.kind
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived quantities -------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.kind == "ssm"

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    def attn_layer_ids(self) -> Tuple[int, ...]:
        """Layers that carry attention (for hybrid archs)."""
        if self.kind == "ssm":
            return ()
        if self.hybrid_attn_every:
            return tuple(
                i for i in range(self.num_layers)
                if (i + 1) % self.hybrid_attn_every == 0
            )
        return tuple(range(self.num_layers))

    def ssm_layer_ids(self) -> Tuple[int, ...]:
        if self.kind == "ssm":
            return tuple(range(self.num_layers))
        if self.hybrid_attn_every:
            attn = set(self.attn_layer_ids())
            return tuple(i for i in range(self.num_layers) if i not in attn)
        return ()

    # ---- parameter counting (used by roofline + latency model) -------------
    def param_count(self) -> int:
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache bytes appended per generated/context token (per request)."""
        n_attn = len(self.attn_layer_ids())
        if self.kind == "encdec":
            n_attn = self.num_layers  # decoder self-attn layers
        kv_heads = max(self.num_kv_heads, 1)
        return 2 * n_attn * kv_heads * self.head_dim * dtype_bytes

    def ssm_state_bytes(self, dtype_bytes: int = 4) -> int:
        """Constant per-request recurrent state (Mamba layers)."""
        n_ssm = len(self.ssm_layer_ids())
        if not n_ssm or not self.ssm:
            return 0
        conv = self.d_inner * self.ssm.d_conv
        if self.ssm.version == 2:
            nheads = self.d_inner // self.ssm.headdim
            scan = nheads * self.ssm.headdim * self.ssm.d_state
            conv = (self.d_inner + 2 * self.ssm.d_state) * self.ssm.d_conv
        else:
            scan = self.d_inner * self.ssm.d_state
        return n_ssm * (scan + conv) * dtype_bytes


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    embed = cfg.vocab_size * d
    lm_head = 0 if cfg.tie_embeddings else cfg.vocab_size * d
    total = embed + lm_head + d  # final norm

    def attn_params() -> int:
        hd = cfg.head_dim
        q = d * cfg.num_heads * hd
        kv = 2 * d * cfg.num_kv_heads * hd
        o = cfg.num_heads * hd * d
        bias = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd if cfg.qkv_bias else 0
        return q + kv + o + bias + 2 * d  # 2 norms per block

    def mlp_params(d_ff: int) -> int:
        return (3 if cfg.gated_mlp else 2) * d * d_ff  # SwiGLU vs GeLU

    def moe_params() -> int:
        m = cfg.moe
        router = d * m.num_experts
        shared = m.num_shared_experts * mlp_params(m.d_expert)
        if active_only:
            routed = m.top_k * mlp_params(m.d_expert)
        else:
            routed = m.num_experts * mlp_params(m.d_expert)
        return router + shared + routed

    def ssm_params() -> int:
        s = cfg.ssm
        di = cfg.d_inner
        if s.version == 2:
            nheads = di // s.headdim
            in_proj = d * (2 * di + 2 * s.d_state + nheads)
            conv = (di + 2 * s.d_state) * s.d_conv
            extra = nheads * 2 + di  # A_log, D(per head), norm-ish
        else:
            in_proj = d * 2 * di
            conv = di * s.d_conv
            dt_rank = max(d // 16, 1)
            extra = di * (s.d_state * 2 + dt_rank) + dt_rank * di + di * 2
        out_proj = di * d
        return in_proj + conv + extra + out_proj + d  # + norm

    n_attn = len(cfg.attn_layer_ids())
    n_ssm = len(cfg.ssm_layer_ids())
    if cfg.kind == "moe":
        total += n_attn * (attn_params() + moe_params())
    elif cfg.kind == "ssm":
        total += n_ssm * ssm_params()
    elif cfg.kind == "hybrid":
        total += n_ssm * ssm_params()
        attn_blocks = 2 if cfg.hybrid_shared_attn else n_attn
        total += attn_blocks * (attn_params() + mlp_params(cfg.d_ff))
    elif cfg.kind in ("encdec", "audio"):
        # encoder layers: self-attn + mlp; decoder: self + cross + mlp
        enc = cfg.num_encoder_layers * (attn_params() + mlp_params(cfg.d_ff))
        dec = cfg.num_layers * (2 * attn_params() + mlp_params(cfg.d_ff))
        total += enc + dec
    else:  # dense, vlm
        total += n_attn * (attn_params() + mlp_params(cfg.d_ff))
    return int(total)


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    phase: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# the port carries only the archs its slices have reached; each later
# slice adds its config module here
ARCH_IDS = (
    "llama3-8b",
    "falcon-mamba-7b",
    "zamba2-2.7b",
    "qwen1.5-4b",
    "granite-3-2b",
    "opt-66b",
    "llama3-405b",
    "qwen2-moe-a2.7b",
    "phi3.5-moe-42b-a6.6b",
    "seamless-m4t-medium",
    "pixtral-12b",
)

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MOD:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MOD)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[arch_id]}")
    return mod.smoke_config()


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]
