"""Model and shape configuration (copy of ``repro.configs.base``).

``ModelConfig`` fully describes an architecture; ``ShapeConfig`` describes
one (seq_len, global_batch, step-kind) workload cell of the dry run;
``smoke()`` is the tiny same-family reduction the CPU tests run.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # per-expert hidden (0 -> d_ff)
    # --- attention flavour ---------------------------------------------------
    sliding_window: int = 0          # 0 -> full attention
    qkv_bias: bool = False
    # --- SSM / hybrid ---------------------------------------------------------
    ssm_state: int = 0
    block_pattern: str = "attn"      # attn | mamba | zamba | xlstm | encdec
    attn_every: int = 0
    # --- enc-dec / multimodal -------------------------------------------------
    n_encoder_layers: int = 0
    frontend_stub: bool = False
    frontend_tokens: int = 0
    # --- misc -------------------------------------------------------------
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def moe_d_ff_(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell (sub-quadratic decode)."""
        return self.block_pattern in ("mamba", "zamba", "xlstm") or (
            self.sliding_window > 0
        )

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, h = self.d_model, self.head_dim_
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * self.n_heads * h + 2 * d * self.n_kv_heads * h + self.n_heads * h * d
        dense_mlp = 3 * d * self.d_ff if self.d_ff else 0
        if self.is_moe:
            mlp = self.n_experts * 3 * d * self.moe_d_ff_
        else:
            mlp = dense_mlp
        if self.block_pattern == "mamba" or self.block_pattern == "zamba":
            # Mamba2 block: in_proj (2*d_inner + heads...), rough 6*d^2.
            mamba = 6 * d * d
        else:
            mamba = 0
        per_layer = {
            "attn": attn + mlp,
            "encdec": attn + mlp,
            "mamba": mamba,
            "zamba": mamba,          # shared attn counted once below
            "xlstm": 5 * d * d,
        }[self.block_pattern]
        total = emb + self.n_layers * per_layer
        if self.block_pattern == "zamba":
            total += attn + dense_mlp        # one shared attention block
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (attn + dense_mlp)
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only top-k experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_experts = self.n_layers * self.n_experts * 3 * d * self.moe_d_ff_
        active = self.n_layers * self.experts_per_token * 3 * d * self.moe_d_ff_
        return int(full - all_experts + active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shapes_for(cfg: ModelConfig) -> list[ShapeConfig]:
    """The shape cells applicable to an architecture. ``long_500k`` needs
    sub-quadratic attention (an O(L^2) full-attention pass cannot fit the
    524k context)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.subquadratic:
        out.append(LONG_500K)
    return out


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family reduction for CPU smoke tests."""
    deep = cfg.block_pattern in ("zamba", "xlstm")  # need a full block unit
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 4 if deep else 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_d_ff=96 if cfg.is_moe else 0,
        sliding_window=32 if cfg.sliding_window else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        attn_every=2 if cfg.attn_every else 0,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        frontend_tokens=8 if cfg.frontend_stub else 0,
    )
