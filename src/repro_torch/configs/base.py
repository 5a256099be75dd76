"""Model configuration (copy of ``repro.configs.base``, cut to what the
serving slice reads).

``ModelConfig`` fully describes an architecture; ``smoke()`` is the tiny
same-family reduction the CPU tests run.
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
