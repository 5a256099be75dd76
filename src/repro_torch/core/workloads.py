"""Paper Table I model specifications for the analytical evaluator (copy
of ``repro.core.workloads``).

These are the MoE models the paper evaluates; expert byte sizes follow the
paper's INT8-linears assumption (bytes ~= params). ``expert_flops_token`` is
the standard 2 FLOPs/param/token for the three expert matrices.
"""

from __future__ import annotations

import dataclasses

MB = 1e6


@dataclasses.dataclass(frozen=True)
class SimModelSpec:
    name: str
    total_params: float
    layers_sparse: int
    layers_total: int
    d_model: int
    expert_params: float          # params of ONE expert (gate+up+down)
    n_experts: int
    topk: int
    # dense-path attention params per layer (q,k,v,o with GQA folded in)
    attn_params: float

    @property
    def expert_bytes(self) -> float:
        return self.expert_params  # INT8 weights (paper Section VI-A)

    @property
    def expert_flops_token(self) -> float:
        return 2.0 * self.expert_params

    @property
    def token_bytes(self) -> int:
        return self.d_model * 2   # FP16 activations / communications

    @property
    def attn_flops_token(self) -> float:
        return 2.0 * self.attn_params


def _attn_params(d_model: int, n_heads: int, n_kv: int, head_dim: int | None = None) -> float:
    hd = head_dim or d_model // n_heads
    q = d_model * n_heads * hd
    kv = 2 * d_model * n_kv * hd
    o = n_heads * hd * d_model
    return float(q + kv + o)


DEEPSEEK_V3 = SimModelSpec(
    name="DeepSeek-V3",
    total_params=671e9,
    layers_sparse=58,
    layers_total=61,
    d_model=7168,
    expert_params=42 * MB,
    n_experts=256,
    topk=8,
    attn_params=_attn_params(7168, 128, 128, 128),  # MLA approximated dense
)

QWEN3_235B = SimModelSpec(
    name="Qwen3-235B",
    total_params=235e9,
    layers_sparse=94,
    layers_total=94,
    d_model=4096,
    expert_params=18 * MB,
    n_experts=128,
    topk=8,
    attn_params=_attn_params(4096, 64, 4, 128),
)

DEEPSEEK_V2 = SimModelSpec(
    name="DeepSeek-V2",
    total_params=236e9,
    layers_sparse=59,
    layers_total=60,
    d_model=5120,
    expert_params=23 * MB,
    n_experts=160,
    topk=6,
    attn_params=_attn_params(5120, 128, 128, 128),
)

DBRX = SimModelSpec(
    name="DBRX",
    total_params=132e9,
    layers_sparse=40,
    layers_total=40,
    d_model=6144,
    expert_params=189 * MB,
    n_experts=16,
    topk=4,
    attn_params=_attn_params(6144, 48, 8, 128),
)

MIXTRAL_8X22B = SimModelSpec(
    name="Mixtral-8x22B",
    total_params=141e9,
    layers_sparse=56,
    layers_total=56,
    d_model=6144,
    expert_params=288 * MB,
    n_experts=8,
    topk=2,
    attn_params=_attn_params(6144, 48, 8, 128),
)

PAPER_MODELS = {
    m.name: m
    for m in (DEEPSEEK_V3, QWEN3_235B, DEEPSEEK_V2, DBRX, MIXTRAL_8X22B)
}
