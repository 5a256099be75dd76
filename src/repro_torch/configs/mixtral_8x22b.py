"""mixtral-8x22b — 8 experts top-2, sliding-window attention [arXiv:2401.04088].

Few large experts: the model the reference serves with ESP
(``moe_impl="esp"``); its window is what the dense cache's ring buffer
serves.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    n_experts=8,
    experts_per_token=2,
    moe_d_ff=16384,
    sliding_window=4096,
)
