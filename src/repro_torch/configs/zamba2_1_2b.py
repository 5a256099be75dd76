"""zamba2-1.2b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

Hybrid: most layers are Mamba2 blocks; a single *shared* attention+MLP block
is invoked every ``attn_every`` layers (the Zamba signature). Sub-quadratic
decode (SSM state), so the long_500k cell runs.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    block_pattern="zamba",
    attn_every=6,
)
