"""internvl2-76b — InternViT + LLM backbone [arXiv:2404.16821].

Backbone only (llama3-70b-class decoder); the vision frontend is a STUB —
precomputed patch embeddings are prepended to the token stream.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500000.0,
    frontend_stub=True,
    frontend_tokens=256,         # precomputed image patch embeddings
)
