"""seamless-m4t-medium — enc-dec multimodal backbone [arXiv:2308.11596].

The transformer backbone only: the audio frontend is a STUB — inputs arrive
as precomputed frame embeddings (``frontend_stub``), per the assignment.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,                 # decoder layers
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    block_pattern="encdec",
    frontend_stub=True,
    frontend_tokens=1024,        # precomputed audio frame embeddings
)
