"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517].

Attention-free recurrent blocks; decode carries an O(1) state per layer, so
the long_500k cell runs. ``d_ff=0`` per the assignment: xLSTM blocks carry
their own internal up/down projections instead of a separate FFN.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    block_pattern="xlstm",
    ssm_state=256,
)
