"""Kernel entry points: the one place model code asks for hot-path kernels.

Model code decides once, with ``ParallelCtx.kernels_on(tensor)``, whether
a call takes a kernel; when it does, it calls these names:

* ``expert_ffn``          — count-aware grouped SwiGLU FFN
  (``gmm_dual_act_ragged`` + ``gmm_ragged``);
* ``attend``              — causal/bidirectional GQA flash attention
  (the ``flash_attention`` wrapper);
* ``decode_attend_paged`` — one-token decode over a paged KV pool (the
  ``flash_decode_paged`` wrapper).

Each wrapper launches its hand-written CUDA kernel on CUDA tensors (or
raises on a shape outside its ``can_*`` gate) and runs its plain PyTorch
version on CPU tensors; there is no fallback on the card. The gates are
derived for Hopper from what each kernel's tiles take (head dim, dtype,
16-byte vectors), not from the TPU's (8, 128) tiling.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    can_flash_attend,
    flash_attention,
)
from repro_torch.kernels.flash_decode.paged import (
    can_flash_decode_paged,
    flash_decode_paged,
)
from repro_torch.kernels.gmm.ragged import can_gmm, gmm_dual_act_ragged, gmm_ragged

__all__ = [
    "attend",
    "can_flash_attend",
    "can_flash_decode_paged",
    "can_gmm",
    "decode_attend_paged",
    "expert_ffn",
]

attend = flash_attention
decode_attend_paged = flash_decode_paged


def expert_ffn(
    x: torch.Tensor,                  # (G, C, D)
    wg: torch.Tensor,                 # (G/gpw, D, F)
    wu: torch.Tensor,                 # (G/gpw, D, F)
    wd: torch.Tensor,                 # (G/gpw, F, D)
    group_sizes: torch.Tensor,        # (G,) int32 valid-row counts
    groups_per_weight: int = 1,
) -> torch.Tensor:
    """Grouped SwiGLU expert FFN; rows past each group's count are zero and
    cost no weight traffic on the card."""
    h = gmm_dual_act_ragged(x, wg, wu, group_sizes, groups_per_weight)
    return gmm_ragged(h, wd, group_sizes, groups_per_weight)
