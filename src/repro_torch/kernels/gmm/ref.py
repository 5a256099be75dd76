"""Plain PyTorch versions of the ragged grouped-matmul kernels.

These are the kernels' oracles (the CPU tests hold them against the JAX
package; ``chip_smoke.py`` holds the CUDA kernels against them on the
card) and the path CPU tensors take. Rows at or past ``group_sizes[g]``
come out as exact zeros, selected with ``where`` so that garbage (even NaN)
in dead input rows never reaches the output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _row_mask(c: int, group_sizes: torch.Tensor) -> torch.Tensor:
    rows = torch.arange(c, device=group_sizes.device)
    return (rows[None, :] < group_sizes[:, None].long())[..., None]   # (G, C, 1)


def _grouped_bmm(x: torch.Tensor, w: torch.Tensor, gpw: int) -> torch.Tensor:
    """(G, C, D) @ (G/gpw, D, F) -> (G, C, F); ``gpw`` consecutive groups
    share one weight row (folded so no weight is repeated)."""
    g, c, d = x.shape
    y = torch.bmm(x.reshape(g // gpw, gpw * c, d), w)
    return y.reshape(g, c, -1)


def gmm_ragged(
    x: torch.Tensor,            # (G, C, D)
    w: torch.Tensor,            # (G // gpw, D, F)
    group_sizes: torch.Tensor,  # (G,) int32
    groups_per_weight: int = 1,
) -> torch.Tensor:
    """y[g, :count_g] = x[g, :count_g] @ w[g // gpw]; tail rows are zero."""
    y = _grouped_bmm(x, w, groups_per_weight)
    mask = _row_mask(x.shape[1], group_sizes)
    return torch.where(mask, y, torch.zeros((), dtype=y.dtype, device=y.device))


def gmm_dual_act_ragged(
    x: torch.Tensor,
    wg: torch.Tensor,
    wu: torch.Tensor,
    group_sizes: torch.Tensor,
    groups_per_weight: int = 1,
) -> torch.Tensor:
    """h[g] = silu(x@wg) * (x@wu) on the first count_g rows (activation in
    fp32, stored in x.dtype); tail rows are zero."""
    a = _grouped_bmm(x, wg, groups_per_weight).float()
    b = _grouped_bmm(x, wu, groups_per_weight).float()
    h = (F.silu(a) * b).to(x.dtype)
    mask = _row_mask(x.shape[1], group_sizes)
    return torch.where(mask, h, torch.zeros((), dtype=h.dtype, device=h.device))


def expert_ffn_ragged(
    x: torch.Tensor,
    wg: torch.Tensor,
    wu: torch.Tensor,
    wd: torch.Tensor,
    group_sizes: torch.Tensor,
    groups_per_weight: int = 1,
) -> torch.Tensor:
    """Count-aware SwiGLU expert FFN: the plain pair composed, with the
    hidden tensor in x.dtype between the two products."""
    h = gmm_dual_act_ragged(x, wg, wu, group_sizes, groups_per_weight)
    return gmm_ragged(h, wd, group_sizes, groups_per_weight)
