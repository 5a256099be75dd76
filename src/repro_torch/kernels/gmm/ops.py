"""The grouped-matmul op layer: the JAX package's ``repro/kernels/gmm/ops.py``
under its names and signatures (without ``interpret``), as plain functions
over the kernel wrappers.

``expert_ffn`` here is the *padded* SwiGLU FFN (``gmm_dual_act`` + ``gmm``,
every row live, weights (G, D, F)); it is not ``registry.expert_ffn``, the
count-aware FFN that the model paths call (``expert_ffn_ragged`` here).
No model path calls this module, as in the reference: it is the kernels'
direct entry point.

Each function takes CUDA tensors to the kernels and CPU tensors to their
plain versions (see the wrappers). Offsets and group sizes may be any
integer tensor; they are passed on as int32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.gmm.gmm import gmm, gmm_dual_act
from repro_torch.kernels.gmm.ragged import (
    gmm_dual_act_gather,
    gmm_dual_act_ragged,
    gmm_fused_ffn,
    gmm_gather,
    gmm_ragged,
    gmm_scatter,
)


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def gmm_op(x, w):
    return gmm(x, w)


def expert_ffn(x, wg, wu, wd):
    """(G,C,D) x (G,D,F) x2 x (G,F,D) -> (G,C,D): padded SwiGLU expert FFN."""
    return gmm(gmm_dual_act(x, wg, wu), wd)


def gmm_ragged_op(x, w, group_sizes, groups_per_weight: int = 1):
    return gmm_ragged(x, w, _i32(group_sizes), groups_per_weight)


def expert_ffn_ragged(x, wg, wu, wd, group_sizes, groups_per_weight: int = 1):
    """Count-aware SwiGLU expert FFN: rows past each group's count come out
    zero and cost no weight traffic on the card."""
    gs = _i32(group_sizes)
    h = gmm_dual_act_ragged(x, wg, wu, gs, groups_per_weight)
    return gmm_ragged(h, wd, gs, groups_per_weight)


def gmm_gather_op(x, w, offsets, group_sizes, capacity: int,
                  groups_per_weight: int = 1):
    return gmm_gather(x, w, _i32(offsets), _i32(group_sizes), capacity,
                      groups_per_weight)


def expert_ffn_gather(x, wg, wu, wd, offsets, group_sizes, capacity: int,
                      groups_per_weight: int = 1):
    """Flat (R, D) rows in, bucket-padded (G, capacity, D) out: the SwiGLU
    front half gathers its rows in place, the down projection is ragged."""
    gs = _i32(group_sizes)
    h = gmm_dual_act_gather(x, wg, wu, _i32(offsets), gs, capacity,
                            groups_per_weight)
    return gmm_ragged(h, wd, gs, groups_per_weight)


def gmm_scatter_op(x, w, offsets, group_sizes, out_rows: int,
                   groups_per_weight: int = 1):
    return gmm_scatter(x, w, _i32(offsets), _i32(group_sizes), out_rows,
                       groups_per_weight)


def expert_ffn_gather_compact(x, wg, wu, wd, offsets, group_sizes,
                              capacity: int, groups_per_weight: int = 1):
    """Flat rows in, flat rows out at the same offsets: only the
    bucket-padded hidden tensor exists between the two kernels."""
    off, gs = _i32(offsets), _i32(group_sizes)
    h = gmm_dual_act_gather(x, wg, wu, off, gs, capacity, groups_per_weight)
    return gmm_scatter(h, wd, off, gs, x.shape[0], groups_per_weight)


def expert_ffn_fused(x, wg, wu, wd, offsets, group_sizes, capacity: int,
                     groups_per_weight: int = 1):
    """The same flat-in, flat-out FFN as one kernel (``gmm_fused_ffn``)."""
    return gmm_fused_ffn(x, wg, wu, wd, _i32(offsets), _i32(group_sizes),
                         capacity, groups_per_weight)
