"""Plain PyTorch versions of the grouped-matmul kernels.

These are the kernels' oracles (the CPU tests hold them against the JAX
package; ``chip_smoke.py`` holds the CUDA kernels against them on the
card) and the path CPU tensors take. Rows at or past ``group_sizes[g]``
come out as exact zeros, selected with ``where`` so that garbage (even NaN)
in dead input rows never reaches the output. The padded forms
(:func:`gmm`, :func:`gmm_dual_act`, :func:`expert_ffn`) have no counts:
every row is live.
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


def _swiglu(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """silu(a) * b in fp32, stored in ``dtype``."""
    return (F.silu(a.float()) * b.float()).to(dtype)


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[g] = x[g] @ w[g]: (G, C, D) @ (G, D, F) -> (G, C, F), every row."""
    return torch.bmm(x, w)


def gmm_dual_act(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor) -> torch.Tensor:
    """h[g] = silu(x[g] @ wg[g]) * (x[g] @ wu[g]), every row (activation in
    fp32, stored in x.dtype)."""
    return _swiglu(torch.bmm(x, wg), torch.bmm(x, wu), x.dtype)


def expert_ffn(x, wg, wu, wd) -> torch.Tensor:
    """Padded SwiGLU expert FFN: (G, C, D) x (G, D, F) x2 x (G, F, D) ->
    (G, C, D), every row, the hidden tensor in x.dtype between the two."""
    return gmm(gmm_dual_act(x, wg, wu), wd)


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
    h = _swiglu(_grouped_bmm(x, wg, groups_per_weight),
                _grouped_bmm(x, wu, groups_per_weight), x.dtype)
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


# ---------------------------------------------------------------------------
# flat-row layouts: gather prologue, scatter epilogue, fused FFN
# ---------------------------------------------------------------------------
#
# Bucket g's rows sit at [offsets[g], offsets[g] + count_g) of a flat (R, D)
# array (count_g = min(group_sizes[g], capacity)). Rows between segments
# (dropped copies) may hold anything, NaN included: they are never read,
# and the scatter never writes them.

def _segment_rows(offsets: torch.Tensor, group_sizes: torch.Tensor, capacity: int):
    """(G, capacity) flat row of each bucket position, and its live mask."""
    pos = torch.arange(capacity, device=offsets.device)
    idx = offsets.long()[:, None] + pos[None, :]
    live = pos[None, :] < group_sizes.long()[:, None]
    return idx, live


def gather_buckets(
    x: torch.Tensor,             # (R, D) flat rows, bucket-contiguous
    offsets: torch.Tensor,       # (G,) int32
    group_sizes: torch.Tensor,   # (G,) int32
    capacity: int,
) -> torch.Tensor:
    """The (G, capacity, D) buckets the gather kernels never write: live
    positions hold their flat row, the rest are exact zeros."""
    idx, live = _segment_rows(offsets, group_sizes, capacity)
    buckets = x[idx.clamp(0, max(x.shape[0] - 1, 0))]
    return torch.where(live[..., None], buckets,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def scatter_rows(
    y: torch.Tensor,             # (G, capacity, D) bucket-padded values
    offsets: torch.Tensor,
    group_sizes: torch.Tensor,
    out_rows: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Inverse of :func:`gather_buckets`: bucket g's first count_g rows land
    at ``[offsets[g], offsets[g] + count_g)`` of a flat ``(out_rows, D)``
    array. Rows no live segment covers keep what ``out`` held (zeros when
    ``out`` is None, as the JAX oracle gives)."""
    g, cap, d = y.shape
    idx, live = _segment_rows(offsets, group_sizes, cap)
    flat = torch.where(live & (idx < out_rows), idx, out_rows)    # drop row
    ext = y.new_zeros((out_rows + 1, d)) if out is None else torch.cat(
        [out, out.new_zeros((1, d))])
    ext[flat.reshape(-1)] = y.reshape(g * cap, d)
    if out is None:
        return ext[:out_rows]
    out.copy_(ext[:out_rows])
    return out


def gmm_gather(x, w, offsets, group_sizes, capacity: int,
               groups_per_weight: int = 1) -> torch.Tensor:
    """:func:`gmm_ragged` over the buckets gathered from flat rows:
    (R, D) -> (G, capacity, F) with zero tails."""
    buckets = gather_buckets(x, offsets, group_sizes, capacity)
    return gmm_ragged(buckets, w, group_sizes, groups_per_weight)


def gmm_dual_act_gather(x, wg, wu, offsets, group_sizes, capacity: int,
                        groups_per_weight: int = 1) -> torch.Tensor:
    """:func:`gmm_dual_act_ragged` over the buckets gathered from flat rows:
    (R, D) -> (G, capacity, F) with zero tails."""
    buckets = gather_buckets(x, offsets, group_sizes, capacity)
    return gmm_dual_act_ragged(buckets, wg, wu, group_sizes, groups_per_weight)


def gmm_scatter(x, w, offsets, group_sizes, out_rows: int,
                groups_per_weight: int = 1, out=None) -> torch.Tensor:
    """:func:`gmm_ragged` whose live rows are stored at the bucket offsets of
    a flat (out_rows, F) array (see :func:`scatter_rows`)."""
    y = gmm_ragged(x, w, group_sizes, groups_per_weight)
    return scatter_rows(y, offsets, group_sizes, out_rows, out)


def expert_ffn_compact(x, wg, wu, wd, offsets, group_sizes, capacity: int,
                       groups_per_weight: int = 1, out=None) -> torch.Tensor:
    """The gather + scatter pair: flat rows in, flat rows out at the same
    offsets, the hidden tensor in x.dtype between the two."""
    h = gmm_dual_act_gather(x, wg, wu, offsets, group_sizes, capacity,
                            groups_per_weight)
    return gmm_scatter(h, wd, offsets, group_sizes, x.shape[0],
                       groups_per_weight, out)


def gmm_fused_ffn(x, wg, wu, wd, offsets, group_sizes, capacity: int,
                  groups_per_weight: int = 1, out=None) -> torch.Tensor:
    """Plain version of the one-kernel FFN: the fusion keeps the hidden
    tensor out of device memory and changes no arithmetic (the hidden block
    is cast to x.dtype as in the pair), so it is the pair composed. ``wd``
    may have another output width than D: the result is (R, D_out)."""
    return expert_ffn_compact(x, wg, wu, wd, offsets, group_sizes, capacity,
                              groups_per_weight, out)
