"""Plain PyTorch single-token GQA decode attention (dense masked and paged).

The paged version gathers each request's pages into its dense logical
view, then runs the masked dense decode. Scores and softmax are fp32, p is
cast to the value type before the PV product. Masked keys score
``NEG_INF`` and masked value rows are selected to zero with ``where``, so
garbage (even NaN) in dead rows or dead pages never reaches the output.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode(
    q: torch.Tensor,        # (B, H, hd)
    k: torch.Tensor,        # (B, T, K, hd)
    v: torch.Tensor,        # (B, T, K, hd)
    valid: torch.Tensor,    # (B, T) bool
) -> torch.Tensor:
    b, nh, hd = q.shape
    nk = k.shape[2]
    g = nh // nk
    qg = q.reshape(b, nk, g, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float()) / math.sqrt(hd)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    v = torch.where(valid[:, :, None, None], v, torch.zeros((), dtype=v.dtype,
                                                             device=v.device))
    o = torch.einsum("bkgt,btkd->bkgd", p, v)
    return o.reshape(b, nh, hd)


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Each request's logical KV view from the pool: (B, NB*bs, K, hd)."""
    b, nb = block_tables.shape
    _, bs, nkv, hd = pool.shape
    return pool[block_tables.reshape(-1).long()].reshape(b, nb * bs, nkv, hd)


def paged_decode(
    q: torch.Tensor,             # (B, H, hd)
    pool_k: torch.Tensor,        # (P, bs, K, hd)
    pool_v: torch.Tensor,        # (P, bs, K, hd)
    block_tables: torch.Tensor,  # (B, NB) int32
    lengths: torch.Tensor,       # (B,) int32 live context per request
) -> torch.Tensor:
    k = gather_pages(pool_k, block_tables)
    v = gather_pages(pool_v, block_tables)
    t = k.shape[1]
    valid = torch.arange(t, device=q.device)[None, :] < lengths[:, None].long()
    return decode(q, k, v, valid)
