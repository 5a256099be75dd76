"""Plain PyTorch single-token GQA decode attention (dense masked and paged,
normalised or as sequence-parallel partials).

The paged version gathers each request's pages into its dense logical
view, then runs the masked dense decode. Scores and softmax are fp32, p is
cast to the value type before the PV product. Masked keys score
``NEG_INF`` and masked value rows are selected to zero with ``where``, so
garbage (even NaN) in dead rows or dead pages never reaches the output.

:func:`decode_partials` is the unnormalised online-softmax state over one
KV slice, ``(acc, m, l)`` in fp32; partials over disjoint slices merge
exactly (:func:`merge_partials_local`, the LSE merge)::

    m* = max_i m_i;   l* = sum_i l_i e^(m_i - m*);   acc* = sum_i acc_i e^(m_i - m*)
    out = acc* / l*

A slice with no valid key is ``m = NEG_INF``, ``l = 0``, ``acc = 0``: its
weight in the merge is 0 whenever another slice has a live key, and a
merge of slices that are all masked gives zeros, as :func:`decode` does.
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


def decode_partials(
    q: torch.Tensor,        # (B, H, hd)
    k: torch.Tensor,        # (B, T, K, hd) one slice of the cache
    v: torch.Tensor,        # (B, T, K, hd)
    valid: torch.Tensor,    # (B, T) bool
):
    """fp32 ``(acc (B, H, hd), m (B, H), l (B, H))`` over this KV slice, not
    normalised: ``m`` the largest valid score, ``p = e^(s - m)`` on valid
    keys and 0 elsewhere, ``l = sum p``, ``acc = sum p v`` with p cast to
    the value type first (as :func:`decode`), summed in fp32."""
    b, nh, hd = q.shape
    nk = k.shape[2]
    g = nh // nk
    qg = q.reshape(b, nk, g, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float()) / math.sqrt(hd)
    live = valid[:, None, None, :]
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(live, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    v = torch.where(valid[:, :, None, None], v, torch.zeros((), dtype=v.dtype,
                                                             device=v.device))
    acc = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype).float(), v.float())
    return acc.reshape(b, nh, hd), m.reshape(b, nh), l.reshape(b, nh)


def merge_partials_local(parts) -> torch.Tensor:
    """LSE merge of ``[(acc, m, l), ...]`` over disjoint KV slices held in
    one process -> the normalised fp32 output (B, H, hd)."""
    m_max = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    num = sum(acc * torch.exp(m - m_max)[..., None] for acc, m, _ in parts)
    den = sum(l * torch.exp(m - m_max) for _, m, l in parts)
    return num / den.clamp(min=1e-30)[..., None]


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Each request's logical KV view from the pool: (B, NB*bs, K, hd)."""
    b, nb = block_tables.shape
    _, bs, nkv, hd = pool.shape
    return pool[block_tables.reshape(-1).long()].reshape(b, nb * bs, nkv, hd)


def _paged_view(pool_k, pool_v, block_tables, lengths):
    """Each request's logical K/V view and its validity from ``lengths``."""
    k = gather_pages(pool_k, block_tables)
    v = gather_pages(pool_v, block_tables)
    t = k.shape[1]
    valid = torch.arange(t, device=k.device)[None, :] < lengths[:, None].long()
    return k, v, valid


def paged_decode(
    q: torch.Tensor,             # (B, H, hd)
    pool_k: torch.Tensor,        # (P, bs, K, hd)
    pool_v: torch.Tensor,        # (P, bs, K, hd)
    block_tables: torch.Tensor,  # (B, NB) int32
    lengths: torch.Tensor,       # (B,) int32 live context per request
) -> torch.Tensor:
    return decode(q, *_paged_view(pool_k, pool_v, block_tables, lengths))


def paged_decode_partials(q, pool_k, pool_v, block_tables, lengths):
    """:func:`decode_partials` over the pages ``block_tables[b]`` with the
    first ``lengths[b]`` keys valid: fp32 ``(acc, m, l)``; a request of
    length 0 gives ``(0, NEG_INF, 0)``."""
    return decode_partials(q, *_paged_view(pool_k, pool_v, block_tables, lengths))
