"""Wrapper for the paged flash-decode CUDA kernel
(``csrc/flash_decode_paged.cu``), replacing the TPU kernel
``repro/kernels/flash_decode/paged.py::flash_decode_paged`` in both of its
modes: the normalised output, and with ``return_partials`` the fp32
``(acc, m, l)`` partials over the request's pages, which merge exactly
over disjoint page ranges (``ref.merge_partials_local``).

On a CUDA tensor it launches the kernel (or raises on what the kernel does
not take); on a CPU tensor it runs :func:`ref.paged_decode` or
:func:`ref.paged_decode_partials`. ``flash_decode_paged.launches`` counts
launches of the normalised mode, ``flash_decode_paged_partials.launches``
those of the partials mode. A request of length 0 gives ``m = -1e30``,
``l = 0``, ``acc = 0`` (as the dense partials).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 16          # query heads per KV head held in one block
SMEM_LIMIT = 48 * 1024  # static launch limit, no opt-in attribute


def can_flash_decode_paged(page_size: int, nh: int, nkv: int, hd: int,
                           dtype: torch.dtype) -> bool:
    """Hopper gate: GQA group of at most 16 heads, head dim a multiple of a
    warp (lanes split it) up to 256, and the block's fp32 panels (q, acc,
    one page of scores) within 48 KB of shared memory."""
    if dtype not in DTYPES or nkv <= 0 or nh % nkv:
        return False
    g = nh // nkv
    smem = 4 * (2 * g * hd + g * page_size + 3 * g)
    return g <= MAX_GROUP and hd % 32 == 0 and hd <= 256 and smem <= SMEM_LIMIT


def _check(q, pool_k, pool_v, block_tables, lengths, name: str) -> None:
    b, nh, hd = q.shape
    _, bs, nkv, hd_k = pool_k.shape
    nb = block_tables.shape[1]
    if hd_k != hd or pool_v.shape != pool_k.shape:
        raise ValueError(
            f"{name}: q {tuple(q.shape)} vs pools "
            f"{tuple(pool_k.shape)}/{tuple(pool_v.shape)}"
        )
    if not can_flash_decode_paged(bs, nh, nkv, hd, q.dtype):
        raise ValueError(
            f"{name}: bs={bs}, H={nh}, K={nkv}, hd={hd}, "
            f"{q.dtype} is outside the kernel's gate"
        )
    for t in (pool_k, pool_v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: pools must match q")
    for t in (block_tables, lengths):
        if t.dtype != torch.int32 or t.device != q.device:
            raise ValueError(f"{name}: tables/lengths must be int32 on q's device")
    if block_tables.shape != (b, nb) or lengths.shape != (b,):
        raise ValueError(f"{name}: tables (B, NB), lengths (B,)")
    for t in (q, pool_k, pool_v, block_tables, lengths):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _dims(q, pool_k, block_tables):
    b, nh, hd = q.shape
    return b, nh, pool_k.shape[2], hd, pool_k.shape[1], block_tables.shape[1]


def flash_decode_paged(q, pool_k, pool_v, block_tables, lengths, *,
                       return_partials: bool = False):
    """q (B, H, hd) against the pages ``block_tables[b, :ceil(len/bs)]`` of
    the pool (P, bs, K, hd) -> (B, H, hd); with ``return_partials`` the fp32
    ``(acc (B, H, hd), m (B, H), l (B, H))``
    (:func:`flash_decode_paged_partials`)."""
    if return_partials:
        return flash_decode_paged_partials(q, pool_k, pool_v, block_tables, lengths)
    if not q.is_cuda:
        return ref.paged_decode(q, pool_k, pool_v, block_tables, lengths)
    _check(q, pool_k, pool_v, block_tables, lengths, "flash_decode_paged")
    out = torch.empty_like(q)
    fn = build.entry("flash_decode_paged", "flash_decode_paged_launch", 6, 7)
    rc = fn(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        *_dims(q, pool_k, block_tables), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "flash_decode_paged")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0


def flash_decode_paged_partials(q, pool_k, pool_v, block_tables, lengths):
    """The partials mode: fp32 ``(acc, m, l)`` over each request's first
    ``lengths[b]`` keys, not normalised (same inputs and gate as
    :func:`flash_decode_paged`)."""
    if not q.is_cuda:
        return ref.paged_decode_partials(q, pool_k, pool_v, block_tables, lengths)
    _check(q, pool_k, pool_v, block_tables, lengths, "flash_decode_paged_partials")
    b, nh, hd = q.shape
    acc = torch.empty((b, nh, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, nh), dtype=torch.float32, device=q.device)
    l = torch.empty((b, nh), dtype=torch.float32, device=q.device)
    fn = build.entry("flash_decode_paged", "flash_decode_paged_partials_launch", 8, 7)
    rc = fn(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        *_dims(q, pool_k, block_tables), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "flash_decode_paged_partials")
    flash_decode_paged_partials.launches += 1
    return acc, m, l


flash_decode_paged_partials.launches = 0
