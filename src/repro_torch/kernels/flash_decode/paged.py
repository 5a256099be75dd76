"""Wrapper for the paged flash-decode CUDA kernel
(``csrc/flash_decode_paged.cu``), replacing the TPU kernel
``repro/kernels/flash_decode/paged.py::flash_decode_paged``.

On a CUDA tensor it launches the kernel (or raises on what the kernel does
not take); on a CPU tensor it runs :func:`ref.paged_decode`.
``flash_decode_paged.launches`` counts kernel launches.
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


def flash_decode_paged(q, pool_k, pool_v, block_tables, lengths) -> torch.Tensor:
    """q (B, H, hd) against the pages ``block_tables[b, :ceil(len/bs)]`` of
    the pool (P, bs, K, hd) -> (B, H, hd)."""
    if not q.is_cuda:
        return ref.paged_decode(q, pool_k, pool_v, block_tables, lengths)
    b, nh, hd = q.shape
    _, bs, nkv, hd_k = pool_k.shape
    nb = block_tables.shape[1]
    if hd_k != hd or pool_v.shape != pool_k.shape:
        raise ValueError(
            f"flash_decode_paged: q {tuple(q.shape)} vs pools "
            f"{tuple(pool_k.shape)}/{tuple(pool_v.shape)}"
        )
    if not can_flash_decode_paged(bs, nh, nkv, hd, q.dtype):
        raise ValueError(
            f"flash_decode_paged: bs={bs}, H={nh}, K={nkv}, hd={hd}, "
            f"{q.dtype} is outside the kernel's gate"
        )
    for t in (pool_k, pool_v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_decode_paged: pools must match q")
    for t in (block_tables, lengths):
        if t.dtype != torch.int32 or t.device != q.device:
            raise ValueError(
                "flash_decode_paged: tables/lengths must be int32 on q's device"
            )
    if block_tables.shape != (b, nb) or lengths.shape != (b,):
        raise ValueError("flash_decode_paged: tables (B, NB), lengths (B,)")
    for t in (q, pool_k, pool_v, block_tables, lengths):
        if not t.is_contiguous():
            raise ValueError("flash_decode_paged: inputs must be contiguous")
    out = torch.empty_like(q)
    fn = build.entry("flash_decode_paged", "flash_decode_paged_launch", 6, 7)
    rc = fn(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, nh, nkv, hd, bs, nb, DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "flash_decode_paged")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0
