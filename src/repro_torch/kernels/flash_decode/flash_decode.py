"""Wrapper for the dense-cache flash-decode CUDA kernel
(``csrc/flash_decode.cu``), replacing the TPU kernel
``repro/kernels/flash_decode/flash_decode.py::flash_decode`` in both of its
modes: the normalised output, and with ``return_partials`` the fp32
``(acc, m, l)`` partials over one KV slice that the sequence-parallel
decode under a mesh merges across ranks
(``parallel.collectives.seq_parallel_decode_attend``).

On a CUDA tensor it launches the kernel (or raises on what the kernel does
not take); on a CPU tensor it runs :func:`ref.decode` or
:func:`ref.decode_partials`. ``flash_decode.launches`` counts launches of
the normalised mode, ``flash_decode_partials.launches`` those of the
partials mode.

Masked keys get p = 0 and their K/V rows are never read. A request with no
valid key at all gets a zero output (so does the plain version: its
uniform p over NEG_INF scores meets value rows selected to zero), and in
partials mode ``m = -1e30``, ``l = 0``, ``acc = 0``. The TPU kernel's
NEG_INF = -1e30 would instead give p = 1 to every key of a fully masked
prefix before a later rescale (non-zero ``l`` and ``acc`` for a fully
masked slice; the merged output is the same whenever a slice has a live
key).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import ref
from repro_torch.kernels.flash_decode.paged import DTYPES, MAX_GROUP, SMEM_LIMIT

TILE = 128   # keys per tile (csrc/flash_decode.cu TB)


def can_flash_decode(t: int, nh: int, nkv: int, hd: int, dtype: torch.dtype) -> bool:
    """Hopper gate: GQA group of at most 16 heads, head dim a multiple of a
    warp up to 256, the block's fp32 panels within 48 KB of shared memory.
    Any cache length ``t``: the key loop is bounds-checked."""
    if dtype not in DTYPES or nkv <= 0 or nh % nkv or t <= 0:
        return False
    g = nh // nkv
    smem = 4 * (2 * g * hd + g * TILE + 3 * g + TILE)
    return g <= MAX_GROUP and hd % 32 == 0 and hd <= 256 and smem <= SMEM_LIMIT


def _check(q, k, v, valid, name: str) -> None:
    b, nh, hd = q.shape
    _, t, nkv, hd_k = k.shape
    if k.shape[0] != b or hd_k != hd or v.shape != k.shape:
        raise ValueError(
            f"{name}: q {tuple(q.shape)} vs k {tuple(k.shape)} / v {tuple(v.shape)}"
        )
    if not can_flash_decode(t, nh, nkv, hd, q.dtype):
        raise ValueError(
            f"{name}: T={t}, H={nh}, K={nkv}, hd={hd}, {q.dtype} is outside "
            f"the kernel's gate"
        )
    for x in (k, v):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name}: k/v must match q")
    if valid.shape != (b, t) or valid.dtype != torch.int32 or valid.device != q.device:
        raise ValueError(f"{name}: valid must be int32 ({b}, {t}) on q's device")
    for x in (q, k, v, valid):
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def flash_decode(q, k, v, valid, *, return_partials: bool = False):
    """q (B, H, hd) against a dense cache k/v (B, T, K, hd) where
    ``valid`` (B, T) marks the keys to attend -> (B, H, hd); with
    ``return_partials`` the fp32 ``(acc (B, H, hd), m (B, H), l (B, H))``
    (:func:`flash_decode_partials`)."""
    if return_partials:
        return flash_decode_partials(q, k, v, valid)
    if not q.is_cuda:
        return ref.decode(q, k, v, valid.bool())
    _check(q, k, v, valid, "flash_decode")
    b, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = build.entry("flash_decode", "flash_decode_launch", 5, 6)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
        b, nh, nkv, hd, t, DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_partials(q, k, v, valid):
    """The partials mode: fp32 ``(acc, m, l)`` over this KV slice, not
    normalised (same inputs and gate as :func:`flash_decode`)."""
    if not q.is_cuda:
        return ref.decode_partials(q, k, v, valid.bool())
    _check(q, k, v, valid, "flash_decode_partials")
    b, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    acc = torch.empty((b, nh, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, nh), dtype=torch.float32, device=q.device)
    l = torch.empty((b, nh), dtype=torch.float32, device=q.device)
    fn = build.entry("flash_decode", "flash_decode_partials_launch", 7, 6)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, nh, nkv, hd, t, DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "flash_decode_partials")
    flash_decode_partials.launches += 1
    return acc, m, l


flash_decode_partials.launches = 0
