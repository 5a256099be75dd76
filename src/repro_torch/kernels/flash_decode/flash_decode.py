"""Wrapper for the dense-cache flash-decode CUDA kernel
(``csrc/flash_decode.cu``), replacing the TPU kernel
``repro/kernels/flash_decode/flash_decode.py::flash_decode`` in both of its
modes: the normalised output, and with ``return_partials`` the fp32
``(acc, m, l)`` partials over one KV slice that the sequence-parallel
decode under a mesh merges across ranks
(``parallel.collectives.seq_parallel_decode_attend``).

The kernel splits the cache's T slots into chunks of ``paged.CHUNK`` keys;
the last live split block of each (request, KV head) to finish merges
the splits in the same launch (``csrc/decode_split.cuh``). The split count
comes from the static shape T only (``paged.split_count``): the wrapper
never reads ``valid`` on the host. It allocates the fp32 split scratch
with ``torch.empty`` and shares the paged wrapper's arrival counters.

On a CUDA tensor it launches the kernel (or raises on what the kernel does
not take); on a CPU tensor it runs :func:`ref.decode` or
:func:`ref.decode_partials`. ``flash_decode.launches`` counts calls of the
normalised mode, ``flash_decode_partials.launches`` those of the partials
mode: one per call.

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
from repro_torch.kernels.flash_decode.paged import (
    DTYPES,
    aligned,
    shape_ok,
    split_buffers,
    stream,
)


def can_flash_decode(t: int, nh: int, nkv: int, hd: int, dtype: torch.dtype) -> bool:
    """Hopper gate: a GQA group of at most 16 heads, a head dim that is a
    multiple of 32 up to 256, and the split block's shared memory
    (``paged.smem_bytes``) within a block's 227 KB. Any cache length ``t``:
    a chunk's slots past T are never read."""
    return t > 0 and shape_ok(nh, nkv, hd, dtype)


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
    if not aligned(q, k, v):
        raise ValueError(f"{name}: q, k and v must start on 16 bytes")


def _plan(q, k, v, valid, *, partials: bool, name: str):
    """Check the inputs, allocate the outputs and the scratch: (outputs,
    scratch, counters, the launch's int arguments). Reads shapes, never
    values."""
    _check(q, k, v, valid, name)
    b, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    outs, scratch, arrived, s = split_buffers(q, nkv, t, partials)
    return outs, scratch, arrived, (b, nh, nkv, hd, t, s, DTYPES[q.dtype])


def _launch(fn_name: str, q, k, v, valid, *, partials: bool):
    outs, scratch, arrived, ints = _plan(q, k, v, valid, partials=partials, name=fn_name)
    fn = build.entry("flash_decode", f"{fn_name}_launch", 6 + len(outs), len(ints))
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        *(o.data_ptr() for o in outs), scratch.data_ptr(), arrived.data_ptr(), *ints,
        stream(q),
    )
    build.check(rc, fn_name)
    return outs


def flash_decode(q, k, v, valid, *, return_partials: bool = False):
    """q (B, H, hd) against a dense cache k/v (B, T, K, hd) where
    ``valid`` (B, T) marks the keys to attend -> (B, H, hd); with
    ``return_partials`` the fp32 ``(acc (B, H, hd), m (B, H), l (B, H))``
    (:func:`flash_decode_partials`)."""
    if return_partials:
        return flash_decode_partials(q, k, v, valid)
    if not q.is_cuda:
        return ref.decode(q, k, v, valid.bool())
    (out,) = _launch("flash_decode", q, k, v, valid, partials=False)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_partials(q, k, v, valid):
    """The partials mode: fp32 ``(acc, m, l)`` over this KV slice, not
    normalised (same inputs and gate as :func:`flash_decode`)."""
    if not q.is_cuda:
        return ref.decode_partials(q, k, v, valid.bool())
    acc, m, l = _launch("flash_decode_partials", q, k, v, valid, partials=True)
    flash_decode_partials.launches += 1
    return acc, m, l


flash_decode_partials.launches = 0
