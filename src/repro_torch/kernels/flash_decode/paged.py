"""Wrapper for the paged flash-decode CUDA kernel
(``csrc/flash_decode_paged.cu``), replacing the TPU kernel
``repro/kernels/flash_decode/paged.py::flash_decode_paged`` in both of its
modes: the normalised output, and with ``return_partials`` the fp32
``(acc, m, l)`` partials over the request's pages, which merge exactly
over disjoint page ranges (``ref.merge_partials_local``).

The kernel splits each request's keys into chunks of :data:`CHUNK`; the
last live split block of each (request, KV head) to finish merges the
splits in the same launch (``csrc/decode_split.cuh``). The split count comes from
static shapes only (:func:`split_count` of ``NB * bs``): the wrapper never
reads ``lengths`` or the tables on the host. It allocates the fp32 split
scratch with ``torch.empty`` and keeps the zeroed arrival counters
(:func:`repro_torch.kernels.build.arrival_counters`) across calls;
launches on one stream run in order, and each leaves the counters zero.

On a CUDA tensor it launches the kernel (or raises on what the kernel does
not take); on a CPU tensor it runs :func:`ref.paged_decode` or
:func:`ref.paged_decode_partials`. ``flash_decode_paged.launches`` counts
calls of the normalised mode, ``flash_decode_paged_partials.launches``
those of the partials mode: one per call. A request of length 0 gives
``m = -1e30``, ``l = 0``, ``acc = 0`` (as the dense partials).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 16          # query heads per KV head held in one block
MAX_HEAD_DIM = 256      # a multiple of 32 (csrc/decode_split.cuh MAX_HD)
CHUNK = 64              # keys a chunk of a split (decode_split.cuh CHUNK)
MAX_SPLITS = 32         # beyond 32 chunks a split takes several
SMEM_LIMIT = 232448     # a block's opt-in shared memory on Hopper


def split_count(n_keys: int) -> int:
    """Splits of a call over ``n_keys`` key slots a request (``T`` dense,
    ``NB * bs`` paged): one per chunk of :data:`CHUNK` keys, at most
    :data:`MAX_SPLITS`. A static shape: no length or mask is read."""
    return max(1, min(-(-n_keys // CHUNK), MAX_SPLITS))


def smem_bytes(g: int, hd: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one split block (``decode_split.cuh``
    ``smem_bytes``): the K and V tiles of a chunk with their row padding;
    the q panel (fp32 at the group padded to 4, 8 or 16 heads, or bf16 at
    8 or 16 rows for the tensor cores); the fp32 scores; p in bf16 (tensor
    cores); the softmax state; each key's row offset and liveness, and the
    request's live-split mask."""
    ng = 4 if g <= 4 else 8 if g <= 8 else 16
    tail = 4 * CHUNK * ng + 4 * 3 * MAX_GROUP + 12 * CHUNK + 16
    if dtype == torch.float32:
        return 2 * CHUNK * (hd * 4 + 32) + 4 * ng * hd + tail
    nh = 8 if ng <= 8 else 16
    return 2 * CHUNK * (hd * 2 + 16) + 2 * nh * (hd + 8) + 2 * nh * (CHUNK + 8) + tail


@functools.lru_cache(maxsize=None)
def shape_ok(nh: int, nkv: int, hd: int, dtype: torch.dtype) -> bool:
    """The gate both decode kernels share: dtype, group, head dim and the
    split block's shared memory."""
    if dtype not in DTYPES or nkv <= 0 or nh % nkv:
        return False
    g = nh // nkv
    return (1 <= g <= MAX_GROUP and hd % 32 == 0 and 0 < hd <= MAX_HEAD_DIM
            and smem_bytes(g, hd, dtype) <= SMEM_LIMIT)


def can_flash_decode_paged(page_size: int, nh: int, nkv: int, hd: int,
                           dtype: torch.dtype) -> bool:
    """Hopper gate: a GQA group of at most 16 heads, a head dim that is a
    multiple of 32 up to 256, and the split block's shared memory
    (:func:`smem_bytes`, at most 156,624 bytes at those limits) within a
    block's 227 KB. Any page size: a row's page is looked up per row."""
    return page_size > 0 and shape_ok(nh, nkv, hd, dtype)


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
    if not aligned(q, pool_k, pool_v):
        raise ValueError(f"{name}: q and the pools must start on 16 bytes")


def aligned(*tensors) -> bool:
    """Whether every tensor starts on 16 bytes (the kernels read q and K/V
    rows in 16-byte pieces)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def split_buffers(q, nkv: int, n_keys: int, partials: bool):
    """The outputs, the fp32 split scratch (S x B x H x (hd + 2)) and the
    arrival counters of a call over ``n_keys`` key slots a request,
    allocated on q's device from shapes alone. Returns (outputs, scratch,
    counters, S)."""
    b, nh, hd = q.shape
    s = split_count(n_keys)
    scratch = torch.empty(s * b * nh * (hd + 2), dtype=torch.float32, device=q.device)
    arrived = build.arrival_counters(q.device, b * nkv)
    if partials:
        outs = (torch.empty((b, nh, hd), dtype=torch.float32, device=q.device),
                torch.empty((b, nh), dtype=torch.float32, device=q.device),
                torch.empty((b, nh), dtype=torch.float32, device=q.device))
    else:
        outs = (torch.empty_like(q),)
    return outs, scratch, arrived, s


def stream(q) -> int:
    """The handle of the current CUDA stream on q's device (the raw getter:
    ``torch.cuda.current_stream(device).cuda_stream`` costs microseconds a
    call, as much as a decode kernel's launch)."""
    return torch._C._cuda_getCurrentRawStream(q.get_device())


def _plan(q, pool_k, pool_v, block_tables, lengths, *, partials: bool, name: str):
    """Check the inputs, allocate the outputs and the scratch: (outputs,
    scratch, counters, the launch's int arguments). Reads shapes, never
    values."""
    _check(q, pool_k, pool_v, block_tables, lengths, name)
    b, nh, hd = q.shape
    bs, nkv, nb = pool_k.shape[1], pool_k.shape[2], block_tables.shape[1]
    outs, scratch, arrived, s = split_buffers(q, nkv, nb * bs, partials)
    return outs, scratch, arrived, (b, nh, nkv, hd, bs, nb, s, DTYPES[q.dtype])


def _launch(fn_name: str, q, pool_k, pool_v, block_tables, lengths, *, partials: bool):
    outs, scratch, arrived, ints = _plan(q, pool_k, pool_v, block_tables, lengths,
                                         partials=partials, name=fn_name)
    fn = build.entry("flash_decode_paged", f"{fn_name}_launch", 7 + len(outs), len(ints))
    rc = fn(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), *(o.data_ptr() for o in outs),
        scratch.data_ptr(), arrived.data_ptr(), *ints, stream(q),
    )
    build.check(rc, fn_name)
    return outs


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
    (out,) = _launch("flash_decode_paged", q, pool_k, pool_v, block_tables, lengths,
                     partials=False)
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0


def flash_decode_paged_partials(q, pool_k, pool_v, block_tables, lengths):
    """The partials mode: fp32 ``(acc, m, l)`` over each request's first
    ``lengths[b]`` keys, not normalised (same inputs and gate as
    :func:`flash_decode_paged`)."""
    if not q.is_cuda:
        return ref.paged_decode_partials(q, pool_k, pool_v, block_tables, lengths)
    acc, m, l = _launch("flash_decode_paged_partials", q, pool_k, pool_v, block_tables,
                        lengths, partials=True)
    flash_decode_paged_partials.launches += 1
    return acc, m, l


flash_decode_paged_partials.launches = 0
