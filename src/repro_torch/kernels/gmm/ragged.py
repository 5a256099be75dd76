"""Wrappers for the ragged grouped-matmul CUDA kernels, replacing the TPU
kernels of ``repro/kernels/gmm/ragged.py``:

* ``gmm_ragged``, ``gmm_dual_act_ragged`` (padded buckets in and out),
  ``gmm_gather``, ``gmm_dual_act_gather`` (flat rows in) and
  ``gmm_scatter`` (flat rows out) — one body per capacity in
  ``csrc/gmm_ragged.cu``, which differ only in where a group's rows live
  (the padded ``gmm`` and ``gmm_dual_act`` of :mod:`.gmm` are a further
  layout of the same bodies). At decode (capacity <= 8) the body splits K
  into :func:`decode_splits` ranges, a count taken from static shapes; the
  wrapper allocates the fp32 split partials with ``torch.empty`` and the
  shared zeroed arrival counters (:func:`decode_buffers`), so it never
  reads a count on the host;
* ``gmm_fused_ffn`` — flat rows in, the hidden block on chip, flat rows out
  (``csrc/gmm_fused_ffn.cu``): fp32 FMA tiles; in bf16 a decode body that
  splits the hidden dimension into :func:`fused_decode_slice` slices (fp32
  partials summed in slice order, as the decode GMM's K splits) and a
  prefill body on clusters of 16 CTAs that hold the (128, D_out)
  accumulator between them (:func:`fused_body`, :func:`fused_smem_bytes`).

Flat layouts: group g's rows are ``[offsets[g], offsets[g] + count_g)`` of
an (R, ·) array, ``count_g = min(group_sizes[g], capacity)``. The kernels
read and write only those rows: a flat output keeps whatever its other rows
held (pass ``out=`` to choose; by default they are zeros, as the plain
version gives).

On a CUDA tensor a wrapper launches its kernel (or raises on what the
kernel does not take); on a CPU tensor it runs the plain version in
:mod:`repro_torch.kernels.gmm.ref`. ``<wrapper>.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gmm import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The decode body (capacity C <= DECODE_ROWS, csrc/gmm_ragged.cu
# gmm_decode_kernel): a block takes a strip of output columns of one group
# over a K range of whole stages.
DECODE_ROWS = 8             # DEC_ROWS: rows a group, the mma's n
DECODE_BK = 64              # DEC_BK: k a stage
RESIDENT_BLOCKS = 264       # two decode blocks on each of an H100's 132 SMs
MIN_SPLIT_STAGES = 8        # at most one K split per 512 k


def decode_strip(dtype: torch.dtype) -> int:
    """Output columns a decode block takes (``dec_cols``): 16 KB of one
    product's weights a stage, 128 bf16 or 64 fp32 columns."""
    return 16384 // (DECODE_BK * torch.empty((), dtype=dtype).element_size())


def decode_splits(g: int, d: int, f: int, dtype: torch.dtype,
                  every_row: bool = False) -> int:
    """K splits S of the decode body, from static shapes only: the smallest
    S for which the blocks of the live groups cover two waves of resident
    blocks, at most one split per :data:`MIN_SPLIT_STAGES` stages; splits
    of ceil(stages / S) stages, none empty. No count is read: with counts,
    dead groups are a run's data, so the plan assumes half the G groups
    live; ``every_row`` (no counts) has all G live."""
    nk = -(-d // DECODE_BK)
    blocks = (g if every_row else -(-g // 2)) * -(-f // decode_strip(dtype))
    s = max(1, min(-(-2 * RESIDENT_BLOCKS // max(blocks, 1)), nk // MIN_SPLIT_STAGES))
    per = -(-nk // s) if nk else 1
    return max(1, -(-nk // per))


def decode_buffers(g: int, c: int, d: int, f: int, dtype: torch.dtype, dual: bool,
                   every_row: bool, device):
    """The split count S of a decode launch (C <= 8), its fp32 partials
    (S x G x C x F per product, ``torch.empty``) and the arrival counters
    (G x strips), from shapes alone; no buffer when S = 1."""
    s = decode_splits(g, d, f, dtype, every_row)
    if s == 1:
        return 1, None, None
    part = torch.empty(s * g * c * f * (2 if dual else 1), dtype=torch.float32, device=device)
    return s, part, build.arrival_counters(device, g * -(-f // decode_strip(dtype)))


# gmm_fused_ffn's bf16 bodies (csrc/gmm_fused_ffn.cu): the decode body
# (capacity <= DECODE_ROWS) takes a slice of the hidden dimension a block,
# the prefill body a cluster of FUSED_RANKS CTAs a (group, 128-row tile).
FUSED_SLICES = (512, 256, 128)   # hidden columns a decode block: FD_MAX_SLICE .. FD_STRIP
FUSED_SLICE_BLOCKS = 128         # live decode blocks a slice width aims at: about one an SM
FUSED_OUT_STRIP = 256            # FD_OSTRIP: output columns a decode partial strip
FUSED_RANKS = 16                 # FC_RANKS: CTAs a prefill cluster (non-portable)


def fused_body(capacity: int, dtype: torch.dtype) -> str:
    """The body a ``gmm_fused_ffn`` launch takes: ``"fma"`` (fp32), or in
    bf16 ``"decode"`` at capacity <= 8 and ``"cluster"`` above."""
    if dtype == torch.float32:
        return "fma"
    return "decode" if capacity <= DECODE_ROWS else "cluster"


def fused_decode_slice(g: int, f: int) -> int:
    """Hidden columns FS a bf16 decode block of ``gmm_fused_ffn`` takes,
    from static shapes only: the widest of :data:`FUSED_SLICES` whose
    S = ceil(F / FS) slices give half the G groups (a run's live groups are
    its data) at least :data:`FUSED_SLICE_BLOCKS` blocks; the narrowest
    when none does. No count is read."""
    live = -(-g // 2)
    for fs in FUSED_SLICES:
        if -(-f // fs) * live >= FUSED_SLICE_BLOCKS:
            return fs
    return FUSED_SLICES[-1]


def fused_smem_bytes(body: str) -> int:
    """Dynamic shared memory a block of a bf16 body of ``gmm_fused_ffn``
    takes, counted as the kernel counts it (``gmm_fused_ffn_smem_bytes``):
    1 KB of alignment, then for ``"decode"`` 3 stages of 32 KB of weights
    and 8 x rows of 144 bytes, 8 hidden rows of 1040 bytes and the
    barriers; for ``"cluster"`` 5 stages of 32 KB (a 128 x 64 x tile and
    64 x 64 boxes of wg and wu, or four of wd), two 16 KB staging slices,
    two 16 KB chunk buffers and 10 barriers."""
    if body == "decode":
        return 1024 + 3 * (32768 + 8 * 144) + 8 * 1040 + 16 * 3 + 16
    if body == "cluster":
        return 1024 + 5 * 32768 + 4 * 16384 + 8 * 10
    raise ValueError(f"fused_smem_bytes: no shared-memory body {body!r}")


def can_gmm(d: int, f: int, dtype: torch.dtype) -> bool:
    """Hopper gate: fp32/bf16 and inner dims that split into 16-byte
    vectors (the kernel loads weights and rows 16 bytes at a time)."""
    if dtype not in DTYPES:
        return False
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    return d % vec == 0 and f % vec == 0


def _check(x, ws, group_sizes, gpw: int, name: str, g: int | None = None):
    """Validate a grouped matmul's operands. ``x`` is (G, C, D) padded
    buckets, or (R, D) flat rows when ``g`` (the group count) is given;
    ``group_sizes`` None means every row is live."""
    if g is None:
        if x.dim() != 3:
            raise ValueError(f"{name}: x must be (G, C, D), got {tuple(x.shape)}")
        g, c, d = x.shape
    else:
        if x.dim() != 2:
            raise ValueError(f"{name}: x must be flat (R, D), got {tuple(x.shape)}")
        c, d = x.shape
    f = ws[0].shape[-1]
    for w in ws:
        if w.shape != (g // gpw, d, f) or g % gpw:
            raise ValueError(
                f"{name}: weight {tuple(w.shape)} does not match x "
                f"{tuple(x.shape)} with groups_per_weight={gpw}"
            )
        if w.dtype != x.dtype or w.device != x.device:
            raise ValueError(f"{name}: weights must match x's dtype and device")
    counts = () if group_sizes is None else (group_sizes,)
    for gs in counts:
        if gs.shape != (g,) or gs.dtype != torch.int32:
            raise ValueError(f"{name}: group_sizes must be int32 of shape ({g},)")
        if gs.device != x.device:
            raise ValueError(f"{name}: group_sizes must lie on {x.device}")
    if not can_gmm(d, f, x.dtype):
        raise ValueError(
            f"{name}: dtype {x.dtype} with D={d}, F={f} is outside the "
            f"kernel's gate (fp32/bf16, D and F multiples of 16 bytes)"
        )
    for t in (x, *ws, *counts):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    for t in (x, *ws):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    return g, c, d, f


def _plan(x, wa, wb, group_sizes, gpw: int, dual: bool, *, name: str,
          capacity: int | None = None, offsets=None, out=None,
          out_rows: int | None = None):
    """Check the operands of one ``gmm_ragged_launch`` and allocate its
    output and, at decode, its split partials and counters: (out, part,
    arrived, the launch's int arguments). Padded buckets by default (every
    row live when ``group_sizes`` is None); a flat (R, D) input with
    ``capacity`` (gather); a flat (out_rows, F) output with ``out_rows``
    (scatter). Reads shapes, never values."""
    ws = (wa, wb) if dual else (wa,)
    gather, scatter = capacity is not None, out_rows is not None
    g = offsets.shape[0] if gather else None
    g, c, d, f = _check(x, ws, group_sizes, gpw, name, g)
    cap = capacity if gather else c
    if gather or scatter:
        _check_offsets(offsets, g, x.device, name)
    if scatter:
        out = _flat_out(out, (out_rows, f), x, name)
    else:
        out = torch.empty((g, cap, f), dtype=x.dtype, device=x.device)
    splits, part, arrived = (decode_buffers(g, cap, d, f, x.dtype, dual,
                                            group_sizes is None, x.device)
                             if cap <= DECODE_ROWS else (1, None, None))
    ints = (g, cap, d, f, gpw, c if gather else 0, out_rows or 0, DTYPES[x.dtype],
            int(dual), splits)
    return out, part, arrived, ints


def _launch(x, wa, wb, group_sizes, gpw: int, dual: bool, *, name: str,
            capacity: int | None = None, offsets=None, out=None,
            out_rows: int | None = None) -> torch.Tensor:
    """One launch of ``gmm_ragged_launch`` (the layouts of :func:`_plan`)."""
    out, part, arrived, ints = _plan(x, wa, wb, group_sizes, gpw, dual, name=name,
                                     capacity=capacity, offsets=offsets, out=out,
                                     out_rows=out_rows)
    gather, scatter = capacity is not None, out_rows is not None
    fn = build.entry("gmm_ragged", "gmm_ragged_launch", 9, len(ints))
    rc = fn(
        x.data_ptr(), wa.data_ptr(), (wb if dual else wa).data_ptr(),
        None if group_sizes is None else group_sizes.data_ptr(),
        offsets.data_ptr() if gather else None,
        offsets.data_ptr() if scatter else None, out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if arrived is None else arrived.data_ptr(),
        *ints, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, name)
    return out


def _check_offsets(offsets, g: int, device, name: str) -> None:
    if offsets.shape != (g,) or offsets.dtype != torch.int32:
        raise ValueError(f"{name}: offsets must be int32 of shape ({g},)")
    if offsets.device != device or not offsets.is_contiguous():
        raise ValueError(f"{name}: offsets must be contiguous on {device}")


def _flat_out(out, shape, x, name: str) -> torch.Tensor:
    """The flat output: ``out`` checked, or a new zero array."""
    if out is None:
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    if out.shape != shape or out.dtype != x.dtype or out.device != x.device:
        raise ValueError(f"{name}: out must be {x.dtype} {shape} on {x.device}")
    if not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError(f"{name}: out must be contiguous and 16-byte aligned")
    return out


def gmm_ragged(x, w, group_sizes, groups_per_weight: int = 1) -> torch.Tensor:
    """y[g, :count_g] = x[g, :count_g] @ w[g // gpw]; tail rows zero."""
    if not x.is_cuda:
        return ref.gmm_ragged(x, w, group_sizes, groups_per_weight)
    out = _launch(x, w, None, group_sizes, groups_per_weight, dual=False,
                  name="gmm_ragged")
    gmm_ragged.launches += 1
    return out


def gmm_dual_act_ragged(
    x, wg, wu, group_sizes, groups_per_weight: int = 1
) -> torch.Tensor:
    """h[g] = silu(x@wg) * (x@wu) on the first count_g rows; tail zero."""
    if not x.is_cuda:
        return ref.gmm_dual_act_ragged(x, wg, wu, group_sizes, groups_per_weight)
    out = _launch(x, wg, wu, group_sizes, groups_per_weight, dual=True,
                  name="gmm_dual_act_ragged")
    gmm_dual_act_ragged.launches += 1
    return out


def gmm_gather(x, w, offsets, group_sizes, capacity: int,
               groups_per_weight: int = 1) -> torch.Tensor:
    """y[g, :count_g] = rows_g @ w[g // gpw] with rows_g read from the flat
    (R, D) array at ``offsets[g]``: (G, capacity, F), zero tails (replaces
    ``ragged.py::gmm_gather``)."""
    if not x.is_cuda:
        return ref.gmm_gather(x, w, offsets, group_sizes, capacity, groups_per_weight)
    out = _launch(x, w, None, group_sizes, groups_per_weight, dual=False,
                  name="gmm_gather", capacity=capacity, offsets=offsets)
    gmm_gather.launches += 1
    return out


def gmm_dual_act_gather(x, wg, wu, offsets, group_sizes, capacity: int,
                        groups_per_weight: int = 1) -> torch.Tensor:
    """h[g, :count_g] = silu(rows_g @ wg) * (rows_g @ wu) with rows_g read
    from the flat (R, D) array at ``offsets[g]``: (G, capacity, F), zero
    tails (replaces ``ragged.py::gmm_dual_act_gather``)."""
    if not x.is_cuda:
        return ref.gmm_dual_act_gather(x, wg, wu, offsets, group_sizes, capacity,
                                       groups_per_weight)
    out = _launch(x, wg, wu, group_sizes, groups_per_weight, dual=True,
                  name="gmm_dual_act_gather", capacity=capacity, offsets=offsets)
    gmm_dual_act_gather.launches += 1
    return out


def gmm_scatter(x, w, offsets, group_sizes, out_rows: int,
                groups_per_weight: int = 1, out=None) -> torch.Tensor:
    """out[offsets[g] + i] = x[g, i] @ w[g // gpw] for i < count_g, into a
    flat (out_rows, F) array; no other row is written (replaces
    ``ragged.py::gmm_scatter``)."""
    if not x.is_cuda:
        return ref.gmm_scatter(x, w, offsets, group_sizes, out_rows,
                               groups_per_weight, out)
    out = _launch(x, w, None, group_sizes, groups_per_weight, dual=False,
                  name="gmm_scatter", offsets=offsets, out=out, out_rows=out_rows)
    gmm_scatter.launches += 1
    return out


def _fused_plan(x, wg, wu, wd, offsets, group_sizes, capacity: int, gpw: int, out=None):
    """Check the operands of one ``gmm_fused_ffn_launch`` and allocate its
    flat output and, for the bf16 decode body with more than one hidden
    slice, its fp32 partials (S x G x capacity x D_out) and arrival
    counters (G x ceil(D_out / 256)): (out, part, arrived, the launch's int
    arguments). Reads shapes, never values."""
    name = "gmm_fused_ffn"
    g = offsets.shape[0]
    _, r, d, f = _check(x, (wg, wu), group_sizes, gpw, name, g)
    d_out = wd.shape[-1]
    # w_down as the weight of a flat (0, F) input: shape, dtype, gate, layout
    _check(x.new_empty((0, f)), (wd,), group_sizes, gpw, name, g)
    _check_offsets(offsets, g, x.device, name)
    if min(d, f, d_out) == 0:
        raise ValueError(f"{name}: D, F and D_out must be positive, got {d}, {f}, {d_out}")
    out = _flat_out(out, (r, d_out), x, name)
    fs, part, arrived = 0, None, None
    if fused_body(capacity, x.dtype) == "decode":
        fs = fused_decode_slice(g, f)
        s = -(-f // fs)
        if s > 1:
            part = torch.empty(s * g * capacity * d_out, dtype=torch.float32, device=x.device)
            arrived = build.arrival_counters(x.device, g * -(-d_out // FUSED_OUT_STRIP))
    ints = (g, capacity, d, f, d_out, gpw, r, DTYPES[x.dtype], fs)
    return out, part, arrived, ints


def gmm_fused_ffn(x, wg, wu, wd, offsets, group_sizes, capacity: int,
                  groups_per_weight: int = 1, out=None) -> torch.Tensor:
    """out[offsets[g] + i] = (silu(r @ wg) * (r @ wu)) @ wd for the rows
    r = x[offsets[g] + i], i < count_g, in one kernel: the hidden block is
    cast to x.dtype on chip and never stored (replaces
    ``ragged.py::gmm_fused_ffn``). (R, D) -> (R, D_out); no other row is
    written."""
    if not x.is_cuda:
        return ref.gmm_fused_ffn(x, wg, wu, wd, offsets, group_sizes, capacity,
                                 groups_per_weight, out)
    out, part, arrived, ints = _fused_plan(x, wg, wu, wd, offsets, group_sizes, capacity,
                                           groups_per_weight, out)
    fn = build.entry("gmm_fused_ffn", "gmm_fused_ffn_launch", 9, len(ints))
    rc = fn(
        x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        offsets.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if arrived is None else arrived.data_ptr(),
        *ints, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "gmm_fused_ffn")
    gmm_fused_ffn.launches += 1
    return out


gmm_ragged.launches = 0
gmm_dual_act_ragged.launches = 0
gmm_gather.launches = 0
gmm_dual_act_gather.launches = 0
gmm_scatter.launches = 0
gmm_fused_ffn.launches = 0
