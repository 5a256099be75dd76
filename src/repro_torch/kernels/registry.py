"""Kernel entry points: the one place model code asks for hot-path kernels.

Model code decides once, with ``ParallelCtx.kernels_on(tensor)``, whether
a call takes a kernel; when it does, it calls these names:

* ``expert_ffn``          — count-aware grouped SwiGLU FFN over padded
  buckets (``gmm_dual_act_ragged`` + ``gmm_ragged``);
* ``expert_ffn_from_rows`` — the same FFN over flat dispatch-ordered rows
  (``gmm_dual_act_gather`` + ``gmm_ragged``, or with ``compact_out`` +
  ``gmm_scatter``, or with ``fused`` the one kernel ``gmm_fused_ffn``);
* ``attend``              — causal/bidirectional GQA flash attention
  (the ``flash_attention`` wrapper);
* ``decode_attend``       — one-token decode over a dense cache with a
  validity mask (the ``flash_decode`` wrapper);
* ``decode_attend_partials`` — the same over one rank's slice of the
  cache, as fp32 ``(acc, m, l)`` partials (``flash_decode`` with
  ``return_partials``; ``collectives.merge_partials`` merges them across
  the model group);
* ``decode_attend_paged`` — one-token decode over a paged KV pool (the
  ``flash_decode_paged`` wrapper).

Beside this module, the op layer (``kernels/gmm/ops.py``,
``kernels/flash_decode/ops.py``, ``kernels/flash_attention/ops.py``) gives
every kernel under the JAX package's op names, the padded ``gmm`` /
``gmm_dual_act``, ``gmm_gather`` and the paged decode's partials mode
included. No model path calls it, as in the reference.

Each wrapper launches its hand-written CUDA kernel on CUDA tensors (or
raises on a shape outside its ``can_*`` gate) and runs its plain PyTorch
version on CPU tensors; there is no fallback on the card. The gates are
derived for Hopper from what each kernel's tiles take (head dim, dtype,
16-byte vectors), not from the TPU's (8, 128) tiling.

``attend``, ``expert_ffn`` and ``expert_ffn_from_rows`` are differentiable
on every device: each runs through a ``torch.autograd.Function`` (the
reference's ``jax.custom_vjp``s) whose forward calls the wrapper (the CUDA
kernel on a CUDA tensor, the plain version on a CPU tensor) and saves its
inputs, never its output, and whose backward recomputes the plain version
under autograd and returns its gradients: kernel forward, recomputed plain
backward, as the reference pairs them. The backward launches no kernel.
The decode entries serve only inference and have no backward.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    can_flash_attend,
    flash_attention,
)
from repro_torch.kernels.flash_decode.flash_decode import can_flash_decode, flash_decode
from repro_torch.kernels.flash_decode.paged import (
    can_flash_decode_paged,
    flash_decode_paged,
)
from repro_torch.kernels.gmm import ref as gmm_ref
from repro_torch.kernels.gmm.ragged import (
    can_gmm,
    gmm_dual_act_gather,
    gmm_dual_act_ragged,
    gmm_fused_ffn,
    gmm_ragged,
    gmm_scatter,
)

__all__ = [
    "FUSED_FFN_MAX_DOWN_DIM",
    "attend",
    "can_flash_attend",
    "can_flash_decode",
    "can_flash_decode_paged",
    "can_gmm",
    "can_gmm_fused",
    "can_gmm_gather",
    "decode_attend",
    "decode_attend_paged",
    "decode_attend_partials",
    "expert_ffn",
    "expert_ffn_from_rows",
]

decode_attend_paged = flash_decode_paged


# ---------------------------------------------------------------------------
# autograd: kernel forward, recomputed plain backward
# ---------------------------------------------------------------------------

def _plain_grads(fctx, plain, inputs, ct):
    """The gradients of ``plain(*inputs)`` against the cotangent ``ct``, for
    the inputs whose ``needs_input_grad`` is set (None for the others): the
    plain version is recomputed on detached copies under autograd."""
    need = fctx.needs_input_grad[: len(inputs)]
    leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, need)]
    with torch.enable_grad():
        out = plain(*leaves)
    wanted = [t for t, n in zip(leaves, need) if n]
    grads = iter(torch.autograd.grad(out, wanted, ct, allow_unused=True) if wanted else ())
    return tuple(next(grads) if n else None for n in need)


class _ExpertFFN(torch.autograd.Function):
    """``expert_ffn`` (the reference's ``_ffn_kernel``): the ragged pair
    forward; the backward through ``ref.expert_ffn_ragged``."""

    @staticmethod
    def forward(fctx, x, wg, wu, wd, group_sizes, gpw: int):
        fctx.save_for_backward(x, wg, wu, wd, group_sizes)
        fctx.gpw = gpw
        h = gmm_dual_act_ragged(x, wg, wu, group_sizes, gpw)
        return gmm_ragged(h, wd, group_sizes, gpw)

    @staticmethod
    def backward(fctx, ct):
        x, wg, wu, wd, gs = fctx.saved_tensors
        grads = _plain_grads(
            fctx, lambda a, b, c, d: gmm_ref.expert_ffn_ragged(a, b, c, d, gs, fctx.gpw),
            (x, wg, wu, wd), ct)
        return (*grads, None, None)


def _gather_plain(x, wg, wu, wd, offsets, group_sizes, capacity: int, gpw: int):
    """The padded-output flat-row FFN in plain torch: (R, D) -> (G,
    capacity, D_out), zero tails (the reference's ``expert_ffn_gather_ref``)."""
    h = gmm_ref.gmm_dual_act_gather(x, wg, wu, offsets, group_sizes, capacity, gpw)
    return gmm_ref.gmm_ragged(h, wd, group_sizes, gpw)


def _gather_kernels(x, wg, wu, wd, offsets, group_sizes, capacity: int, gpw: int):
    h = gmm_dual_act_gather(x, wg, wu, offsets, group_sizes, capacity, gpw)
    return gmm_ragged(h, wd, group_sizes, gpw)


def _compact_kernels(x, wg, wu, wd, offsets, group_sizes, capacity: int, gpw: int):
    h = gmm_dual_act_gather(x, wg, wu, offsets, group_sizes, capacity, gpw)
    return gmm_scatter(h, wd, offsets, group_sizes, x.shape[0], gpw)


class _RowsFFN(torch.autograd.Function):
    """One flat-row form of ``expert_ffn_from_rows``: ``fwd`` its kernels
    (the reference's ``_ffn_gather_kernel``, ``_ffn_compact_kernel`` or
    ``_ffn_fused_kernel``), ``plain`` its plain version for the backward.
    Rows of a compact output outside the live segments are unspecified
    (they may hold NaN), so only the inputs are saved; the plain scatter's
    backward reads the cotangent at live rows only."""

    @staticmethod
    def forward(fctx, x, wg, wu, wd, offsets, group_sizes, capacity: int, gpw: int,
                fwd, plain):
        fctx.save_for_backward(x, wg, wu, wd, offsets, group_sizes)
        fctx.args = (capacity, gpw, plain)
        return fwd(x, wg, wu, wd, offsets, group_sizes, capacity, gpw)

    @staticmethod
    def backward(fctx, ct):
        x, wg, wu, wd, offs, gs = fctx.saved_tensors
        cap, gpw, plain = fctx.args
        grads = _plain_grads(
            fctx, lambda a, b, c, d: plain(a, b, c, d, offs, gs, cap, gpw),
            (x, wg, wu, wd), ct)
        return (*grads, None, None, None, None, None, None)


class _Attend(torch.autograd.Function):
    """``attend`` (the reference's ``_attend_kernel``): ``flash_attention``
    forward; the backward through ``models.attention.chunked_gqa_attend``,
    the online-softmax plain attention, as the reference's is."""

    @staticmethod
    def forward(fctx, q, k, v, causal: bool, window: int):
        fctx.save_for_backward(q, k, v)
        fctx.args = (causal, window)
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(fctx, ct):
        from repro_torch.models.attention import chunked_gqa_attend  # import cycle

        causal, window = fctx.args
        grads = _plain_grads(
            fctx, lambda q, k, v: chunked_gqa_attend(q, k, v, causal, window),
            fctx.saved_tensors, ct)
        return (*grads, None, None)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
           window: int = 0) -> torch.Tensor:
    """Flash GQA attention, q (B, S, H, hd), k/v (B, T, K, hd) -> (B, S, H,
    hd), queries at the tail of the key range (``flash_attention``);
    differentiable."""
    return _Attend.apply(q, k, v, causal, window)


def expert_ffn(
    x: torch.Tensor,                  # (G, C, D)
    wg: torch.Tensor,                 # (G/gpw, D, F)
    wu: torch.Tensor,                 # (G/gpw, D, F)
    wd: torch.Tensor,                 # (G/gpw, F, D)
    group_sizes: torch.Tensor,        # (G,) int32 valid-row counts
    groups_per_weight: int = 1,
) -> torch.Tensor:
    """Grouped SwiGLU expert FFN; rows past each group's count are zero and
    cost no weight traffic on the card. Differentiable."""
    return _ExpertFFN.apply(x, wg, wu, wd, group_sizes, groups_per_weight)


def can_gmm_gather(capacity: int, d: int, f: int, dtype: torch.dtype) -> bool:
    """Can the gather/scatter pair take flat rows into (G, capacity)
    buckets with (d, f) expert dims? The ragged kernels' gate both ways
    (any capacity: row tiles are bounds-checked)."""
    return can_gmm(d, f, dtype) and can_gmm(f, d, dtype)


# The reference's bound for the one-kernel FFN: its (bm, d_out) output
# accumulator, staging tile and w_down panel scale with d_out and must fit
# VMEM, so wider models take the gather + scatter pair. Kept at the same
# value so the port makes the same fused-or-pair decision at every shape
# (the CUDA kernel tiles d_out over blocks and has no such limit itself).
FUSED_FFN_MAX_DOWN_DIM = 4096


def can_gmm_fused(capacity: int, d: int, f: int, dtype: torch.dtype,
                  d_out: int | None = None) -> bool:
    """Can ``gmm_fused_ffn`` take flat rows with (d, f, d_out) expert dims?
    The pair's gates plus the reference's bound on ``d_out`` (default d)."""
    d_out = d if d_out is None else d_out
    return (can_gmm(d, f, dtype) and can_gmm(f, d_out, dtype)
            and d_out <= FUSED_FFN_MAX_DOWN_DIM)


def expert_ffn_from_rows(
    x: torch.Tensor,             # (R, D) flat rows, bucket-contiguous
    wg: torch.Tensor,            # (G/gpw, D, F)
    wu: torch.Tensor,            # (G/gpw, D, F)
    wd: torch.Tensor,            # (G/gpw, F, D_out)
    offsets: torch.Tensor,       # (G,) int32 first row of each bucket
    group_sizes: torch.Tensor,   # (G,) int32 rows of each bucket
    *,
    capacity: int,
    groups_per_weight: int = 1,
    compact_out: bool = False,
    fused: bool = False,
) -> torch.Tensor:
    """Grouped SwiGLU FFN over flat rows: bucket g's tokens are rows
    ``offsets[g] .. offsets[g] + count_g`` of ``x``, read in place (the
    padded ``(G, capacity, D)`` dispatch buffer is never written).

    By default the output is bucket-padded ``(G, capacity, D_out)`` with
    zero tails. ``compact_out=True`` stores the result back at the same
    offsets, a flat ``(R, D_out)`` array whose rows outside live segments
    are unspecified (the caller combines through the dispatch metadata,
    ``collectives.combine_from_rows``). ``fused=True`` (requires
    ``compact_out``) runs the three products as one kernel when
    :func:`can_gmm_fused` admits the shapes, and the gather + scatter pair
    otherwise — the reference's decision at every shape. Differentiable
    (the fused form's backward is the pair's plain math, as the
    reference's)."""
    if fused and not compact_out:
        raise ValueError(
            "expert_ffn_from_rows: fused=True requires compact_out=True — the "
            "one-kernel path always emits the flat compact layout"
        )
    offsets = offsets.to(torch.int32)
    group_sizes = group_sizes.to(torch.int32)
    if fused and can_gmm_fused(capacity, x.shape[-1], wg.shape[-1], x.dtype,
                               wd.shape[-1]):
        fwd, plain = gmm_fused_ffn, gmm_ref.gmm_fused_ffn
    elif compact_out:
        fwd, plain = _compact_kernels, gmm_ref.expert_ffn_compact
    else:
        fwd, plain = _gather_kernels, _gather_plain
    return _RowsFFN.apply(x, wg, wu, wd, offsets, group_sizes, capacity,
                          groups_per_weight, fwd, plain)


def decode_attend(
    q: torch.Tensor,        # (B, H, hd) — the new token's queries
    k: torch.Tensor,        # (B, T, K, hd)
    v: torch.Tensor,        # (B, T, K, hd)
    valid: torch.Tensor,    # (B, T) bool/int cache-slot validity
) -> torch.Tensor:
    """One-token GQA decode over a dense cache (``flash_decode``)."""
    return flash_decode(q, k, v, valid.to(torch.int32).contiguous())


def decode_attend_partials(
    q: torch.Tensor,        # (B, H, hd)
    k: torch.Tensor,        # (B, T, K, hd) — one rank's slice of the cache
    v: torch.Tensor,
    valid: torch.Tensor,    # (B, T) bool/int
):
    """Unnormalised fp32 ``(acc (B, H, hd), m (B, H), l (B, H))`` over this
    KV slice (``flash_decode(..., return_partials=True)``); partials over
    disjoint slices merge exactly (``collectives.merge_partials``)."""
    return flash_decode(q, k, v, valid.to(torch.int32).contiguous(),
                        return_partials=True)

