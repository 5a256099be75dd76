"""Expert-parallel bucket dispatch/combine, single-process subset of
``repro.parallel.collectives`` (the ``torch.distributed`` all_to_all path
comes with multi-GPU EP).

JAX's out-of-range semantics have no torch default, so each is explicit
here: ``jnp.bincount(length=n)`` drops ids ``>= n`` (``bucket_counts``
counts into ``n + 1`` bins and cuts the last); gathers at the decode
sentinel ``total_slots + 1`` clamp to the last row (torch would raise);
``.at[].set(mode="drop")`` scatters only in-range rows; the sort is
stable.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.gmm.ref import expert_ffn_ragged
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.placement import PlacementTable


def bucket_capacity(n_tok: int, k: int, capacity_factor: float, n_buckets: int) -> int:
    """Per-bucket capacity for ``n_tok`` tokens x ``k`` copies over
    ``n_buckets`` buckets: ceiling division, floored at 8."""
    return max(math.ceil(n_tok * k * capacity_factor / n_buckets), 8)


def bucket_counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Occurrences of each id in ``[0, n)`` (int64); ids ``>= n`` are
    dropped, as ``jnp.bincount(length=n)`` drops them. A scatter-add into a
    fixed ``n + 1`` bins, unlike ``torch.bincount``, whose output size
    depends on the data and which therefore waits for the device."""
    idx = ids.reshape(-1).long().clamp(max=n)
    bins = torch.zeros(n + 1, dtype=torch.long, device=idx.device)
    return bins.scatter_add_(0, idx, torch.ones_like(idx))[:n]


def dispatch_metadata(bucket_ids: torch.Tensor, n_buckets: int, capacity: int):
    """Sort/position math of the bucket dispatch without writing buffers.

    Returns ``(row_ids, offsets, counts, slots, keep)`` exactly as the JAX
    reference: compacted source row per position, first compacted row and
    kept count per bucket, within-bucket position and capacity-survival
    mask per copy. Out-of-range ids (the empty-slot sentinel) sort past
    every real bucket and are never kept."""
    n, k = bucket_ids.shape
    flat_b = bucket_ids.reshape(-1).long()
    order = torch.argsort(flat_b, stable=True)
    b_sorted = flat_b[order]
    counts_all = bucket_counts(flat_b, n_buckets)
    offsets = torch.cat([counts_all.new_zeros(1), torch.cumsum(counts_all, 0)[:-1]])
    # Sentinel ids read the last bucket's offset (JAX clamps the gather).
    pos_sorted = torch.arange(n * k, device=flat_b.device) - offsets[
        b_sorted.clamp(max=n_buckets - 1)
    ]
    slots = torch.zeros(n * k, dtype=torch.int32, device=flat_b.device)
    slots[order] = pos_sorted.to(torch.int32)
    keep = (slots < capacity) & (flat_b < n_buckets)
    row_ids = (order // k).to(torch.int32)
    counts = torch.clamp(counts_all, max=capacity).to(torch.int32)
    return (
        row_ids, offsets.to(torch.int32), counts,
        slots.reshape(n, k), keep.reshape(n, k),
    )


def bucket_dispatch(
    x: torch.Tensor,           # (n, d) token activations
    bucket_ids: torch.Tensor,  # (n, k) target bucket per token copy
    n_buckets: int,
    capacity: int,
):
    """Pack token copies into ``(n_buckets, capacity, d)`` buffers; returns
    ``(buffers, slots, keep)``. Earlier tokens win bucket slots; dropped
    copies go to a sacrificial extra bucket that is cut off."""
    n, k = bucket_ids.shape
    d = x.shape[-1]
    _, _, _, slots, keep = dispatch_metadata(bucket_ids, n_buckets, capacity)
    flat_b = bucket_ids.reshape(-1).long()
    flat_keep = keep.reshape(-1)
    slot_b = torch.where(flat_keep, flat_b, torch.full_like(flat_b, n_buckets))
    slot_i = torch.clamp(slots.reshape(-1).long(), max=capacity - 1)
    src = torch.arange(n, device=x.device).repeat_interleave(k)
    buffers = x.new_zeros((n_buckets + 1, capacity, d))
    buffers[slot_b, slot_i] = x[src]
    return buffers[:n_buckets], slots, keep


def bucket_combine(
    y: torch.Tensor,            # (n_buckets, capacity, d) expert outputs
    bucket_ids: torch.Tensor,   # (n, k)
    slots: torch.Tensor,        # (n, k)
    keep: torch.Tensor,         # (n, k)
    weights: torch.Tensor,      # (n, k) router weights
) -> torch.Tensor:
    """Weighted sum of each token's kept copies. Sentinel ids and
    positions clamp into range (as JAX's gather does); their weight is
    zero and the rows they read are the kernels' zero tails."""
    n, k = bucket_ids.shape
    b = bucket_ids.reshape(-1).long().clamp(0, y.shape[0] - 1)
    s = slots.reshape(-1).long().clamp(0, y.shape[1] - 1)
    vals = y[b, s].reshape(n, k, -1)
    w = (weights * keep).to(vals.dtype)
    return torch.einsum("nkd,nk->nd", vals, w)


def combine_from_rows(
    y: torch.Tensor,        # (R, d) flat compact expert outputs
    rows: torch.Tensor,     # (n, k) flat output row per copy (junk when dropped)
    keep: torch.Tensor,     # (n, k) capacity-survival mask
    weights: torch.Tensor,  # (n, k) router weights
) -> torch.Tensor:
    """Weighted sum of each token's kept copies, gathered from the compact
    FFN output at their flat rows (no ``(n_buckets, capacity, d)`` buffer).
    Rows between live segments are never written by the scatter and may
    hold anything, NaN included, so a dropped copy selects zero with
    ``where`` before any arithmetic (``0 * NaN`` would poison the token)."""
    n, k = rows.shape
    safe = rows.reshape(-1).long().clamp(0, y.shape[0] - 1)
    vals = y[safe].reshape(n, k, -1)
    vals = torch.where(keep[..., None], vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))
    w = (weights * keep).to(vals.dtype)
    return torch.einsum("nkd,nk->nd", vals, w)


def kept_counts(bucket_ids: torch.Tensor, keep: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Per-bucket *kept* copy counts (capacity drops excluded), int32 —
    the ``group_sizes`` of the ragged GMM."""
    b = torch.where(keep, bucket_ids.long(), torch.full_like(bucket_ids.long(), n_buckets))
    return bucket_counts(b, n_buckets).to(torch.int32)


def choose_slots(
    expert_ids: torch.Tensor,   # (n, k) logical expert per copy
    slot_of: torch.Tensor,      # (E, R_max) physical slot table
    n_replicas: torch.Tensor,   # (E,) live replica count per expert
    sentinel: int | None = None,
) -> torch.Tensor:
    """Physical slot per copy, round-robin over live replicas (the same
    ``% 997`` spread as the reference). Ids ``>= E`` (masked tokens) map to
    ``sentinel`` so the dispatch drops them."""
    n, k = expert_ids.shape
    e = slot_of.shape[0]
    ids = expert_ids.long()
    safe = ids.clamp(max=e - 1)
    copy_idx = (torch.arange(n * k, device=ids.device) % 997).reshape(n, k)
    r = copy_idx % n_replicas[safe].long()
    slots = slot_of[safe, r]
    if sentinel is not None:
        slots = torch.where(ids < e, slots, torch.full_like(slots, sentinel))
    return slots


def uniform_placement(n_experts: int, n_slots: int, r_max: int = 4, device="cpu"):
    """``(slot_of, n_replicas)`` with expert e -> slot e, one replica."""
    return PlacementTable.uniform(n_experts, n_slots, r_max=r_max).device_view(device)


def tiled_placement(n_experts: int, n_rows: int, n_slots: int, r_max: int = 4,
                    device="cpu"):
    """Placement consistent with tiled slot weights (slot s holds weight
    row s % n_rows)."""
    table = PlacementTable.tiled(n_experts, n_rows, n_slots, r_max=r_max)
    return table.device_view(device)


def validate_ep_chunks(ep_chunks, n_groups: int | None = None, where: str = "") -> int:
    """``ep_chunks`` must be a positive int dividing ``n_groups`` (when
    known), so every chunk carries the same number of expert groups.
    Returns the validated count."""
    at = f" ({where})" if where else ""
    if not isinstance(ep_chunks, int) or isinstance(ep_chunks, bool) or ep_chunks < 1:
        raise ValueError(
            f"ep_chunks={ep_chunks!r}{at} must be a positive int "
            f"(1 = single-shot dispatch, K > 1 splits the expert groups into "
            f"K chunks)"
        )
    if n_groups is not None and n_groups % ep_chunks:
        raise ValueError(
            f"ep_chunks={ep_chunks}{at} does not divide the expert-group "
            f"count {n_groups} — every chunk must carry the same number of "
            f"expert groups; pick a divisor of {n_groups} (or 1)"
        )
    return ep_chunks


def ep_moe_local(
    x: torch.Tensor,            # (B, S, d)
    expert_ids: torch.Tensor,   # (B, S, k) — may carry the E sentinel (masked)
    weights: torch.Tensor,      # (B, S, k)
    slot_weights: dict,         # expert slot params, leading dim = total slots
    slot_of: torch.Tensor,      # (E, R_max)
    n_replicas: torch.Tensor,   # (E,)
    ctx: ParallelCtx,
    capacity_factor: float,
    total_slots: int,
) -> torch.Tensor:
    """Single-process EP dispatch: slot-table routing, fixed-capacity
    bucketing and the ragged grouped FFN, with the all_to_all as the
    identity (every slot is local). This is what lets the NI-Balancer run
    for real on one process (``ServeConfig.virtual_ep``). With
    ``ctx.ep_chunks = K`` the grouped FFN runs as K calls over slot ranges;
    per-bucket results do not depend on the batching, so the output is
    bit-identical to one call."""
    b, s, d = x.shape
    k = expert_ids.shape[-1]
    n = b * s
    xt = x.reshape(n, d)
    eid = expert_ids.reshape(n, k)
    w = weights.reshape(n, k)
    cap = bucket_capacity(n, k, capacity_factor, total_slots)
    slots = choose_slots(eid, slot_of, n_replicas, sentinel=total_slots + 1)
    bufs, pos, keep = bucket_dispatch(xt, slots, total_slots, cap)
    counts = kept_counts(slots, keep, total_slots)
    kc = validate_ep_chunks(ctx.ep_chunks, where="ep_moe_local")
    if kc > 1:
        validate_ep_chunks(kc, total_slots, where="ep_moe_local total_slots")
    spt = total_slots // kc
    ffn = registry.expert_ffn if ctx.kernels_on(x) else expert_ffn_ragged
    ys = [
        ffn(
            bufs[c * spt : (c + 1) * spt],
            slot_weights["w_gate"][c * spt : (c + 1) * spt],
            slot_weights["w_up"][c * spt : (c + 1) * spt],
            slot_weights["w_down"][c * spt : (c + 1) * spt],
            counts[c * spt : (c + 1) * spt],
        )
        for c in range(kc)
    ]
    y = ys[0] if kc == 1 else torch.cat(ys, dim=0)
    out = bucket_combine(y, slots, pos, keep, w)
    return out.reshape(b, s, d)
