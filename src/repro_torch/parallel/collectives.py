"""Expert-parallel bucket dispatch/combine, ESP's sharded expert FFN and
the sequence-parallel decode merge (port of ``repro.parallel.collectives``).

One process: ``ep_moe_local`` (every slot local, the all-to-all is the
identity). Under a mesh of ``torch.distributed`` ranks:
``ep_moe_shardmap`` (dispatch -> ``all_to_all_single`` -> per-rank
grouped FFN -> ``all_to_all_single`` -> combine, over the model group),
``esp_expert_ffn`` (the grouped FFN on the rank's hidden-dim shard of
every expert, the partial down products reduce-scattered onto d over the
model group) and ``seq_parallel_decode_attend`` (per-rank partials over
the rank's slice of the dense cache, LSE-merged with all-reduces). Where
the reference runs a ``shard_map`` body, the port's functions take and
return the rank's own block; collectives are blocking and issued in the
same order on every rank, which enters each of them whether or not it has
rows to send (a rank with no work enters with zero counts).

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
import torch.distributed as dist

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


# ---------------------------------------------------------------------------
# EP all-to-all over the model group
# ---------------------------------------------------------------------------

def validate_ep_token_split(b: int, s: int, n_batch: int, ep: int, decode: bool) -> None:
    """Up-front shape validation for ``ep_moe_shardmap``: the batch splits
    over the batch axis and (prefill) the sequence over the EP axis; a
    non-dividing shape would floor-truncate the per-rank token count and
    under-size ``bucket_capacity``. Fail loudly, naming the shapes."""
    if n_batch and b % n_batch:
        raise ValueError(
            f"ep_moe_shardmap: batch={b} does not divide the {n_batch}-way "
            f"batch axis (seq={s}, ep={ep}, decode={decode}) — pad the "
            f"batch or reshape the mesh"
        )
    if not decode and s % ep:
        raise ValueError(
            f"ep_moe_shardmap prefill splits the sequence over the EP "
            f"axis: seq={s} does not divide ep={ep} (batch={b}, "
            f"n_batch={n_batch}); b*s//(n_batch*ep) would floor-truncate "
            f"the per-device token count and under-size bucket_capacity — "
            f"pad the sequence to a multiple of {ep}"
        )


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)`` over
    ``group``: block i of dim 0 goes to rank i, block j of the result
    came from rank j (equal, contiguous splits)."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def dispatch_fused(xt, slots, total_slots: int, cap: int, ep: int, kc: int):
    """Per-chunk rank-compacted send buffers and the dispatch metadata of
    the fused branch (the reference's ``dispatch_fused`` closure).

    Returns ``(sends, kept_ck, keep, chunk_of, dest, posr)``: ``sends[c]``
    is ``(ep, spc*cap, d)`` with each destination rank's kept copies of
    chunk c packed bucket after bucket; ``kept_ck`` ``(ep, kc, spc)`` the
    kept count per bucket; per copy its keep mask, owning chunk,
    destination rank (``>= ep`` for the sentinel) and row inside that
    rank's chunk block (``spc*cap`` when dropped). Rows a copy does not
    own are never written: the scatter goes through one sacrificial row
    past the end, which is cut off."""
    n, k = slots.shape
    d = xt.shape[-1]
    spd = total_slots // ep
    spc = spd // kc
    _, _, kept, pos, keep = dispatch_metadata(slots, total_slots, cap)
    kept_ck = kept.reshape(ep, kc, spc)
    wro = torch.cumsum(kept_ck, dim=2, dtype=torch.int32) - kept_ck
    flat_b = slots.reshape(-1).long()
    safe_b = flat_b.clamp(max=total_slots - 1)
    dest = flat_b // spd
    chunk_of = (safe_b % spd) // spc
    flat_keep = keep.reshape(-1)
    posr = wro.reshape(-1)[safe_b].long() + pos.reshape(-1).long()
    posr = torch.where(flat_keep, posr, torch.full_like(posr, spc * cap))
    src = xt[torch.arange(n, device=xt.device).repeat_interleave(k)]
    block = spc * cap
    sends = []
    for c in range(kc):
        ok = flat_keep & (chunk_of == c)
        row = torch.where(ok, dest.clamp(max=ep - 1) * block + posr.clamp(max=block - 1),
                          torch.full_like(posr, ep * block))
        send = xt.new_zeros((ep * block + 1, d))
        send[row] = src
        sends.append(send[:-1].reshape(ep, block, d))
    return sends, kept_ck, keep, chunk_of, dest, posr


def ep_moe_shardmap(
    x: torch.Tensor,            # (B_loc, S, d) this rank's batch rows
    expert_ids: torch.Tensor,   # (B_loc, S, k) — may carry the E sentinel
    weights: torch.Tensor,      # (B_loc, S, k)
    slot_weights: dict,         # this rank's slot rows, leading dim = spd
    slot_of: torch.Tensor,      # (E, R_max) replicated routing view
    n_replicas: torch.Tensor,   # (E,)
    ctx: ParallelCtx,
    capacity_factor: float,
    slots_per_device: int,
    decode: bool = False,
) -> torch.Tensor:
    """Expert-parallel MoE over the model group: dispatch -> all_to_all ->
    grouped FFN -> all_to_all -> combine. Returns ``(B_loc, S, d)``,
    the same on every rank of the model group.

    Prefill (``decode=False``) splits the sequence over the EP axis: rank
    r dispatches positions ``[r*S/ep, (r+1)*S/ep)`` and an all-gather over
    the model group puts the sequence back together (the reference's
    ``out_specs`` leave that to GSPMD). Decode keeps the tokens replicated:
    rank r owns the tokens with ``idx % ep == r``, the others overflow out
    of every bucket, and an all-reduce of the owners' results restores
    the replication.

    Unless the plain math is asked for (``use_kernels=False``), the fused
    branch runs: rank-compacted rows ship over the all-to-all with their
    bucket fills, every rank's grouped FFN reads them in place and stores
    back at the same rows (``registry.expert_ffn_from_rows(compact_out,
    fused)``; on CPU tensors its plain versions), the result ships back
    and the combine gathers each kept copy at ``chunk_of``/``dest``/
    ``posr``. ``ctx.ep_chunks = K`` splits each rank's expert groups into
    K chunks, chunk c+1's dispatch issued before chunk c's FFN; one final
    combine keeps the output bit-identical to K = 1. ``use_kernels=False``
    takes the padded branch: ``(slots, cap, d)`` buckets, the plain grouped
    FFN, ``bucket_combine``."""
    mesh = ctx.mesh
    group = mesh.model_group
    ep = mesh.model
    rank = mesh.model_rank
    spd = slots_per_device
    total_slots = ep * spd

    b, s, d = x.shape
    k = expert_ids.shape[-1]
    validate_ep_token_split(b * mesh.data, s, mesh.data, ep, decode)
    if not decode:
        sl = s // ep
        part = slice(rank * sl, (rank + 1) * sl)
        x, expert_ids, weights = x[:, part], expert_ids[:, part], weights[:, part]
    bl, sl, _ = x.shape
    n = bl * sl
    cap = bucket_capacity(n, k, capacity_factor, total_slots)
    fused = ctx.use_kernels is not False
    kc = validate_ep_chunks(ctx.ep_chunks, where="ep_moe_shardmap")
    if kc > 1:
        validate_ep_chunks(kc, spd, where="ep_moe_shardmap slots_per_device")
    if not fused:
        kc = 1
    spc = spd // kc
    wg, wu, wd = slot_weights["w_gate"], slot_weights["w_up"], slot_weights["w_down"]

    xt = x.reshape(n, d)
    eid = expert_ids.reshape(n, k)
    w = weights.reshape(n, k)
    slots = choose_slots(eid, slot_of, n_replicas, sentinel=total_slots + 1)
    if decode:
        owned = (torch.arange(n, device=x.device) % ep) == rank
        slots = torch.where(owned[:, None], slots, torch.full_like(slots, total_slots + 1))

    if fused:
        sends, kept_ck, keep, chunk_of, dest, posr = dispatch_fused(
            xt, slots, total_slots, cap, ep, kc)

        def exchange(c):
            return (all_to_all(sends[c], group),
                    all_to_all(kept_ck[:, c].contiguous(), group))

        def chunk_ffn(recv, cnt, c):
            # recv[r'] = my chunk's spc buckets' rows from source rank r',
            # bucket-compacted; cnt[r', s] that segment's fill. Group
            # gi = s*ep + r' (weight row gi // ep) starts at flat row
            # r'*spc*cap + roff.
            roff = torch.cumsum(cnt, dim=1, dtype=torch.int32) - cnt
            base = torch.arange(ep, dtype=torch.int32, device=x.device)[:, None] * (spc * cap)
            offsets_g = (roff + base).transpose(0, 1).reshape(-1)
            counts_g = cnt.transpose(0, 1).reshape(-1)
            ws = slice(c * spc, (c + 1) * spc)
            y = registry.expert_ffn_from_rows(
                recv.reshape(ep * spc * cap, d), wg[ws], wu[ws], wd[ws],
                offsets_g, counts_g, capacity=cap, groups_per_weight=ep,
                compact_out=True, fused=True,
            )
            return all_to_all(y.reshape(ep, spc * cap, d), group)

        recv = [None] * kc
        recv[0] = exchange(0)
        backs = []
        for c in range(kc):
            if c + 1 < kc:
                recv[c + 1] = exchange(c + 1)
            backs.append(chunk_ffn(*recv[c], c))
            recv[c] = None
        back = torch.cat(backs, dim=0)
        rows = chunk_of * (ep * spc * cap) + dest * (spc * cap) + posr
        out = combine_from_rows(back.reshape(kc * ep * spc * cap, d),
                                rows.reshape(n, k), keep.reshape(n, k), w)
    else:
        bufs, pos, keep = bucket_dispatch(xt, slots, total_slots, cap)
        counts = kept_counts(slots, keep, total_slots)
        recv = all_to_all(bufs.reshape(ep, spd, cap, d), group)
        cnt = all_to_all(counts.reshape(ep, spd), group)
        recv = recv.transpose(0, 1)                      # (spd, ep, cap, d)
        y = expert_ffn_ragged(recv.reshape(spd * ep, cap, d), wg, wu, wd,
                              cnt.transpose(0, 1).reshape(-1), ep)
        y = y.reshape(spd, ep, cap, d).transpose(0, 1)
        back = all_to_all(y, group).reshape(total_slots, cap, d)
        out = bucket_combine(back, slots, pos, keep, w)
    out = out.reshape(bl, sl, d)
    if decode:
        dist.all_reduce(out, group=group)               # the owners' results
        return out
    parts = [torch.empty_like(out) for _ in range(ep)]
    dist.all_gather(parts, out.contiguous(), group=group)
    return torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# gathers and ESP's reduce-scatter over the model group
# ---------------------------------------------------------------------------

def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's block of ``group`` concatenated along ``dim`` in rank
    order (a tiled ``all_gather``)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``psum_scatter(t, scatter_dimension=dim, tiled=True)`` over
    ``group``: the sum of every rank's ``t``, of which rank r keeps block r
    of ``dim``. The reduced dim is moved first for the collective's flat
    split and back after."""
    n = dist.get_world_size(group)
    size = t.shape[dim] // n
    blocks = t.unflatten(dim, (n, size)).movedim(dim, 0).contiguous()
    out = blocks.new_empty(blocks.shape[1:])
    dist.reduce_scatter_tensor(out.view(-1), blocks.view(-1), group=group)
    return out


def esp_expert_ffn(
    bufs: torch.Tensor,     # (G, E, cap, d) — this rank's bucket groups
    counts: torch.Tensor,   # (G, E) kept-token count per bucket
    wg: torch.Tensor,       # (E, d, f_loc) — the rank's hidden-dim shard
    wu: torch.Tensor,       # (E, d, f_loc)
    wd: torch.Tensor,       # (E, f_loc, d)
    ctx: ParallelCtx,
) -> torch.Tensor:
    """Count-aware expert FFN of the ESP path (the reference's
    ``esp_expert_ffn``): the rank's bucket groups flattened expert-major,
    so that weight row = group // G, through ``registry.expert_ffn`` (the
    ``gmm_dual_act_ragged`` + ``gmm_ragged`` pair; on CPU tensors their
    plain versions) on the rank's shard of every expert's hidden dim. With
    no mesh the shard is the whole hidden dim and the result ``(G, E, cap,
    d)`` is final. Under a mesh each rank holds the partial down products
    of its shard, and a reduce-scatter over the model group sums them onto
    d: the result is ``(G, E, cap, d / n_model)``, d split over the model
    group. The caller gates on the dims dividing (``moe.moe_esp``)."""
    g, e, cap, d = bufs.shape
    xg = bufs.transpose(0, 1).reshape(e * g, cap, d)
    y = registry.expert_ffn(xg, wg, wu, wd, counts.transpose(0, 1).reshape(-1), g)
    y = y.reshape(e, g, cap, -1).transpose(0, 1)
    if ctx.mesh is None:
        return y
    return reduce_scatter_dim(y, 3, ctx.mesh.model_group)


# ---------------------------------------------------------------------------
# sequence-parallel flash-decode merge
# ---------------------------------------------------------------------------

def seq_parallel_decode_kernel_eligible(ctx: ParallelCtx) -> bool:
    """Do the per-rank partials come from ``flash_decode``'s partials
    mode? Unless the plain math is asked for (``use_kernels=False``): on
    CUDA tensors the kernel (its wrapper raises outside its gate, no
    fallback), on CPU tensors its plain version."""
    return ctx.use_kernels is not False


def merge_partials(num, m, den, group, dtype: torch.dtype) -> torch.Tensor:
    """LSE merge of every rank's decode partials across ``group`` (the
    reference's ``merge_partials``): ``num`` ``(..., hd)`` the unnormalised
    weighted values, ``m`` and ``den`` ``(...)`` the row max and the sum of
    weights. The global max ``m*`` (all-reduce MAX) sets each rank's weight
    ``e^(m - m*)``; the weighted ``num`` and ``den`` are summed (all-reduce
    SUM) and ``num / max(den, 1e-30)`` is cast once to ``dtype``. The sums
    run in ``num``'s dtype: fp32 for the kernel's partials, ``v``'s dtype
    in the einsum body, as in the reference. A rank whose slice has no
    valid key (``m = -1e30``) weighs nothing."""
    m_max = m.clone()
    dist.all_reduce(m_max, op=dist.ReduceOp.MAX, group=group)
    scale = torch.exp(m - m_max)[..., None]
    num = num * scale.to(num.dtype)
    den = den[..., None] * scale
    dist.all_reduce(num, group=group)
    dist.all_reduce(den, group=group)
    return (num / den.clamp(min=1e-30).to(num.dtype)).to(dtype)


def seq_parallel_decode_attend(
    q: torch.Tensor,        # (B_loc, 1, H, hd) — replicated over the model group
    k_cache: torch.Tensor,  # (B_loc, L_loc, K, hd) — this rank's cache slots
    v_cache: torch.Tensor,
    mask: torch.Tensor,     # (L_loc,) validity of this rank's slots
    ctx: ParallelCtx,
) -> torch.Tensor:
    """Flash decode across the model group: each rank attends over its
    slice of the cache and the partials LSE-merge (:func:`merge_partials`).
    The kernel body takes the partials from
    ``registry.decode_attend_partials`` (fp32, not normalised); the einsum
    body is the reference's, with its ``m_safe`` guard for a rank whose
    slice has no valid key."""
    group = ctx.mesh.model_group
    b = q.shape[0]
    if seq_parallel_decode_kernel_eligible(ctx):
        valid = mask[None, :].expand(b, mask.shape[0])
        acc, m, l = registry.decode_attend_partials(q[:, 0].contiguous(), k_cache,
                                                    v_cache, valid)
        return merge_partials(acc, m, l, group, q.dtype)[:, None]

    _, _, nh, hd = q.shape
    nk = k_cache.shape[2]
    g = nh // nk
    qg = q.reshape(b, 1, nk, g, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k_cache).float() / math.sqrt(hd)
    s = torch.where(mask[None, None, None, None, :], s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)                          # (b, k, g, 1)
    m_safe = torch.clamp(m, min=-1e29)[..., None]   # a slice with no valid key
    e = torch.exp(s - m_safe)
    num = torch.einsum("bkgst,btkd->bskgd", e.to(v_cache.dtype), v_cache)
    den = e.sum(dim=-1).permute(0, 3, 1, 2)     # (b, 1, k, g)
    out = merge_partials(num, m.permute(0, 3, 1, 2), den, group, q.dtype)
    return out.reshape(b, 1, nh, hd)
