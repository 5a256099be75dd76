"""MoE layer: router, dense oracle, ESP and expert parallelism.

* ``dense`` — every expert computed for every token, masked combine (the
  oracle, and the no-mesh default).
* ``esp``   — expert-sharded FFN: tokens bucketed per expert locally (no
  all-to-all); on one device it serves the experts' own weights through
  the flat-row expert FFN (``registry.expert_ffn_from_rows``), the call
  every rank of the multi-device EP path makes. Under a mesh each rank
  holds every expert's hidden-dim shard (``sharding.expert_hidden``): its
  bucket group runs the ragged pair on the shard and the partial down
  products reduce-scatter onto d (``collectives.esp_expert_ffn``); the
  combine runs on the d-shard and an all-gather restores d.
* ``ep``    — fixed-capacity per-slot buckets over the placement table's
  routing view: the path the NI-Balancer serves on, with shadow replicas
  in extra slot rows. One process: ``collectives.ep_moe_local``; under a
  mesh: ``collectives.ep_moe_shardmap``, the all-to-all over the model
  group, each rank holding its own slot rows.

Under a mesh ``"auto"`` picks EP when the experts divide the model axis
and ESP otherwise, as the reference does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import registry
from repro_torch.models.layers import normal_init
from repro_torch.parallel import sharding
from repro_torch.parallel.collectives import (
    all_gather_dim,
    bucket_capacity,
    bucket_combine,
    bucket_counts,
    bucket_dispatch,
    combine_from_rows,
    dispatch_metadata,
    ep_moe_local,
    ep_moe_shardmap,
    esp_expert_ffn,
    kept_counts,
    tiled_placement,
    uniform_placement,
    validate_ep_chunks,
)
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.placement import PlacementTable


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device="cpu") -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff_
    return {
        "router": normal_init(gen, (d, e), dtype=torch.float32, device=device),
        "w_gate": normal_init(gen, (e, d, f), dtype=dtype, device=device),
        "w_up": normal_init(gen, (e, d, f), dtype=dtype, device=device),
        "w_down": normal_init(gen, (e, f, d), dtype=dtype, device=device),
    }


def route(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Top-k routing in fp32. Returns (expert_ids, weights, aux_loss).

    ``torch.topk`` and ``lax.top_k`` may order exactly tied probabilities
    differently; the parity tests use continuous random inputs, where ties
    do not occur."""
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    e = cfg.n_experts
    one_hot = F.one_hot(ids, e).float()                      # (..., k, E)
    frac = one_hot.sum(dim=-2).reshape(-1, e).mean(dim=0)
    mean_prob = probs.reshape(-1, e).mean(dim=0)
    aux = e * (frac * mean_prob).sum()
    return ids, weights.to(x.dtype), aux


def zero_aux(cfg: ModelConfig, device="cpu") -> dict:
    return {
        "loss": torch.zeros((), dtype=torch.float32, device=device),
        "counts": torch.zeros(max(cfg.n_experts, 1), dtype=torch.float32,
                              device=device),
    }


def _aux(loss, ids, cfg: ModelConfig) -> dict:
    # drops the masked-token sentinel id E, as jnp.bincount(length=E) does
    counts = bucket_counts(ids, max(cfg.n_experts, 1)).float()
    return {"loss": loss, "counts": counts}


def _mask_ids(ids, token_mask, cfg: ModelConfig):
    """Route masked tokens (empty serving slots) to the out-of-range expert
    id E: every dispatch drops it, so dead rows spend no bucket capacity,
    produce zero output and stay out of the balancer's counts."""
    if token_mask is None:
        return ids
    return torch.where(token_mask[..., None], ids, torch.full_like(ids, cfg.n_experts))


def moe_dense(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx: ParallelCtx,
              token_mask=None):
    ids, w, aux = route(p, x, cfg)
    ids = _mask_ids(ids, token_mask, cfg)
    h = torch.einsum("...d,edf->...ef", x, p["w_gate"])
    u = torch.einsum("...d,edf->...ef", x, p["w_up"])
    y = torch.einsum("...ef,efd->...ed", F.silu(h) * u, p["w_down"])
    # one_hot of the sentinel id E is all-zero, as jax.nn.one_hot gives.
    experts = torch.arange(cfg.n_experts, device=x.device)
    mask = (ids[..., None] == experts).to(w.dtype)           # (..., k, E)
    comb = torch.einsum("...ke,...k->...e", mask, w)
    out = torch.einsum("...ed,...e->...d", y, comb)
    return out, _aux(aux, ids, cfg)


def moe_esp(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx: ParallelCtx,
            token_mask=None):
    """ESP on one device: tokens are bucketed per expert (capacity
    ``bucket_capacity(b*s, k, cf, E)``), each bucket runs its expert's
    SwiGLU FFN, and the kept copies are combined with their router weights.

    Unless the plain math is asked for (``use_kernels=False``), the buckets
    are never written: ``dispatch_metadata`` orders the token copies by
    expert, the FFN reads each bucket's rows in place and stores its output
    back at the same rows (``compact_out``, and ``fused`` where
    ``can_gmm_fused`` admits the shapes), and the combine gathers each kept
    copy's row. On CPU tensors the same branch runs the kernels' plain
    versions. ``ctx.ep_chunks = K`` splits the experts into K calls over
    absolute offsets into the one flat array, merged per row by its owning
    chunk (a select, no arithmetic), so the output is bit-identical to one
    call. ``use_kernels=False`` takes the padded path: ``(E, cap, d)``
    buckets, einsums, ``bucket_combine``. Under a mesh:
    :func:`_moe_esp_mesh`."""
    ids, w, aux = route(p, x, cfg)
    ids = _mask_ids(ids, token_mask, cfg)
    if ctx.mesh is not None:
        return _moe_esp_mesh(p, x, ids, w, cfg, ctx), _aux(aux, ids, cfg)
    b, s, d = x.shape
    k = cfg.experts_per_token
    e = cfg.n_experts
    n = b * s
    kc = validate_ep_chunks(ctx.ep_chunks, where="moe_esp")
    if kc > 1:
        validate_ep_chunks(kc, e, where="moe_esp n_experts")
    cap = bucket_capacity(n, k, ctx.capacity_factor, e)
    ids2, w2 = ids.reshape(n, k), w.reshape(n, k)

    if ctx.use_kernels is not False:
        row_ids, offsets, counts, slots, keep = dispatch_metadata(ids2, e, cap)
        rows = x.reshape(n, d)[row_ids.long()]
        epc = e // kc

        def chunk_ffn(c):
            ws = slice(c * epc, (c + 1) * epc)
            return registry.expert_ffn_from_rows(
                rows, p["w_gate"][ws], p["w_up"][ws], p["w_down"][ws],
                offsets[ws], counts[ws], capacity=cap, compact_out=True,
                fused=True,
            )

        y = chunk_ffn(0)
        if kc > 1:
            # owning bucket of each flat row (offsets are the buckets' first
            # rows); rows past the live span map to the last chunk and are
            # never addressed by the combine
            r_idx = torch.arange(rows.shape[0], dtype=torch.int32, device=x.device)
            owner = torch.searchsorted(offsets, r_idx, right=True) - 1
            owner_c = owner.clamp(0, e - 1) // epc
            for c in range(1, kc):
                y = torch.where((owner_c == c)[:, None], chunk_ffn(c), y)
        # the masked-token sentinel E reads the last bucket's offset (JAX
        # clamps the gather); its copy is never kept
        flat_rows = offsets[ids2.long().clamp(max=e - 1)] + slots
        out = combine_from_rows(y, flat_rows, keep, w2)
        return out.reshape(b, s, d), _aux(aux, ids, cfg)

    bufs, slots, keep = bucket_dispatch(x.reshape(n, d), ids2, e, cap)   # (E, cap, d)
    h = torch.einsum("ecd,edf->ecf", bufs, p["w_gate"])
    u = torch.einsum("ecd,edf->ecf", bufs, p["w_up"])
    y = torch.einsum("ecf,efd->ecd", F.silu(h) * u, p["w_down"])
    out = bucket_combine(y, ids2, slots, keep, w2)
    return out.reshape(b, s, d), _aux(aux, ids, cfg)


def _moe_esp_mesh(p: dict, x: torch.Tensor, ids, w, cfg: ModelConfig,
                  ctx: ParallelCtx) -> torch.Tensor:
    """ESP under a mesh (the reference's group path of ``moe_esp``). The
    rank's tokens are one bucket group (the reference's ``groups =
    n_batch`` groups, one a data rank, when the batch divides; one
    replicated group otherwise), bucketed per expert at ``bucket_capacity``
    of the group's tokens. ``p``'s expert weights are the rank's
    hidden-dim shard of every expert (``sharding.expert_hidden``: the whole
    hidden dim when it does not divide the model axis).

    Unless the plain math is asked for, and when d and the hidden dim
    divide the model axis and the groups the data axis (the reference's
    ``kernel_ok``), the buckets go through :func:`esp_expert_ffn` (the
    ragged pair on the shard, reduce-scattered onto d), are combined on the
    rank's d-shard, and the d-shards are all-gathered over the model group.
    Otherwise the reference's einsum branch: the shard's products, their
    partial down products all-reduced over the model group when the hidden
    dim is split, then the combine."""
    b, s, d = x.shape
    k = cfg.experts_per_token
    e = cfg.n_experts
    f = cfg.moe_d_ff_
    m = ctx.n_model
    fs = sharding.expert_hidden(f, m, ctx.model_rank)
    if p["w_gate"].shape[-1] != fs.stop - fs.start:
        raise ValueError(
            f"moe_esp under a mesh takes the rank's hidden-dim shard of the "
            f"expert weights ({fs.stop - fs.start} of {f} columns), got "
            f"{p['w_gate'].shape[-1]} (the Server slices them)"
        )
    n = b * s
    cap = bucket_capacity(n, k, ctx.capacity_factor, e)
    ids2, w2 = ids.reshape(n, k), w.reshape(n, k)
    bufs, slots, keep = bucket_dispatch(x.reshape(n, d), ids2, e, cap)   # (E, cap, d)
    group = ctx.mesh.model_group
    kernel_ok = (ctx.use_kernels is not False and d % m == 0 and f % m == 0
                 and ctx.batch_split)
    if kernel_ok:
        counts = kept_counts(ids2, keep, e)
        y = esp_expert_ffn(bufs[None], counts[None], p["w_gate"], p["w_up"],
                           p["w_down"], ctx)[0]                        # (E, cap, d/M)
        out = bucket_combine(y, ids2, slots, keep, w2)
        return all_gather_dim(out, 1, group).reshape(b, s, d)
    h = torch.einsum("ecd,edf->ecf", bufs, p["w_gate"])
    u = torch.einsum("ecd,edf->ecf", bufs, p["w_up"])
    y = torch.einsum("ecf,efd->ecd", F.silu(h) * u, p["w_down"])
    if sharding.is_split(f, m):
        dist.all_reduce(y, group=group)
    return bucket_combine(y, ids2, slots, keep, w2).reshape(b, s, d)


def moe_ep(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    ctx: ParallelCtx,
    placement: PlacementTable | tuple | None = None,
    slot_weights: dict | None = None,
    slots_per_device: int | None = None,
    token_mask=None,
):
    """Expert-parallel dispatch over physical slots.

    ``placement`` is a :class:`PlacementTable` (its committed routing view
    routes) or a bare ``(slot_of, n_replicas)`` pair; default = native
    homes. The Server owns slot-expanded weights (``n_slots`` rows) and
    updates replica rows out of band. Under a mesh the expert rows of
    ``p`` (or ``slot_weights``) are the rank's own slot rows, ``n_model``
    of them making the ``n_slots``."""
    e = cfg.n_experts
    ep = ctx.n_model
    n_rows = p["w_gate"].shape[0] * ep
    tiled = False
    if slot_weights is None:
        n_slots = slots_per_device * ep if slots_per_device else n_rows
        if n_slots < n_rows:
            raise ValueError(
                f"slots_per_device={slots_per_device} gives {n_slots} physical "
                f"slots < {n_rows} weight rows — experts would be dropped"
            )
        if n_slots == n_rows:
            slot_weights = p
        elif ctx.mesh is not None:
            raise ValueError(
                "under a mesh moe_ep takes each rank's slot rows as they are "
                "(the Server expands them); it does not tile"
            )
        else:
            reps = -(-n_slots // n_rows)
            slot_weights = {
                k2: p[k2].repeat(reps, 1, 1)[:n_slots]
                for k2 in ("w_gate", "w_up", "w_down")
            }
            tiled = True
    else:
        n_slots = slot_weights["w_gate"].shape[0] * ep
    if isinstance(placement, PlacementTable):
        placement = placement.device_view(x.device)
    if placement is None:
        if tiled:
            slot_of, n_replicas = tiled_placement(e, n_rows, n_slots, device=x.device)
        else:
            slot_of, n_replicas = uniform_placement(e, n_slots, device=x.device)
    else:
        slot_of, n_replicas = placement

    ids, w, aux = route(p, x, cfg)
    ids = _mask_ids(ids, token_mask, cfg)
    if ctx.mesh is None:
        out = ep_moe_local(
            x, ids, w, slot_weights, slot_of, n_replicas, ctx,
            ctx.capacity_factor, n_slots,
        )
    else:
        out = ep_moe_shardmap(
            x, ids, w, slot_weights, slot_of, n_replicas, ctx,
            ctx.capacity_factor, n_slots // ep, decode=x.shape[1] == 1,
        )
    return out, _aux(aux, ids, cfg)


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx: ParallelCtx,
              placement=None, token_mask=None):
    """``token_mask`` (bool, broadcastable to ``x.shape[:-1]``): False rows
    are dead serving slots — they route nowhere."""
    impl = ctx.moe_impl
    if impl == "auto":
        if ctx.mesh is None:
            impl = "dense"
        elif cfg.n_experts % ctx.n_model == 0:
            impl = "ep"          # E/D >= 1: expert parallelism
        else:
            impl = "esp"         # E/D < 1: the reference's choice is ESP
    if impl == "dense":
        return moe_dense(p, x, cfg, ctx, token_mask=token_mask)
    if impl == "esp":
        return moe_esp(p, x, cfg, ctx, token_mask=token_mask)
    if impl == "ep":
        return moe_ep(p, x, cfg, ctx, placement, token_mask=token_mask)
    raise ValueError(f"unknown moe impl {impl!r}")
