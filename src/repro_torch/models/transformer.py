"""Model assembly for the ``attn`` block pattern (decoder-only, dense or MoE
FFN): init / prefill / one-token decode over a dense or a paged KV cache.

PyTorch port of ``repro.models.transformer`` for the serving slice. Layers
are stacked as ``(L, ...)`` tensors (so ``w[l]`` is a contiguous view) and
driven by a Python loop where the reference scans. Under a mesh every rank
runs these on its own requests (the batch split over the data axis), with
its shard of the dense cache or of the paged pool (``parallel.sharding``);
the EP prefill splits the sequence over the model axis inside
``ep_moe_shardmap`` and gathers it back there. The prefill lane's chunk is
the same on every rank (the reference's ``chunk_specs`` replicate it). The
other block patterns (zamba, xlstm, encdec) and the training forward come
with later slices.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    PAGE_SIZE,
    attention,
    attn_init,
    cache_init,
    cache_len,
    chunk_prefill_attention,
    decode_attention,
    dense_prefill_fill,
    dense_shard,
    is_paged,
    paged_cache_init,
    paged_prefill_fill,
    pool_heads,
)
from repro_torch.models.layers import mlp_apply, mlp_init, normal_init, rms_norm
from repro_torch.models.moe import moe_apply, moe_init, zero_aux
from repro_torch.parallel.ctx import NO_MESH, ParallelCtx


def _check_pattern(cfg: ModelConfig) -> None:
    if cfg.block_pattern != "attn":
        raise NotImplementedError(
            f"block_pattern={cfg.block_pattern!r} is not ported yet "
            f"(ROADMAP: the other model families)"
        )


def _attn_block_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    p = {
        "ln1": torch.ones(cfg.d_model, dtype=dtype, device=device),
        "ln2": torch.ones(cfg.d_model, dtype=dtype, device=device),
        "attn": attn_init(gen, cfg, dtype, device),
    }
    if cfg.is_moe:
        p["moe"] = moe_init(gen, cfg, dtype, device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def _stack_into(stacked: dict | None, one: dict, l: int, n: int) -> dict:
    """Copy layer ``l``'s tree into the ``(n, ...)`` stacked tree (allocated
    on first use), so only one layer's fresh weights exist at a time."""
    if stacked is None:
        stacked = {}
    for k, v in one.items():
        if isinstance(v, dict):
            stacked[k] = _stack_into(stacked.get(k), v, l, n)
        else:
            if k not in stacked:
                stacked[k] = v.new_empty((n, *v.shape))
            stacked[k][l].copy_(v)
    return stacked


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> dict:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (the
    card unless the caller passes ``device='cpu'``). Keys and layouts are
    the JAX package's: ``x @ W`` orientation, layers stacked on dim 0,
    router in fp32. The numbers differ from JAX's for the same seed; parity
    tests bridge JAX's weights instead (:mod:`repro_torch.bridge`)."""
    _check_pattern(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    params: dict = {
        "embed": normal_init(gen, (cfg.vocab_size, d), dtype=dtype, device=dev),
        "final_norm": torch.ones(d, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (d, cfg.vocab_size), dtype=dtype, device=dev)
    layers = None
    for l in range(cfg.n_layers):
        layers = _stack_into(layers, _attn_block_init(gen, cfg, dtype, dev), l,
                             cfg.n_layers)
    params["layers"] = layers
    return params


def layer_view(tree, l: int):
    """Layer ``l`` of a stacked tree: the same dict shape, ``t[l]`` views."""
    if isinstance(tree, dict):
        return {k: layer_view(v, l) for k, v in tree.items()}
    return tree[l]


def _embed(params, tokens):
    return params["embed"][tokens.long()]


def _logits(params, x, cfg: ModelConfig):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.float32,
               paged: bool = False, page_size: int = PAGE_SIZE,
               n_pages: int | None = None, device="cpu",
               ctx: ParallelCtx = NO_MESH) -> dict:
    """Decode cache sized for ``max_seq`` context, one stacked leaf per
    layer: dense ``(L, B, slots, heads, hd)`` k/v, or with ``paged`` a
    shared page pool + block tables; under a mesh ``batch`` is the rank's
    requests and the cache its shard (``attention.dense_shard``,
    ``attention.pool_heads``). ``pos`` is kept on the host (a Python int),
    and so is ``len``, the dense cache's whole slot count."""
    _check_pattern(cfg)
    if paged:
        one = paged_cache_init(cfg, batch, max_seq, dtype, page_size, n_pages, device,
                               ctx)
    else:
        one = cache_init(cfg, batch, max_seq, dtype, device, ctx)
    layers = {
        k: v[None].expand(cfg.n_layers, *v.shape).clone() for k, v in one.items()
    }
    return {"pos": 0, "len": cache_len(cfg, max_seq), "layers": layers}


def _layer_cache(cache_layers: dict, l: int) -> dict:
    return {k: v[l] for k, v in cache_layers.items()}


def _block_ffn(p_l, z2, cfg, ctx, placement, token_mask):
    if cfg.is_moe:
        return moe_apply(p_l["moe"], z2, cfg, ctx, placement=placement,
                         token_mask=token_mask)
    return mlp_apply(p_l["mlp"], z2), zero_aux(cfg, z2.device)


def decode_step(
    params,
    token: torch.Tensor,        # (B, 1) int
    cache: dict,
    cfg: ModelConfig,
    ctx: ParallelCtx = NO_MESH,
    placement=None,             # (slot_of, n_replicas) from the NI-Balancer
    slot_mask=None,             # (B,) bool — False = empty/released batch row
    chunk=None,                 # the prefill lane's operand; None = off
):
    """One serve step: consume one token per request, update the cache in
    place, emit logits ``(B, 1, V)`` and the step's per-expert counts.
    ``slot_mask`` rows still flow through the step but are masked out of
    MoE routing (their logits mean nothing).

    ``chunk`` adds the prefill lane (paged cache only): ``{"tokens": (1, C)
    int, "table": (NB,) int, "start": int, "length": int}``, one fixed-size
    chunk of an admitting request's context. In each layer the decode lane
    runs first; the chunk then flows through the same layer against the
    pool the decode lane just wrote (``chunk_prefill_attention``), and only
    its ``length`` valid rows route through the MoE, by the same
    ``placement``. Both lanes' counts add into ``expert_counts``, and
    ``stats["chunk_logits"]`` holds the logits ``(1, 1, V)`` of the last
    valid chunk position. A chunk of ``length`` 0 (the reference's no-op
    chunk, which writes only the write-off page and routes nowhere) is
    skipped: this step is eager, so no shared program needs it.

    Under a mesh the chunk is the same on every rank (``batch_replicated``
    for its MoE), and its expert counts enter ``expert_counts`` on data
    rank 0 only, so that the Server's sum over the data group counts each
    of its copies once, as the reference's global counts do."""
    _check_pattern(cfg)
    if chunk is not None and not chunk["length"]:
        chunk = None
    x = _embed(params, token)
    pos = cache["pos"]
    aux = zero_aux(cfg, x.device)
    token_mask = None if slot_mask is None else slot_mask[:, None]
    if chunk is not None:
        if not is_paged(cache["layers"]):
            raise ValueError("the prefill lane (chunk=...) needs a paged cache")
        xc = _embed(params, chunk["tokens"])                         # (1, C, d)
        n_chunk = xc.shape[1]
        cvalid = (torch.arange(n_chunk, device=x.device) < chunk["length"])[None, :]
        cctx = ctx if ctx.mesh is None else dataclasses.replace(ctx, batch_replicated=True)
        count_chunk = ctx.batch_rank == 0
    for l in range(cfg.n_layers):
        p_l = layer_view(params["layers"], l)
        c_l = _layer_cache(cache["layers"], l)
        z = rms_norm(x, p_l["ln1"], cfg.norm_eps)
        o, c_new = decode_attention(p_l["attn"], z, c_l, pos, cfg, ctx,
                                    cache.get("len"))
        if is_paged(c_new):
            cache["layers"]["lengths"][l].copy_(c_new["lengths"])
        x = x + o
        z2 = rms_norm(x, p_l["ln2"], cfg.norm_eps)
        y, a = _block_ffn(p_l, z2, cfg, ctx, placement, token_mask)
        x = x + y
        if chunk is not None:
            zc = rms_norm(xc, p_l["ln1"], cfg.norm_eps)
            oc, _ = chunk_prefill_attention(p_l["attn"], zc, c_l, chunk["table"],
                                            chunk["start"], chunk["length"], cfg, cctx)
            xc = xc + oc
            z2c = rms_norm(xc, p_l["ln2"], cfg.norm_eps)
            yc, ac = _block_ffn(p_l, z2c, cfg, cctx, placement, cvalid)
            xc = xc + yc
            if count_chunk:
                a = {k: a[k] + ac[k] for k in a}
        aux = {k: aux[k] + a[k] for k in aux}
    cache["pos"] = pos + 1
    stats = {"expert_counts": aux["counts"]}
    if chunk is not None:
        last = min(max(int(chunk["length"]) - 1, 0), n_chunk - 1)
        stats["chunk_logits"] = _logits(params, xc[:, last : last + 1], cfg)
    return _logits(params, x, cfg), cache, stats


def prefill(
    params,
    tokens: torch.Tensor,       # (B, S) int
    cfg: ModelConfig,
    ctx: ParallelCtx = NO_MESH,
    max_seq: int | None = None,
    dtype=None,
    paged: bool = False,
    page_size: int = PAGE_SIZE,
    n_pages: int | None = None,
    tables: torch.Tensor | None = None,    # (B, NB) allocator block tables
    lengths: torch.Tensor | None = None,   # (B,) true prompt lengths
    placement=None,             # (slot_of, n_replicas); None = native homes
):
    """Process the prompts; return (last-position logits ``(B, 1, V)``,
    primed cache, dense or with ``paged`` paged). The cache takes the
    activations' dtype unless ``dtype`` says otherwise (the reference's
    dense prefill caches in fp32 whatever the params' dtype). Paged mode:
    ``tables`` are allocator block tables and ``lengths`` marks true prompt
    lengths of right-padded ragged batches (logits come from each request's
    last true position). ``placement`` routes the EP experts as in
    ``decode_step``; the reference's prefill takes none and routes every
    copy to the expert's native slot, which a revival may have scrubbed."""
    _check_pattern(cfg)
    b, s = tokens.shape
    x = _embed(params, tokens)
    max_seq = max(max_seq or s, s)
    cache = init_cache(cfg, b, max_seq, dtype or x.dtype, paged, page_size,
                       n_pages, x.device, ctx)
    length = cache_len(cfg, max_seq)
    slots, heads = dense_shard(cfg, length, ctx)
    if paged:
        heads = pool_heads(cfg, ctx)
    if tables is not None:
        cache["layers"]["tables"].copy_(
            tables.to(torch.int32)[None].expand_as(cache["layers"]["tables"])
        )
    positions = torch.arange(s, device=x.device).expand(b, s)
    for l in range(cfg.n_layers):
        p_l = layer_view(params["layers"], l)
        c_l = _layer_cache(cache["layers"], l)
        z = rms_norm(x, p_l["ln1"], cfg.norm_eps)
        o, (k, v) = attention(p_l["attn"], z, cfg, ctx, positions, return_kv=True)
        x = x + o
        k, v = k[:, :, heads], v[:, :, heads]
        if paged:
            c_new = paged_prefill_fill(c_l, k, v, s, lengths)
            cache["layers"]["lengths"][l].copy_(c_new["lengths"])
        else:
            dense_prefill_fill(c_l, k, v, cfg, length, slots.start)
        z2 = rms_norm(x, p_l["ln2"], cfg.norm_eps)
        y, _ = _block_ffn(p_l, z2, cfg, ctx, placement, None)
        x = x + y
    cache["pos"] = s
    if lengths is not None:
        last = (lengths.long() - 1).clamp(0, s - 1)
        x = x[torch.arange(b, device=x.device), last][:, None]
    else:
        x = x[:, -1:]
    return _logits(params, x, cfg), cache
