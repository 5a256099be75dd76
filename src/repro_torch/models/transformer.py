"""Model assembly: init / prefill / one-token decode for every block
pattern of the reference (PyTorch port of ``repro.models.transformer``).

Block patterns (``cfg.block_pattern``):

* ``attn``   — decoder-only transformer, dense SwiGLU or MoE FFN, over a
  dense or a paged KV cache; frontend-stub embeds (vlm) are prepended;
* ``zamba``  — units of ``attn_every`` Mamba2 layers, each followed by one
  invocation of a single *shared* attention + MLP block; trailing Mamba2
  layers close the stack;
* ``xlstm``  — units of 3 mLSTM blocks + 1 sLSTM block;
* ``encdec`` — bidirectional encoder over the frontend embeds, then a
  causal decoder with cross-attention over the encoder's K/V, computed
  once at prefill and cached.

Layers are stacked as ``(L, ...)`` tensors (so ``w[l]`` is a contiguous
view; zamba's and xlstm's units as ``(units, per-unit, ...)``) and driven
by a Python loop where the reference scans; the caches are written in
place. Recurrent states (``models.ssm``) are fp32 and O(1) in context.

Under a mesh every rank runs the ``attn`` pattern on its own requests (the
batch split over the data axis), with its shard of the dense cache or of
the paged pool (``parallel.sharding``); the EP prefill splits the sequence
over the model axis inside ``ep_moe_shardmap`` and gathers it back there.
The prefill lane's chunk is the same on every rank (the reference's
``chunk_specs`` replicate it). The other patterns under a mesh come with a
later slice.

``forward`` is the training pass over the whole causal sequence, for
every block pattern on one process and for the ``attn`` pattern under a
mesh, where autograd runs through the EP and ESP collectives. With
``ctx.remat`` each layer body runs under ``torch.utils.checkpoint``,
where the reference checkpoints its scan bodies; the recompute re-issues
the layer's collectives, in the same order on every rank.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import ssm
from repro_torch.models.attention import (
    PAGE_SIZE,
    attention,
    attn_init,
    cache_init,
    cache_len,
    chunk_prefill_attention,
    cross_attention,
    cross_kv,
    decode_attention,
    dense_prefill_fill,
    dense_shard,
    is_paged,
    paged_cache_init,
    paged_prefill_fill,
    pool_heads,
)
from repro_torch.models.layers import mlp_apply, mlp_init, mm, normal_init, rms_norm
from repro_torch.models.moe import moe_apply, moe_init, zero_aux
from repro_torch.parallel.ctx import NO_MESH, ParallelCtx

XLSTM_UNIT_M = 3  # mLSTM blocks per unit (then 1 sLSTM)
PATTERNS = ("attn", "zamba", "xlstm", "encdec")


def check_mesh(cfg: ModelConfig, ctx: ParallelCtx) -> None:
    """Only the ``attn`` pattern serves and trains under a mesh so far."""
    if ctx.mesh is not None and cfg.block_pattern != "attn":
        raise NotImplementedError(
            f"block_pattern={cfg.block_pattern!r} under a mesh is not ported yet "
            f"(ROADMAP Queue 1 item 6: the reference's layouts of the Mamba, "
            f"xLSTM and encoder-decoder states and caches)"
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

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


def _encdec_block_init(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                       cross: bool) -> dict:
    """An encoder block, or with ``cross`` a decoder block (its
    cross-attention ``xattn`` and norm ``ln_x``); zamba's shared block."""
    p = {
        "ln1": torch.ones(cfg.d_model, dtype=dtype, device=device),
        "ln2": torch.ones(cfg.d_model, dtype=dtype, device=device),
        "attn": attn_init(gen, cfg, dtype, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }
    if cross:
        p["ln_x"] = torch.ones(cfg.d_model, dtype=dtype, device=device)
        p["xattn"] = attn_init(gen, cfg, dtype, device)
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


def _stack(init_one, *lead: int) -> dict | None:
    """``prod(lead)`` fresh trees from ``init_one()`` stacked with leading
    dims ``lead``; None when there are none (the reference's empty stack)."""
    n = 1
    for d in lead:
        n *= d
    if n == 0:
        return None
    stacked = None
    for l in range(n):
        stacked = _stack_into(stacked, init_one(), l, n)
    return _map(lambda t: t.reshape(*lead, *t.shape[1:]), stacked)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def zamba_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(n_units, n_trailing_mamba)."""
    u = cfg.n_layers // cfg.attn_every
    return u, cfg.n_layers - u * cfg.attn_every


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device="cuda") -> dict:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (the
    card unless the caller passes ``device='cpu'``). Keys and layouts are
    the JAX package's: ``x @ W`` orientation, layers stacked on dim 0,
    router and recurrent gate biases in fp32. The numbers differ from
    JAX's for the same seed; parity tests bridge JAX's weights instead
    (:mod:`repro_torch.bridge`)."""
    pat = cfg.block_pattern
    if pat not in PATTERNS:
        raise ValueError(pat)
    if pat == "xlstm" and cfg.n_layers % (XLSTM_UNIT_M + 1):
        raise AssertionError("xlstm depth % 4 != 0")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    params: dict = {
        "embed": normal_init(gen, (cfg.vocab_size, d), dtype=dtype, device=dev),
        "final_norm": torch.ones(d, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (d, cfg.vocab_size), dtype=dtype, device=dev)

    def ln():
        return torch.ones(d, dtype=dtype, device=dev)

    if pat == "attn":
        params["layers"] = _stack(lambda: _attn_block_init(gen, cfg, dtype, dev),
                                  cfg.n_layers)
    elif pat == "zamba":
        u, r = zamba_layout(cfg)

        def mamba_one():
            return {"ln": ln(), "mamba": ssm.mamba_init(gen, cfg, dtype, dev)}

        params["units"] = _stack(mamba_one, u, cfg.attn_every)
        params["trailing"] = _stack(mamba_one, r)
        params["shared"] = _encdec_block_init(gen, cfg, dtype, dev, cross=False)
    elif pat == "xlstm":
        u = cfg.n_layers // (XLSTM_UNIT_M + 1)
        params["units"] = {
            "m": _stack(lambda: {"ln": ln(), "m": ssm.mlstm_init(gen, cfg, dtype, dev)},
                        u, XLSTM_UNIT_M),
            "s": _stack(lambda: {"ln": ln(), "s": ssm.slstm_init(gen, cfg, dtype, dev)}, u),
        }
    else:
        params["encoder"] = _stack(
            lambda: _encdec_block_init(gen, cfg, dtype, dev, cross=False),
            cfg.n_encoder_layers)
        params["layers"] = _stack(
            lambda: _encdec_block_init(gen, cfg, dtype, dev, cross=True), cfg.n_layers)
        params["enc_norm"] = ln()
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
        return mm(x, params["embed"].T)
    return mm(x, params["lm_head"])


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _zeros_stack(one: dict, *lead: int) -> dict:
    return {k: torch.zeros((*lead, *v.shape), dtype=v.dtype, device=v.device)
            for k, v in one.items()}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.float32,
               paged: bool = False, page_size: int = PAGE_SIZE,
               n_pages: int | None = None, device="cuda",
               ctx: ParallelCtx = NO_MESH) -> dict:
    """Decode cache sized for ``max_seq`` context, on ``device`` (the card
    unless the caller passes ``device='cpu'``). ``pos`` is kept on the host
    (a Python int), and so is ``len``, the dense caches' whole slot count.

    * ``attn``: ``layers``, one stacked leaf per layer: dense ``(L, B,
      slots, heads, hd)`` k/v, or with ``paged`` a shared page pool + block
      tables; under a mesh ``batch`` is the rank's requests and the cache
      its shard (``attention.dense_shard``, ``attention.pool_heads``);
    * ``zamba``: ``units_ssm`` / ``trailing_ssm`` Mamba2 states (conv, ssm)
      stacked ``(units, attn_every, ...)`` / ``(trailing, ...)`` and
      ``shared_kv``, the shared block's dense k/v, one per unit;
    * ``xlstm``: ``m`` (C, n, m) ``(units, 3, ...)`` and ``s`` (c, n, m, h)
      ``(units, ...)``;
    * ``encdec``: the decoder's dense ``layers`` and ``cross_kv``, the
      encoder memory's (k, v) of every decoder layer ``(L, B, frontend
      tokens, K, hd)``.

    The paged cache takes the ``attn`` pattern only (the reference's
    ``ValueError``)."""
    pat = cfg.block_pattern
    if paged and pat != "attn":
        raise ValueError(f"paged KV cache requires block_pattern='attn', got {pat}")
    check_mesh(cfg, ctx)
    dev = resolve_device(device)
    cache: dict = {"pos": 0, "len": cache_len(cfg, max_seq)}
    if pat == "attn":
        if paged:
            one = paged_cache_init(cfg, batch, max_seq, dtype, page_size, n_pages, dev, ctx)
        else:
            one = cache_init(cfg, batch, max_seq, dtype, dev, ctx)
        cache["layers"] = {
            k: v[None].expand(cfg.n_layers, *v.shape).clone() for k, v in one.items()
        }
    elif pat == "zamba":
        u, r = zamba_layout(cfg)
        st = ssm.mamba_state_init(cfg, batch, dev)
        cache["units_ssm"] = _zeros_stack(st, u, cfg.attn_every)
        cache["trailing_ssm"] = _zeros_stack(st, r)
        cache["shared_kv"] = _zeros_stack(cache_init(cfg, batch, max_seq, dtype, dev), u)
    elif pat == "xlstm":
        # zeros, as the reference's init_cache builds them: the block
        # inits' stabilisers (mLSTM m = -1e30, sLSTM n = 1) hold only for a
        # block called without a state, never in the served model
        u = cfg.n_layers // (XLSTM_UNIT_M + 1)
        cache["m"] = _zeros_stack(ssm.mlstm_state_init(cfg, batch, dev), u, XLSTM_UNIT_M)
        cache["s"] = _zeros_stack(ssm.slstm_state_init(cfg, batch, dev), u)
    else:
        cache["layers"] = _zeros_stack(cache_init(cfg, batch, max_seq, dtype, dev),
                                       cfg.n_layers)
        shape = (cfg.n_layers, batch, cfg.frontend_tokens, cfg.n_kv_heads, cfg.head_dim_)
        cache["cross_kv"] = (torch.zeros(shape, dtype=dtype, device=dev),
                             torch.zeros(shape, dtype=dtype, device=dev))
    return cache


def _layer_cache(cache_layers: dict, *idx: int) -> dict:
    return {k: v[idx] for k, v in cache_layers.items()}


def _block_ffn(p_l, z2, cfg, ctx, placement, token_mask):
    if cfg.is_moe:
        return moe_apply(p_l["moe"], z2, cfg, ctx, placement=placement,
                         token_mask=token_mask)
    return mlp_apply(p_l["mlp"], z2), zero_aux(cfg, z2.device)


# ---------------------------------------------------------------------------
# the other patterns' bodies: one code path for prefill and decode
# ---------------------------------------------------------------------------

def _self_attention(p, z, kv: dict, cfg, ctx, length: int, pos: int, positions):
    """The dense-cache self-attention of zamba's shared block and the
    enc-dec decoder: a prefill over ``positions`` filling ``kv`` (``pos``
    None), or one decode step at ``pos``; ``kv`` is written in place."""
    if pos is not None:
        return decode_attention(p, z, kv, pos, cfg, ctx, length)[0]
    o, (k, v) = attention(p, z, cfg, ctx, positions, return_kv=True)
    dense_prefill_fill(kv, k, v, cfg, length)
    return o


def _recur(apply, p, ln, x, state: dict, cfg):
    """One residual recurrent block from ``state`` (views of the cache),
    which takes the block's new state in place."""
    out, new = apply(p, rms_norm(x, ln, cfg.norm_eps), cfg, state)
    for k, v in new.items():
        state[k].copy_(v)
    return x + out


def _zamba(params, x, cache, cfg, ctx, pos=None, positions=None):
    """The zamba stack over ``x``: a prefill (``positions``) or one decode
    step at ``pos``. Unit ``i`` runs its Mamba2 layers, then the shared
    block against its own slice ``i`` of ``shared_kv``."""
    u, r = zamba_layout(cfg)
    shared = params["shared"]
    for i in range(u):
        unit = layer_view(params["units"], i)
        for j in range(cfg.attn_every):
            pl = layer_view(unit, j)
            x = _recur(ssm.mamba_apply, pl["mamba"], pl["ln"], x,
                       _layer_cache(cache["units_ssm"], i, j), cfg)
        z = rms_norm(x, shared["ln1"], cfg.norm_eps)
        x = x + _self_attention(shared["attn"], z, _layer_cache(cache["shared_kv"], i),
                                cfg, ctx, cache["len"], pos, positions)
        x = x + mlp_apply(shared["mlp"], rms_norm(x, shared["ln2"], cfg.norm_eps))
    for j in range(r):
        pl = layer_view(params["trailing"], j)
        x = _recur(ssm.mamba_apply, pl["mamba"], pl["ln"], x,
                   _layer_cache(cache["trailing_ssm"], j), cfg)
    return x


def _xlstm(params, x, cache, cfg):
    """The xlstm stack over ``x`` (a prompt or one token): each unit's
    mLSTM blocks, then its sLSTM block, from the cached states."""
    for i in range(cfg.n_layers // (XLSTM_UNIT_M + 1)):
        unit = layer_view(params["units"], i)
        for j in range(XLSTM_UNIT_M):
            pl = layer_view(unit["m"], j)
            x = _recur(ssm.mlstm_apply, pl["m"], pl["ln"], x,
                       _layer_cache(cache["m"], i, j), cfg)
        ps = unit["s"]
        x = _recur(ssm.slstm_apply, ps["s"], ps["ln"], x, _layer_cache(cache["s"], i), cfg)
    return x


def _layer(body, ctx: ParallelCtx, *args):
    """One layer body, under ``torch.utils.checkpoint`` with ``ctx.remat``
    (the backward then recomputes it)."""
    if ctx.remat:
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)


def _enc_block(p, x, cfg, ctx):
    h = x + attention(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg, ctx,
                      causal=False)
    return h + mlp_apply(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps))


def _encode(params, embeds, cfg, ctx):
    """The encoder over the frontend embeds, then its final norm. The
    embeds go in uncast, as in the reference: fp32 embeds with bf16
    weights run the encoder in fp32 (the wider operand decides, through
    ``layers.mm``). Callers on the card pass embeds in the model's dtype,
    so that ``flash_attention`` (non-causal) sees it."""
    mem = embeds
    for l in range(cfg.n_encoder_layers):
        mem = _layer(_enc_block, ctx, layer_view(params["encoder"], l), mem, cfg, ctx)
    return rms_norm(mem, params["enc_norm"], cfg.norm_eps)


def _decoder(params, x, cache, cfg, ctx, pos=None, positions=None, mem=None):
    """The enc-dec decoder over ``x``: a prefill (``positions``; the cross
    K/V of ``mem`` computed and cached per layer) or one decode step at
    ``pos`` over the cached cross K/V."""
    ks, vs = [], []
    for l in range(cfg.n_layers):
        p_l = layer_view(params["layers"], l)
        z = rms_norm(x, p_l["ln1"], cfg.norm_eps)
        x = x + _self_attention(p_l["attn"], z, _layer_cache(cache["layers"], l), cfg,
                                ctx, cache["len"], pos, positions)
        if mem is None:
            kv = (cache["cross_kv"][0][l], cache["cross_kv"][1][l])
        else:
            kv = cross_kv(p_l["xattn"], mem, cfg)
            ks.append(kv[0])
            vs.append(kv[1])
        x = x + cross_attention(p_l["xattn"], rms_norm(x, p_l["ln_x"], cfg.norm_eps), kv, cfg)
        x = x + mlp_apply(p_l["mlp"], rms_norm(x, p_l["ln2"], cfg.norm_eps))
    if mem is not None:
        # the reference's scan output: the memory's dtype, whatever the cache's
        cache["cross_kv"] = (torch.stack(ks), torch.stack(vs))
    return x


# ---------------------------------------------------------------------------
# forward (train): the full causal sequence -> logits
# ---------------------------------------------------------------------------

def _attn_block(p, x, cfg, ctx, positions):
    h = x + attention(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg, ctx, positions)
    y, aux = _block_ffn(p, rms_norm(h, p["ln2"], cfg.norm_eps), cfg, ctx, None, None)
    return h + y, aux


def _dec_block(p, x, mem, cfg, ctx, positions):
    kv = cross_kv(p["xattn"], mem, cfg)
    h = x + attention(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg, ctx, positions)
    h = h + cross_attention(p["xattn"], rms_norm(h, p["ln_x"], cfg.norm_eps), kv, cfg)
    return h + mlp_apply(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps))


def _residual(apply, key: str):
    """A residual recurrent block from a zero state: ``h + apply(p[key],
    norm(h))``."""
    def body(p, h, cfg):
        return h + apply(p[key], rms_norm(h, p["ln"], cfg.norm_eps), cfg)[0]
    return body


_mamba_layer = _residual(ssm.mamba_apply, "mamba")
_mlstm_layer = _residual(ssm.mlstm_apply, "m")
_slstm_layer = _residual(ssm.slstm_apply, "s")


def _zamba_unit(p_unit, h, shared, cfg, ctx, positions):
    for j in range(cfg.attn_every):
        h = _layer(_mamba_layer, ctx, layer_view(p_unit, j), h, cfg)
    h = h + attention(shared["attn"], rms_norm(h, shared["ln1"], cfg.norm_eps), cfg, ctx,
                      positions)
    return h + mlp_apply(shared["mlp"], rms_norm(h, shared["ln2"], cfg.norm_eps))


def _xlstm_unit(p_unit, h, cfg, ctx):
    for j in range(XLSTM_UNIT_M):
        h = _layer(_mlstm_layer, ctx, layer_view(p_unit["m"], j), h, cfg)
    return _slstm_layer(p_unit["s"], h, cfg)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, ctx: ParallelCtx = NO_MESH,
            embeds: torch.Tensor | None = None):
    """Full-sequence causal forward (training): ``(logits (B, S, V), aux)``
    with ``aux`` the MoE ``loss`` and ``counts`` summed over the layers
    (zeros without MoE). ``embeds``: the frontend stub's, prepended (vlm;
    the logits cover only the token positions) or encoded (enc-dec,
    required). Recurrent blocks start from their zero states, as the
    reference's forward does. Under a mesh (the ``attn`` pattern only,
    :func:`check_mesh`) every rank runs its batch rows, the EP and ESP
    collectives differentiable (``parallel.collectives``)."""
    check_mesh(cfg, ctx)
    pat = cfg.block_pattern
    if pat not in PATTERNS:
        raise ValueError(pat)
    x = _embed(params, tokens)
    b, s, _ = x.shape
    aux = zero_aux(cfg, x.device)
    if pat == "encdec":
        if embeds is None:
            raise ValueError("an encoder-decoder forward needs the frontend embeds")
        mem = _encode(params, embeds, cfg, ctx)
        positions = torch.arange(s, device=x.device).expand(b, s)
        for l in range(cfg.n_layers):
            x = _layer(_dec_block, ctx, layer_view(params["layers"], l), x, mem, cfg, ctx,
                       positions)
        return _logits(params, x, cfg), aux
    n_front = 0
    if cfg.frontend_stub and embeds is not None:
        n_front = embeds.shape[1]
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
        s = x.shape[1]
    positions = torch.arange(s, device=x.device).expand(b, s)
    if pat == "attn":
        for l in range(cfg.n_layers):
            x, a = _layer(_attn_block, ctx, layer_view(params["layers"], l), x, cfg, ctx,
                          positions)
            aux = {k: aux[k] + a[k] for k in aux}
    elif pat == "zamba":
        u, r = zamba_layout(cfg)
        for i in range(u):
            x = _layer(_zamba_unit, ctx, layer_view(params["units"], i), x,
                       params["shared"], cfg, ctx, positions)
        for j in range(r):
            x = _layer(_mamba_layer, ctx, layer_view(params["trailing"], j), x, cfg)
    else:
        for i in range(cfg.n_layers // (XLSTM_UNIT_M + 1)):
            x = _layer(_xlstm_unit, ctx, layer_view(params["units"], i), x, cfg, ctx)
    if n_front:
        x = x[:, n_front:]
    return _logits(params, x, cfg), aux


# ---------------------------------------------------------------------------
# decode: one-token step
# ---------------------------------------------------------------------------

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
    MoE routing (their logits mean nothing). The ``zamba``, ``xlstm`` and
    ``encdec`` patterns step their recurrent states and dense caches (the
    encoder's cross K/V were cached at prefill).

    ``chunk`` adds the prefill lane (paged ``attn`` cache only; other
    patterns raise the reference's ``ValueError``): ``{"tokens": (1, C)
    int, "table": (NB,) int, "start": int, "length": int}``, one
    fixed-size chunk of an admitting request's context. In each layer the
    decode lane runs first; the chunk then flows through the same layer
    against the pool the decode lane just wrote (``chunk_prefill_
    attention``), and only its ``length`` valid rows route through the
    MoE, by the same ``placement``. Both lanes' counts add into
    ``expert_counts``, and ``stats["chunk_logits"]`` holds the logits ``(1,
    1, V)`` of the last valid chunk position. A chunk of ``length`` 0 (the
    reference's no-op chunk, which writes only the write-off page and
    routes nowhere) is skipped: this step is eager, so no shared program
    needs it.

    Under a mesh the chunk is the same on every rank (``batch_replicated``
    for its MoE), and its expert counts enter ``expert_counts`` on data
    rank 0 only, so that the Server's sum over the data group counts each
    of its copies once, as the reference's global counts do."""
    pat = cfg.block_pattern
    if chunk is not None and pat != "attn":
        raise ValueError(f"chunked prefill requires block_pattern='attn', got {pat}")
    check_mesh(cfg, ctx)
    if chunk is not None and not chunk["length"]:
        chunk = None
    x = _embed(params, token)
    pos = cache["pos"]
    aux = zero_aux(cfg, x.device)
    if pat != "attn":
        if pat == "zamba":
            x = _zamba(params, x, cache, cfg, ctx, pos=pos)
        elif pat == "xlstm":
            x = _xlstm(params, x, cache, cfg)
        else:
            x = _decoder(params, x, cache, cfg, ctx, pos=pos)
        cache["pos"] = pos + 1
        return _logits(params, x, cfg), cache, {"expert_counts": aux["counts"]}
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


# ---------------------------------------------------------------------------
# prefill: full-sequence pass that also fills the decode cache
# ---------------------------------------------------------------------------

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
    embeds: torch.Tensor | None = None,    # (B, F, d) frontend-stub embeds
):
    """Process the prompts; return (last-position logits ``(B, 1, V)``,
    primed cache, dense or with ``paged`` paged). The dense and paged K/V
    caches take the activations' dtype unless ``dtype`` says otherwise
    (the reference's prefill caches in fp32 whatever the params' dtype);
    recurrent states are fp32. Paged mode: ``tables`` are allocator block
    tables and ``lengths`` marks true prompt lengths of right-padded ragged
    batches (logits come from each request's last true position).
    ``placement`` routes the EP experts as in ``decode_step``; the
    reference's prefill takes none and routes every copy to the expert's
    native slot, which a revival may have scrubbed.

    ``embeds`` are the frontend stub's: a vlm (``frontend_stub``, ``attn``
    pattern) prepends them, cast to the token embeddings' dtype, so they
    take cache rows and count in ``lengths`` and ``pos``; an enc-dec
    encodes them (required)."""
    b, s = tokens.shape
    pat = cfg.block_pattern
    x = _embed(params, tokens)
    if cfg.frontend_stub and embeds is not None and pat != "encdec":
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
        s = x.shape[1]
    max_seq = max(max_seq or s, s)
    cache = init_cache(cfg, b, max_seq, dtype or x.dtype, paged, page_size,
                       n_pages, x.device, ctx)
    positions = torch.arange(s, device=x.device).expand(b, s)
    if pat == "zamba":
        x = _zamba(params, x, cache, cfg, ctx, positions=positions)
    elif pat == "xlstm":
        x = _xlstm(params, x, cache, cfg)
    elif pat == "encdec":
        if embeds is None:
            raise ValueError("an encoder-decoder prefill needs the frontend embeds")
        x = _decoder(params, x, cache, cfg, ctx, positions=positions,
                     mem=_encode(params, embeds, cfg, ctx))
    else:
        length = cache["len"]
        slots, heads = dense_shard(cfg, length, ctx)
        if paged:
            heads = pool_heads(cfg, ctx)
        if tables is not None:
            cache["layers"]["tables"].copy_(
                tables.to(torch.int32)[None].expand_as(cache["layers"]["tables"])
            )
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
