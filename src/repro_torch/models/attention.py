"""GQA attention: prefill over full sequences, decode against a dense or a
paged KV cache (PyTorch port of ``repro.models.attention``).

Layout conventions: activations ``(batch, seq, d_model)``; q ``(B,S,H,hd)``;
k/v ``(B,S,K,hd)`` with ``K = n_kv_heads``; GQA in grouped form, softmax in
fp32. The dense cache is ``(B, L, K, hd)`` per layer, a ring of
``L = cache_len`` slots under a sliding window; the paged cache is a shared
page pool plus per-request block tables. The port writes K/V into either
cache *in place* (JAX returns new arrays), which keeps one copy resident.

Under a mesh (``ctx.mesh``) every rank computes attention's projections
for all heads of its requests (no tensor parallelism yet) and holds its
shard of the cache (``parallel.sharding``). The dense cache is split by
sequence when ``ctx.seq_parallel_kv`` and the slots divide the model axis
(a rank holds slots ``[r*L/M, (r+1)*L/M)``, a decode write lands only on
the rank that owns the slot, and decode attends through
``collectives.seq_parallel_decode_attend``), else by KV heads when they
divide, else replicated. The paged pool holds the rank's KV heads when
they divide (every page, since pages are allocated by request), else all
of them. Decode follows the reference's dispatch: ``flash_decode`` or
``flash_decode_paged`` on the rank's ``H/M`` query heads against its KV
heads where the reference's eligibility tests pass, the plain math
otherwise; a rank that attended a head shard all-gathers the heads over
the model group.

``chunk_prefill_attention`` is the prefill lane of the decode step: one
fixed-size chunk of an admitting request's context, written into the
shared pool through its own block table and attended as plain math (the
reference computes it outside any kernel too).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import registry
from repro_torch.kernels.flash_decode.ref import gather_pages
from repro_torch.models.layers import apply_rope, mm, normal_init
from repro_torch.parallel import sharding
from repro_torch.parallel.collectives import all_gather_dim, seq_parallel_decode_attend
from repro_torch.parallel.ctx import ParallelCtx

NEG_INF = -1e30
PAGE_SIZE = 128  # default logical KV page (rows per physical pool page)
CHUNKED_KV_THRESHOLD = 2048  # switch to the online-softmax path beyond this


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
              device="cpu") -> dict:
    d, h = cfg.d_model, cfg.head_dim_
    p = {
        "wq": normal_init(gen, (d, cfg.n_heads * h), dtype=dtype, device=device),
        "wk": normal_init(gen, (d, cfg.n_kv_heads * h), dtype=dtype, device=device),
        "wv": normal_init(gen, (d, cfg.n_kv_heads * h), dtype=dtype, device=device),
        "wo": normal_init(gen, (cfg.n_heads * h, d), dtype=dtype, device=device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros(width * h, dtype=dtype, device=device)
    return p


def qkv_proj(p: dict, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    h = cfg.head_dim_
    q, k, v = mm(x, p["wq"]), mm(x, p["wk"]), mm(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (
        q.reshape(b, s, cfg.n_heads, h),
        k.reshape(b, s, cfg.n_kv_heads, h),
        v.reshape(b, s, cfg.n_kv_heads, h),
    )


def out_proj(p: dict, o: torch.Tensor) -> torch.Tensor:
    b, s = o.shape[:2]
    return mm(o.reshape(b, s, -1), p["wo"])


# ---------------------------------------------------------------------------
# reference attention math (grouped GQA, fp32 softmax)
# ---------------------------------------------------------------------------

def gqa_attend(q, k, v, mask) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,K,hd); ``mask`` broadcastable to
    (B, K, G, S, T) or None. Mixed q/k dtypes score in the wider one, as
    JAX's einsum promotes them (the encoder-decoder's cross-attention over
    an fp32 memory); the output takes v's dtype."""
    b, s, nh, hd = q.shape
    nk = k.shape[2]
    g = nh // nk
    if q.dtype != k.dtype:
        dt = torch.promote_types(q.dtype, k.dtype)
        q, k = q.to(dt), k.to(dt)
    qg = q.reshape(b, s, nk, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, nh, hd)


def chunked_gqa_attend(q, k, v, causal: bool, window: int, chunk: int = 1024):
    """Online-softmax attention over KV chunks (a Python loop where the
    reference scans), so the S x T score matrix is never materialized."""
    b, s, nh, hd = q.shape
    t, nk = k.shape[1], k.shape[2]
    g = nh // nk
    while t % chunk:
        chunk //= 2
    qg = (q / math.sqrt(hd)).reshape(b, s, nk, g, hd)
    offset = t - s
    m_run = torch.full((b, nk, g, s), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, nk, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s, nk, g, hd), dtype=v.dtype, device=q.device)
    for j in range(t // chunk):
        k_blk = k[:, j * chunk : (j + 1) * chunk]
        v_blk = v[:, j * chunk : (j + 1) * chunk]
        sc = torch.einsum("bskgd,btkd->bkgst", qg, k_blk).float()
        if causal:
            qpos = offset + torch.arange(s, device=q.device)[:, None]
            kpos = j * chunk + torch.arange(chunk, device=q.device)[None, :]
            m = kpos <= qpos
            if window:
                m &= kpos > qpos - window
            sc = torch.where(m, sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m_run, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + p.sum(dim=-1)
        upd = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype), v_blk)
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None].to(acc.dtype) + upd
        m_run = m_new
    l_f = torch.clamp(l_run, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return (acc / l_f.to(acc.dtype)).reshape(b, s, nh, hd)


def causal_mask(s: int, t: int | None = None, window: int = 0, offset: int = 0,
                device="cpu") -> torch.Tensor:
    """(S, T) boolean mask; ``offset`` = absolute position of query 0 minus
    position of key 0."""
    t = t or s
    qpos = torch.arange(s, device=device)[:, None] + offset
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


# ---------------------------------------------------------------------------
# train / prefill
# ---------------------------------------------------------------------------

def attention(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx: ParallelCtx,
              positions: torch.Tensor | None = None, causal: bool = True,
              return_kv: bool = False):
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = qkv_proj(p, x, cfg)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if causal else 0
    if ctx.kernels_on(q):
        o = registry.attend(q, k, v, causal=causal, window=window)
    elif s > CHUNKED_KV_THRESHOLD:
        o = chunked_gqa_attend(q, k, v, causal, cfg.sliding_window)
    else:
        mask = causal_mask(s, window=cfg.sliding_window, device=x.device) if causal else None
        o = gqa_attend(q, k, v, mask)
    out = out_proj(p, o)
    if return_kv:
        return out, (k, v)
    return out


def cross_attention(p: dict, x: torch.Tensor, kv: tuple, cfg: ModelConfig) -> torch.Tensor:
    """Decoder cross-attention of ``x`` (B, S, d) over precomputed encoder
    k/v (no mask, no RoPE). Plain math on every device, as the reference
    computes it outside any kernel."""
    b, s, _ = x.shape
    q = mm(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim_)
    return out_proj(p, gqa_attend(q, kv[0], kv[1], None))


def cross_kv(p: dict, memory: torch.Tensor, cfg: ModelConfig) -> tuple:
    """The encoder memory's k/v ``(B, T, K, hd)`` for one decoder layer."""
    b, t, _ = memory.shape
    k, v = mm(memory, p["wk"]), mm(memory, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    shape = (b, t, cfg.n_kv_heads, cfg.head_dim_)
    return k.reshape(shape), v.reshape(shape)


# ---------------------------------------------------------------------------
# paged decode cache
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    """Logical KV slots a decode cache holds (ring length when windowed)."""
    w = cfg.sliding_window or 0
    return min(max_seq, w) if w else max_seq


def dense_shard(cfg: ModelConfig, length: int, ctx: ParallelCtx | None):
    """``(slots, heads)`` of an ``length``-slot dense cache this rank holds
    (all of both with no mesh)."""
    if ctx is None or ctx.mesh is None:
        return slice(0, length), slice(0, cfg.n_kv_heads)
    return sharding.dense_cache_shard(length, cfg.n_kv_heads, ctx.n_model,
                                      ctx.model_rank, ctx.seq_parallel_kv)


def pool_heads(cfg: ModelConfig, ctx: ParallelCtx | None) -> slice:
    """The paged pool's KV heads this rank holds."""
    if ctx is None or ctx.mesh is None:
        return slice(0, cfg.n_kv_heads)
    return sharding.kv_heads(cfg.n_kv_heads, ctx.n_model, ctx.model_rank)


def cache_init(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.float32,
               device="cpu", ctx: ParallelCtx | None = None) -> dict:
    """Dense decode cache ``{"k", "v"}`` of ``(B, slots, heads, hd)``: under
    a mesh the rank's shard (:func:`dense_shard`), else all of it."""
    slots, heads = dense_shard(cfg, cache_len(cfg, max_seq), ctx)
    shape = (batch, slots.stop - slots.start, heads.stop - heads.start, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def dense_prefill_fill(cache: dict, k: torch.Tensor, v: torch.Tensor,
                       cfg: ModelConfig, length: int | None = None,
                       lo: int = 0) -> dict:
    """Write a prefill's K/V into a dense cache, in place: the last
    ``length`` positions (default: the cache's own length), rolled under a
    sliding window so that slot ``j`` holds the position ``p`` with
    ``p % L == j`` (the decode ring). A rank whose cache holds the slots
    ``[lo, lo + its length)`` of an ``length``-slot cache writes only
    those."""
    s = k.shape[1]
    length = length or cache["k"].shape[1]
    kk, vv = k[:, -length:], v[:, -length:]
    if cfg.sliding_window and s >= length:
        kk = torch.roll(kk, s % length, dims=1)
        vv = torch.roll(vv, s % length, dims=1)
    hi = min(kk.shape[1], lo + cache["k"].shape[1])
    if hi > lo:
        cache["k"][:, : hi - lo] = kk[:, lo:hi].to(cache["k"].dtype)
        cache["v"][:, : hi - lo] = vv[:, lo:hi].to(cache["v"].dtype)
    return cache


def paged_layout(cfg: ModelConfig, max_seq: int, page_size: int = PAGE_SIZE):
    """``(page_size, n_blocks)`` for a paged cache of ``max_seq`` context
    (a sliding-window ring shrinks the page to a divisor of its length)."""
    length = cache_len(cfg, max_seq)
    bs = max(min(page_size, length), 1)
    if cfg.sliding_window:
        while length % bs:
            bs -= 1
    return bs, -(-length // bs)


def paged_cache_init(cfg: ModelConfig, batch: int, max_seq: int,
                     dtype=torch.float32, page_size: int = PAGE_SIZE,
                     n_pages: int | None = None, device="cpu",
                     ctx: ParallelCtx | None = None) -> dict:
    """Shared page pool ``(P, bs, K, hd)`` + block tables ``(B, NB)`` +
    per-request written ``lengths``. With ``n_pages`` (allocator mode) the
    pool gets one extra write-off page at index ``n_pages`` and every table
    entry starts there. Under a mesh the pool holds the rank's KV heads
    (:func:`pool_heads`) and ``batch`` is the rank's requests."""
    bs, nb = paged_layout(cfg, max_seq, page_size)
    if n_pages is None:
        pool_pages = batch * nb
        tables = torch.arange(pool_pages, dtype=torch.int32, device=device).reshape(batch, nb)
    else:
        pool_pages = n_pages + 1
        tables = torch.full((batch, nb), n_pages, dtype=torch.int32, device=device)
    heads = pool_heads(cfg, ctx)
    shape = (pool_pages, bs, heads.stop - heads.start, cfg.head_dim_)
    return {
        "pool_k": torch.zeros(shape, dtype=dtype, device=device),
        "pool_v": torch.zeros(shape, dtype=dtype, device=device),
        "tables": tables,
        "lengths": torch.zeros(batch, dtype=torch.int32, device=device),
    }


def is_paged(cache: dict) -> bool:
    return "pool_k" in cache


def paged_prefill_fill(cache: dict, k: torch.Tensor, v: torch.Tensor, s: int,
                       lengths: torch.Tensor | None = None) -> dict:
    """Scatter a prefill's K/V into the pool through the block tables, in
    place. Token ``t`` of request ``b`` lands at logical slot ``t % cap``, so
    after ``L_b`` tokens slot ``j`` holds position
    ``L_b - 1 - ((L_b - 1 - j) % cap)`` — a per-request gather that handles
    ragged right-padded prompts. Rows scattered through write-off table
    entries are never read back."""
    pool_k, pool_v, tables = cache["pool_k"], cache["pool_v"], cache["tables"]
    b, nb = tables.shape
    bs = pool_k.shape[1]
    cap = nb * bs
    if lengths is not None:
        written = lengths.to(torch.int32)
    else:
        written = torch.full((b,), s, dtype=torch.int32, device=k.device)
    j = torch.arange(cap, device=k.device)[None, :]
    last = written.long()[:, None] - 1
    pos = last - torch.remainder(last - j, cap)                  # (B, cap)
    idx = pos.clamp(0, s - 1)
    rows = torch.arange(b, device=k.device)[:, None]
    kk, vv = k[rows, idx], v[rows, idx]                          # (B, cap, K, hd)
    flat = tables.reshape(-1).long()
    page_shape = (b * nb, bs, *kk.shape[2:])
    pool_k[flat] = kk.reshape(page_shape).to(pool_k.dtype)
    pool_v[flat] = vv.reshape(page_shape).to(pool_v.dtype)
    return {"pool_k": pool_k, "pool_v": pool_v, "tables": tables, "lengths": written}


def decode_attention(p: dict, x: torch.Tensor, cache: dict, pos: int,
                     cfg: ModelConfig, ctx: ParallelCtx, length: int | None = None):
    """One decode step: ``x`` (B, 1, d) against a dense ``{"k", "v"}`` cache
    at the shared absolute position ``pos`` (a host int), or a paged cache
    at each request's own length. Returns ``(out, cache)``; the cache is
    updated in place. ``length`` is the dense cache's whole slot count,
    which a rank's shard alone does not tell under a mesh (default: the
    shard's, as with no mesh)."""
    if is_paged(cache):
        return _paged_decode_attention(p, x, cache, cfg, ctx)
    b = x.shape[0]
    q, k_new, v_new = qkv_proj(p, x, cfg)
    if cfg.rope_theta > 0:
        posb = torch.full((b, 1), pos, device=x.device)
        q = apply_rope(q, posb, cfg.rope_theta)
        k_new = apply_rope(k_new, posb, cfg.rope_theta)

    k_cache, v_cache = cache["k"], cache["v"]
    local = k_cache.shape[1]             # this rank's slots
    length = length or local             # the whole cache's
    slots, heads = dense_shard(cfg, length, ctx)
    if slots.stop - slots.start != local or heads.stop - heads.start != k_cache.shape[2]:
        raise ValueError(
            f"dense cache shard {tuple(k_cache.shape[1:3])} is not this rank's "
            f"(slots {slots}, heads {heads}) of a {length}-slot cache"
        )
    lo = slots.start
    w = cfg.sliding_window or 0
    # Full attention at pos >= length: the cache is full. Freeze it (skip
    # the write that would clobber the last slot) and clamp the mask, so
    # slot j always holds position j; serving refuses such steps anyway.
    # Under a sequence split only the rank that owns the slot writes it.
    if w > 0 or pos < length:
        slot = pos % length if w > 0 else pos
        if lo <= slot < lo + local:
            k_cache[:, slot - lo] = k_new[:, 0, heads].to(k_cache.dtype)
            v_cache[:, slot - lo] = v_new[:, 0, heads].to(v_cache.dtype)

    j = lo + torch.arange(local, device=x.device)
    if w > 0:
        # ring buffer: slot j holds absolute position pos - ((pos - j) % L);
        # negative => never written yet
        mask = pos - torch.remainder(pos - j, length) >= 0
    else:
        mask = j <= min(pos, length - 1)
    if ctx.mesh is None:
        if ctx.kernels_on(q):
            o = _flash_decode(q, k_cache, v_cache, mask)
        else:
            o = gqa_attend(q, k_cache, v_cache, mask[None, None, None, None, :])
    elif _flash_decode_eligible(q, cfg.n_kv_heads, ctx):
        o = _flash_decode_heads(q, k_cache, v_cache, mask, cfg.n_kv_heads, ctx)
    elif ctx.seq_parallel_kv and length % ctx.n_model == 0:
        # the sequence split (the reference's _seq_parallel_decode_eligible;
        # a replicated batch takes its einsum body, the plain math)
        sp_ctx = ctx if ctx.batch_split else dataclasses.replace(ctx, use_kernels=False)
        o = seq_parallel_decode_attend(q, k_cache, v_cache, mask, sp_ctx)
    else:
        o = _attend_heads(q, k_cache, v_cache, mask[None, None, None, None, :],
                          cfg.n_kv_heads, ctx)
    return out_proj(p, o), cache


def _flash_decode(q, k_cache, v_cache, mask):
    """q (B, 1, H, hd) against the dense cache through ``flash_decode``;
    ``mask`` (L,) is every request's validity (they share ``pos``). With
    no mesh every shape the kernel's gate takes is eligible (its wrapper
    raises on the rest: no fallback on the card)."""
    b = q.shape[0]
    valid = mask[None, :].expand(b, mask.shape[0])
    return registry.decode_attend(q[:, 0].contiguous(), k_cache, v_cache, valid)[:, None]


def _q_heads(nh: int, ctx: ParallelCtx) -> slice:
    """The query heads a rank attends when the model group splits them."""
    m, r = ctx.n_model, ctx.model_rank
    return slice(r * nh // m, (r + 1) * nh // m)


def _flash_decode_eligible(q, n_kv: int, ctx: ParallelCtx) -> bool:
    """The reference's ``_flash_decode_eligible`` under a mesh: the kernel
    on head shards, with the sequence split off, the query heads dividing
    the model axis, the batch split, and the KV heads dividing the axis or
    the axis dividing them (``tp % nkv == 0``: a replicated cache, of which
    each rank reads its group's KV head)."""
    tp = ctx.n_model
    if not ctx.kernels_on(q) or ctx.seq_parallel_kv:
        return False
    if q.shape[2] % tp or not ctx.batch_split:
        return False
    return n_kv % tp == 0 or tp % n_kv == 0


def _flash_decode_heads(q, k_cache, v_cache, mask, n_kv: int, ctx: ParallelCtx):
    """``flash_decode`` on the rank's ``H/M`` query heads (the reference's
    head-sharded ``_flash_decode``): against its KV heads when the cache
    is head-split, or against the one KV head of its GQA group when the
    cache is replicated (``tp % nkv == 0``, a copy of that head's slice);
    the heads are then all-gathered over the model group."""
    tp = ctx.n_model
    if tp == 1:
        return _flash_decode(q, k_cache, v_cache, mask)
    if k_cache.shape[2] == n_kv:
        i = ctx.model_rank // (tp // n_kv)
        k_cache = k_cache[:, :, i : i + 1].contiguous()
        v_cache = v_cache[:, :, i : i + 1].contiguous()
    qh = q[:, :, _q_heads(q.shape[2], ctx)].contiguous()
    o = _flash_decode(qh, k_cache, v_cache, mask)
    return all_gather_dim(o, 2, ctx.mesh.model_group)


def _attend_heads(q, k, v, mask, n_kv: int, ctx: ParallelCtx):
    """Plain GQA attention of ``q`` (B, S, H, hd) over this rank's ``k``/``v``
    (B, T, K_loc, hd): all heads when it holds every KV head, else its
    ``H/M`` query heads against its KV heads, the heads then all-gathered
    over the model group."""
    if ctx.mesh is None or k.shape[2] == n_kv:
        return gqa_attend(q, k, v, mask)
    o = gqa_attend(q[:, :, _q_heads(q.shape[2], ctx)], k, v, mask)
    return all_gather_dim(o, 2, ctx.mesh.model_group)


def _paged_decode_attention(p: dict, x: torch.Tensor, cache: dict,
                            cfg: ModelConfig, ctx: ParallelCtx):
    """One decode step against a paged cache: each request RoPEs and writes
    at its own position ``lengths[b]`` (a pool write through its table, in
    place), then attends over its live prefix. A full-attention request at
    capacity stops writing (freeze-on-overflow); serving refuses the step
    anyway. Under a mesh the rank writes its KV heads of the new rows, and
    attends as the reference's ``_paged_decode_eligible`` decides: the
    kernel on its head shard (the KV heads dividing the model axis, the
    batch split), else the plain math (:func:`_attend_heads`)."""
    pool_k, pool_v = cache["pool_k"], cache["pool_v"]
    tables, written = cache["tables"], cache["lengths"]
    bs = pool_k.shape[1]
    cap = tables.shape[1] * bs
    w = cfg.sliding_window or 0

    q, k_new, v_new = qkv_proj(p, x, cfg)
    posb = written[:, None]
    if cfg.rope_theta > 0:
        q = apply_rope(q, posb, cfg.rope_theta)
        k_new = apply_rope(k_new, posb, cfg.rope_theta)

    wl = written.long()
    slot = torch.remainder(wl, cap) if w > 0 else wl.clamp(max=cap - 1)
    page = torch.gather(tables.long(), 1, (slot // bs)[:, None])[:, 0]
    row = slot % bs
    hs = pool_heads(cfg, ctx)
    k_new = k_new[:, 0, hs].to(pool_k.dtype)
    v_new = v_new[:, 0, hs].to(pool_v.dtype)
    if w == 0:
        overflow = (wl >= cap)[:, None, None]
        k_new = torch.where(overflow, pool_k[page, row], k_new)
        v_new = torch.where(overflow, pool_v[page, row], v_new)
    pool_k[page, row] = k_new
    pool_v[page, row] = v_new
    written = written + 1
    live = written.clamp(max=cap)

    tp, n_kv = ctx.n_model, cfg.n_kv_heads
    eligible = ctx.kernels_on(q) and (ctx.mesh is None or (
        q.shape[2] % tp == 0 and n_kv % tp == 0 and ctx.batch_split))
    if eligible:
        qh = q[:, 0] if tp == 1 else q[:, 0, _q_heads(q.shape[2], ctx)]
        o = registry.decode_attend_paged(qh.contiguous(), pool_k, pool_v, tables,
                                         live)[:, None]
        if tp > 1:
            o = all_gather_dim(o, 2, ctx.mesh.model_group)
    else:
        k_all = gather_pages(pool_k, tables)
        v_all = gather_pages(pool_v, tables)
        mask = torch.arange(cap, device=x.device)[None, :] < live[:, None]
        o = _attend_heads(q, k_all, v_all, mask[:, None, None, None, :], n_kv, ctx)
    out = out_proj(p, o)
    new_cache = {"pool_k": pool_k, "pool_v": pool_v, "tables": tables,
                 "lengths": written}
    return out, new_cache


def chunk_prefill_attention(p: dict, x: torch.Tensor, cache: dict,
                            table: torch.Tensor, start: int, length: int,
                            cfg: ModelConfig, ctx: ParallelCtx):
    """Prefill-lane attention for one chunk ``x`` (1, C, d) of one admitting
    request, inside the decode step and against the pool the decode lane
    just wrote (in place). Token ``i`` sits at absolute position ``start +
    i``; its K/V land at logical slot ``start + i`` through ``table`` (NB,)
    (full attention only: slot j holds position j), and rows ``i >=
    length`` land on the write-off page (the pool's last). Then every
    written row of the table is attended under the single mask ``kpos <=
    start + i``: the previous chunks' pages and this chunk, causally.
    Under a mesh the chunk is the same on every rank; each writes and
    reads its KV heads of the pool (:func:`_attend_heads`). Returns
    ``(out (1, C, d), cache)``."""
    if cfg.sliding_window:
        raise ValueError(
            f"chunk_prefill_attention needs full attention: sliding_window="
            f"{cfg.sliding_window} remaps logical slots as the ring wraps"
        )
    pool_k, pool_v = cache["pool_k"], cache["pool_v"]
    bs = pool_k.shape[1]
    cap = table.shape[0] * bs
    c = x.shape[1]
    q, k, v = qkv_proj(p, x, cfg)
    pos = start + torch.arange(c, device=x.device)                 # (C,)
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos[None, :], cfg.rope_theta)
        k = apply_rope(k, pos[None, :], cfg.rope_theta)
    slot = pos.clamp(max=cap - 1)
    valid = torch.arange(c, device=x.device) < length
    page = torch.where(valid, table.long()[slot // bs], pool_k.shape[0] - 1)
    row = slot % bs
    hs = pool_heads(cfg, ctx)
    pool_k[page, row] = k[0, :, hs].to(pool_k.dtype)
    pool_v[page, row] = v[0, :, hs].to(pool_v.dtype)
    k_all = gather_pages(pool_k, table[None, :])                   # (1, cap, K, hd)
    v_all = gather_pages(pool_v, table[None, :])
    mask = torch.arange(cap, device=x.device)[None, :] <= pos[:, None]   # (C, cap)
    o = _attend_heads(q, k_all, v_all, mask, cfg.n_kv_heads, ctx)
    return out_proj(p, o), cache
