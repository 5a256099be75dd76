"""What one rank holds under a ``("data", "model")`` mesh (port of the part
of ``repro.parallel.sharding`` that the serving path shards).

Each function is a pure function of a shape and the mesh: the slice of the
global dimension that rank ``(batch_rank, model_rank)`` keeps. They follow
the reference's specs, fallbacks included: a dimension is split only when
the axis has more than one rank and divides it (the reference's ``_ok``);
otherwise the layout degrades the reference's way, and a replicated
dimension returns its whole range.

* :func:`slot_rows` — the expert slot rows of the EP regime
  (``param_spec``'s ``"moe"`` branch: the slot dim over ``model``);
* :func:`expert_hidden` — the ESP regime's hidden-dim shard of every
  expert (``w_gate``/``w_up`` on their last dim, ``w_down`` on its
  second-to-last: ``param_spec``'s fallback where the slots do not
  divide, and the layout ``esp_expert_ffn`` takes, which the port's ESP
  Server holds whatever the expert count);
* :func:`dense_cache_shard` — the dense KV cache
  (``cache_specs``' ``kv_spec``): the sequence over ``model`` when it
  divides, else KV heads, else replicated;
* :func:`kv_heads` — the paged pool's KV heads (``pool_spec``: the page
  dim unsharded, KV heads over ``model`` when they divide);
* :func:`batch_rows` — the batch over ``data`` (``batch_spec_for``); page
  tables and lengths follow it (``bdim_spec``); the xLSTM states take
  only this split (``cache_specs``' ``xlstm`` branch);
* :func:`mamba_heads` / :func:`mamba_channels` — Mamba2's heads, aligned
  to heads (below), and the ``head``-wide channels of those heads.

**The Mamba2 layout departs from the reference's.** The reference splits
the last dim of ``w_z``, ``w_xbc``, ``conv_w``, ``conv_b`` and ``norm_w``
evenly over ``model`` and ``w_out`` on its inner dim, replicates ``w_dt``,
``a_log``, ``dt_bias`` and ``d_skip``, and lets GSPMD re-lay the
concatenated ``x|B|C`` dim out before the scan. An even split of that dim
cuts across heads: at zamba2-1.2b width ``w_xbc`` is 4096 + 128 = 4224
wide, 264 columns a rank on 16 ranks, against heads of 64. The port
aligns the split to heads instead. A rank holds its block of the
``n_heads`` Mamba heads (all of them when they do not divide the axis,
the reference's ``_ok`` fallback) and those heads' channels of ``w_z``,
``norm_w`` and ``w_out``'s rows, and of the x part of ``w_xbc``,
``conv_w`` and ``conv_b``; the ``2N`` B/C columns of those three stay
whole on every rank (:class:`Part`: its block, then the tail), since
every head reads them. ``w_dt``, ``a_log``, ``dt_bias`` and ``d_skip``
stay replicated, as in the reference; a rank reads its heads' entries.
The SSM state holds the rank's heads (the reference's spec wherever the
heads divide), the conv state the rank's x channels and all ``2N`` B/C
channels. What is left to communicate is two all-reduces per Mamba layer
(``models.ssm.mamba_apply``): the gated norm's sum of squares and the out
projection's partial sums. The served and trained results are the same
up to the order of those sums.

Tensor parallelism (:func:`tp_layout`, the reference's ``param_spec``
under every block pattern but ``xlstm``): in each attention block a rank
keeps its block of the query heads of ``wq``/``bq`` (the last dim) and
the same heads' rows of ``wo``; its KV heads of ``wk``/``wv``/``bk``/
``bv``; in each dense SwiGLU its block of the hidden dim (``w_gate``/
``w_up`` last, ``w_down`` inner); ``embed``'s vocab rows and
``lm_head``'s vocab columns. The blocks are the ``attn`` decoders'
layers, zamba's shared attention and MLP (one block, not stacked), and
the encoder-decoder's encoder attention and MLP and its decoder's
self-attention, cross-attention and MLP. Each leaf splits only where it
divides the model axis; the router, the norms and the expert layouts
are unchanged. The heads split only where ``H`` divides the axis and
the KV heads either divide it or are divided by it; otherwise every
attention leaf stays replicated.

**The KV head split departs from the reference's too.** The reference
splits the ``K * hd`` columns of ``wk``/``wv`` evenly; at qwen2-72b and
dbrx-132b on 16 ranks that is 64 columns, half a head of 128. The port
splits by heads, so that every kernel sees whole GQA groups: where ``K``
divides the axis a rank keeps its ``K / M`` heads; where ``M`` is a
multiple of ``K`` it keeps the one head its query heads read, head ``r //
(M / K)``, copied over the ``M / K`` ranks of its group (:class:`Copy`).
The copies' gradient is the sum over their holders
(``collectives.copied``), so they stay equal; the clip norm counts each
head once, and a checkpoint gathers one copy a head.

The train state's layout (``state_specs``) follows from these:
:func:`param_layout` names the model-sharded parameter leaves (the EP
slot rows of the experts at their native homes, or the ESP hidden-dim
shards, and the tensor-parallel leaves) with the dim and part a rank
keeps; every other leaf is replicated over the model group, and the
AdamW moments take their parameter's layout; zamba's Mamba leaves add
theirs (above). xLSTM stays replicated, as in the reference.
:func:`rank_params` cuts a full tree (parameters or a moment)
to a rank's slices, so that every rank starting from the same full init
trains the same model on any mesh.
"""

from __future__ import annotations

import dataclasses

import torch


def _ok(dim: int, n: int) -> bool:
    return n > 1 and dim % n == 0


def _block(n: int, parts: int, index: int) -> slice:
    """Block ``index`` of ``n`` split ``parts`` ways, or all of ``n`` when
    the split does not apply (replicated)."""
    if not _ok(n, parts):
        return slice(0, n)
    size = n // parts
    return slice(index * size, (index + 1) * size)


def is_split(n: int, parts: int) -> bool:
    """Does a dim of ``n`` split over an axis of ``parts`` ranks?"""
    return _ok(n, parts)


def slot_rows(n_slots: int, n_model: int, model_rank: int) -> slice:
    """The expert slot rows a rank holds: ``[r*spd, (r+1)*spd)`` with
    ``spd = n_slots / n_model``."""
    return _block(n_slots, n_model, model_rank)


def expert_hidden(d_ff: int, n_model: int, model_rank: int) -> slice:
    """The hidden-dim columns of every expert a rank holds under ESP."""
    return _block(d_ff, n_model, model_rank)


def dense_cache_shard(cache_len: int, n_kv: int, n_model: int, model_rank: int,
                      seq_parallel: bool = True) -> tuple[slice, slice]:
    """``(slots, heads)`` of the dense cache a rank holds: its slots when
    ``seq_parallel`` and they divide, else its KV heads when they divide,
    else all of both."""
    whole_s, whole_h = slice(0, cache_len), slice(0, n_kv)
    if seq_parallel and _ok(cache_len, n_model):
        return _block(cache_len, n_model, model_rank), whole_h
    return whole_s, _block(n_kv, n_model, model_rank)


def cache_slots(cache_len: int, n_model: int, model_rank: int) -> slice:
    """The dense cache slots (sequence positions of the ring) a rank holds
    under the sequence split (all of them when it does not divide)."""
    return _block(cache_len, n_model, model_rank)


def kv_heads(n_kv: int, n_model: int, model_rank: int) -> slice:
    """The KV heads a rank holds of a head-split cache (the paged pool)."""
    return _block(n_kv, n_model, model_rank)


def batch_rows(batch: int, n_batch: int, batch_rank: int) -> slice:
    """The requests a rank serves (all of them when the batch does not
    divide the data axis)."""
    return _block(batch, n_batch, batch_rank)


def mamba_head_dims(d_model: int) -> tuple[int, int]:
    """``(head, n_heads)`` of the Mamba2 blocks of a ``d_model``-wide model:
    heads of 64 inner channels where they fit ``2 * d_model``, else one."""
    d_inner = 2 * d_model
    head = 64 if d_inner % 64 == 0 else d_inner
    return head, d_inner // head


def mamba_heads(n_heads: int, n_model: int, model_rank: int) -> slice:
    """The Mamba2 heads a rank holds (all of them when they do not divide
    the model axis)."""
    return _block(n_heads, n_model, model_rank)


def mamba_channels(head: int, n_heads: int, n_model: int, model_rank: int) -> slice:
    """The ``head``-wide inner channels of the rank's Mamba2 heads."""
    hs = mamba_heads(n_heads, n_model, model_rank)
    return slice(hs.start * head, hs.stop * head)


@dataclasses.dataclass(frozen=True)
class Part:
    """A rank's part of a dim whose last ``tail`` entries every rank reads:
    ``block`` of the leading entries, then the whole tail (the x channels
    of a Mamba2 rank's heads, then the ``2N`` B/C channels)."""
    block: slice
    tail: int

    def index(self, n: int) -> list[int]:
        """The entries of a dim of ``n`` the rank holds, in its order."""
        return [*range(self.block.start, self.block.stop), *range(n - self.tail, n)]


@dataclasses.dataclass(frozen=True)
class Copy:
    """A rank's copy of ``block`` of a dim, which ``copies`` ranks of the
    model group hold alike (a GQA KV head read by the query heads of
    ``copies`` ranks). ``lead`` marks the first of them, which alone
    counts it in the clip norm."""
    block: slice
    copies: int
    lead: bool


def take(t: torch.Tensor, dim: int, part) -> torch.Tensor:
    """A contiguous copy of the rank's ``part`` (a block ``slice``, a
    :class:`Part` or a :class:`Copy`) of ``dim`` of the global ``t``."""
    if isinstance(part, Part):
        n = t.shape[dim]
        return torch.cat([t.narrow(dim, part.block.start, part.block.stop - part.block.start),
                          t.narrow(dim, n - part.tail, part.tail)], dim=dim)
    if isinstance(part, Copy):
        part = part.block
    return t.narrow(dim, part.start, part.stop - part.start).clone(
        memory_format=torch.contiguous_format)


def split_entries(t: torch.Tensor, dim: int, part) -> tuple[torch.Tensor, torch.Tensor | None]:
    """A rank's tensor cut into the entries split over the model group and
    the entries every rank holds (None for a block or a copy)."""
    if not isinstance(part, Part):
        return t, None
    n = t.shape[dim]
    return t.narrow(dim, 0, n - part.tail), t.narrow(dim, n - part.tail, part.tail)


def whole(t: torch.Tensor, dim: int, part, gather) -> torch.Tensor:
    """The global tensor from every rank's ``part`` of it: ``gather(own,
    dim)`` concatenates the ranks' split entries in logical order (a
    collective over the model group); a copied block is taken once, and
    the entries every rank holds are appended once."""
    own, every = split_entries(t, dim, part)
    out = gather(own, dim)
    if isinstance(part, Copy):
        out = torch.cat(out.chunk(out.shape[dim] // own.shape[dim], dim)[::part.copies], dim)
    return out if every is None else torch.cat([out, every], dim=dim)


def mamba_layout(cfg, ctx) -> dict[str, tuple[int, object]]:
    """The model-sharded Mamba2 leaves of a zamba tree (``units`` stacked
    ``(units, attn_every, ...)``, ``trailing`` ``(trailing, ...)``), by
    path: ``(dim, slice or Part)``; empty when the heads do not split."""
    if ctx.mesh is None or cfg.block_pattern != "zamba":
        return {}
    head, n_heads = mamba_head_dims(cfg.d_model)
    if not is_split(n_heads, ctx.n_model):
        return {}
    cs = mamba_channels(head, n_heads, ctx.n_model, ctx.model_rank)
    bc = Part(cs, 2 * cfg.ssm_state)
    # (leaf, its dim counted from the layer's first, the rank's part)
    leaves = (("w_z", 1, cs), ("norm_w", 0, cs), ("w_out", 0, cs),
              ("w_xbc", 1, bc), ("conv_w", 1, bc), ("conv_b", 0, bc))
    return {f"{stack}/mamba/{name}": (lead + dim, part)
            for stack, lead in (("units", 2), ("trailing", 1))
            for name, dim, part in leaves}


def moe_layout(cfg, ctx) -> str | None:
    """How the expert weights lie under ``ctx``'s mesh: ``"ep"`` (slot
    rows over the model axis), ``"esp"`` (hidden-dim shards) or None
    (whole on every rank: no mesh, no MoE, or the dense oracle).
    ``moe_impl="auto"`` under a mesh: EP where the experts divide the
    model axis, else ESP, the reference's choice (``moe_apply`` takes it;
    without a mesh it serves the dense oracle)."""
    if ctx.mesh is None or not cfg.is_moe or ctx.moe_impl == "dense":
        return None
    if ctx.moe_impl != "auto":
        return ctx.moe_impl
    return "ep" if cfg.n_experts % ctx.n_model == 0 else "esp"


def heads_split(n_heads: int, n_kv: int, n_model: int) -> bool:
    """Does attention split its heads over an axis of ``n_model`` ranks:
    the query heads dividing it, and the KV heads dividing it or divided
    by it (each rank's query heads then read whole KV heads)?"""
    return _ok(n_heads, n_model) and (n_kv % n_model == 0 or n_model % n_kv == 0)


def q_heads(n_heads: int, n_model: int, model_rank: int) -> slice:
    """The query heads a rank projects under tensor parallelism."""
    return _block(n_heads, n_model, model_rank)


def kv_part(n_kv: int, n_model: int, model_rank: int):
    """The KV heads a rank projects under tensor parallelism: its block
    where they divide the axis, else a :class:`Copy` of the one head its
    query heads read (the axis a multiple of ``n_kv``)."""
    if _ok(n_kv, n_model):
        return _block(n_kv, n_model, model_rank)
    copies = n_model // n_kv
    i = model_rank // copies
    return Copy(slice(i, i + 1), copies, model_rank % copies == 0)


def _columns(part, width: int):
    """A part of heads as a part of their ``width``-wide columns."""
    if isinstance(part, Copy):
        return dataclasses.replace(part, block=_columns(part.block, width))
    return slice(part.start * width, part.stop * width)


# block pattern -> (attention subtrees, dense MLP subtrees, their stacked dims)
TP_BLOCKS = {"attn": (("layers/attn",), ("layers/mlp",), 1),
             "zamba": (("shared/attn",), ("shared/mlp",), 0),
             "encdec": (("encoder/attn", "layers/attn", "layers/xattn"),
                        ("encoder/mlp", "layers/mlp"), 1)}


def tp_layout(cfg, ctx) -> dict[str, tuple[int, object]]:
    """The tensor-parallel leaves of a model's tree, by path: ``(dim,
    part)``, each only where it splits (empty without a mesh, for
    ``xlstm``, or where nothing divides). Each pattern's blocks are in
    :data:`TP_BLOCKS`; a leaf's dim counts its stacked dims."""
    m, r = ctx.n_model, ctx.model_rank
    blocks = TP_BLOCKS.get(cfg.block_pattern)
    if ctx.mesh is None or blocks is None or m < 2:
        return {}
    attns, mlps, lead = blocks
    out: dict[str, tuple[int, object]] = {}
    hd = cfg.head_dim_
    if heads_split(cfg.n_heads, cfg.n_kv_heads, m):
        qs = _columns(q_heads(cfg.n_heads, m, r), hd)
        ks = _columns(kv_part(cfg.n_kv_heads, m, r), hd)
        for a in attns:
            out.update({f"{a}/wq": (lead + 1, qs), f"{a}/wo": (lead, qs),
                        f"{a}/wk": (lead + 1, ks), f"{a}/wv": (lead + 1, ks)})
            if cfg.qkv_bias:
                out.update({f"{a}/bq": (lead, qs), f"{a}/bk": (lead, ks),
                            f"{a}/bv": (lead, ks)})
    if not cfg.is_moe and _ok(cfg.d_ff, m):
        fs = _block(cfg.d_ff, m, r)
        for f in mlps:
            out.update({f"{f}/w_gate": (lead + 1, fs), f"{f}/w_up": (lead + 1, fs),
                        f"{f}/w_down": (lead, fs)})
    if _ok(cfg.vocab_size, m):
        vs = _block(cfg.vocab_size, m, r)
        out["embed"] = (0, vs)
        if not cfg.tie_embeddings:
            out["lm_head"] = (1, vs)
    return out


def param_layout(cfg, ctx) -> dict[str, tuple[int, object]]:
    """The model-sharded leaves of the stacked parameters, by path
    (``"layers/moe/w_gate"``): ``(dim, the rank's part)``. Under EP the
    slot rows (dim 1 of ``(L, E, ...)``), under ESP the hidden dim
    (``w_gate``/``w_up`` dim 3, ``w_down`` dim 2), each only where it
    splits; the tensor-parallel leaves (:func:`tp_layout`, a copied KV
    head as a :class:`Copy`); zamba's Mamba2 leaves (:func:`mamba_layout`,
    whose mixed leaves take a :class:`Part`); empty when every leaf is
    replicated."""
    m, r = ctx.n_model, ctx.model_rank
    out = {**mamba_layout(cfg, ctx), **tp_layout(cfg, ctx)}
    impl = moe_layout(cfg, ctx)
    names = ("w_gate", "w_up", "w_down")
    if impl == "ep" and is_split(cfg.n_experts, m):
        rows = slot_rows(cfg.n_experts, m, r)
        out.update({f"layers/moe/{w}": (1, rows) for w in names})
    elif impl == "esp" and is_split(cfg.moe_d_ff_, m):
        fs = expert_hidden(cfg.moe_d_ff_, m, r)
        out.update({f"layers/moe/{w}": (2 if w == "w_down" else 3, fs) for w in names})
    return out


def rank_params(params: dict, cfg, ctx) -> dict:
    """Rank ``ctx``'s slices of a full parameter tree (or of a moment
    shaped like it), as the Server and the trainer keep them: the leaves
    of :func:`param_layout` cut into contiguous copies (the full tensor
    can then be freed), every other leaf whole (the same object)."""
    layout = param_layout(cfg, ctx)

    def cut(tree, prefix):
        if isinstance(tree, dict):
            return {k: cut(v, f"{prefix}{k}/") for k, v in tree.items()}
        spec = layout.get(prefix.rstrip("/"))
        if spec is None or tree is None:
            return tree
        return take(tree, *spec)

    return cut(params, "")
