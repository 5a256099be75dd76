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
  tables and lengths follow it (``bdim_spec``).

The train state's layout (``state_specs``) follows from these:
:func:`param_layout` names the model-sharded parameter leaves (the EP
slot rows of the experts at their native homes, or the ESP hidden-dim
shards) with the dim and slice a rank keeps; every other leaf is
replicated over the model group (the port has no tensor parallelism,
ROADMAP Queue 1 item 5), and the AdamW moments take their parameter's
layout. :func:`rank_params` cuts a full tree (parameters or a moment) to
a rank's slices, so that every rank starting from the same full init
trains the same model on any mesh.
"""

from __future__ import annotations

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


def param_layout(cfg, ctx) -> dict[str, tuple[int, slice]]:
    """The model-sharded leaves of the stacked ``attn`` parameters, by
    path (``"layers/moe/w_gate"``): ``(dim, the rank's slice)``. Under EP
    the slot rows (dim 1 of ``(L, E, ...)``), under ESP the hidden dim
    (``w_gate``/``w_up`` dim 3, ``w_down`` dim 2), each only where it
    splits; empty when every leaf is replicated."""
    m, r = ctx.n_model, ctx.model_rank
    impl = moe_layout(cfg, ctx)
    names = ("w_gate", "w_up", "w_down")
    if impl == "ep" and is_split(cfg.n_experts, m):
        rows = slot_rows(cfg.n_experts, m, r)
        return {f"layers/moe/{w}": (1, rows) for w in names}
    if impl == "esp" and is_split(cfg.moe_d_ff_, m):
        fs = expert_hidden(cfg.moe_d_ff_, m, r)
        return {f"layers/moe/{w}": (2 if w == "w_down" else 3, fs) for w in names}
    return {}


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
        if spec is None:
            return tree
        dim, sl = spec
        return tree.narrow(dim, sl.start, sl.stop - sl.start).clone(
            memory_format=torch.contiguous_format)

    return cut(params, "")
