"""Training step: loss, gradients, microbatch accumulation, remat (PyTorch
port of ``repro.runtime.train``), on one process or under a mesh.

``make_train_step`` builds a ``(state, batch) -> (state, metrics)``
closure with:

* causal cross-entropy (fp32 ``logsumexp`` less the gold logit) plus
  ``AUX_WEIGHT`` times the MoE aux loss;
* gradients by autograd through ``models.transformer.forward``: the
  kernels' own backward is the registry's (``kernels/registry.py``:
  kernel forward, recomputed plain backward, as the reference's
  ``custom_vjp``s);
* optional accumulation over leading microbatches (their mean, as the
  reference's scan takes it);
* remat over layers through ``ctx.remat``;
* ``runtime.optimizer.adamw_update``, in place.

Under a mesh (``ctx.mesh``; the ``attn`` pattern) each rank holds its
slices of the state (``parallel.sharding.rank_params``) and trains on its
rows of the global batch (``sharding.batch_rows``). Autograd runs through
the EP and ESP collectives (``parallel.collectives``' Functions), so a
leaf replicated over the model group gets the same gradient on every
rank of it; :func:`grads_of` then averages every gradient and the
``loss``, ``ce`` and ``aux`` over the data group (``pod x data``, the
reference's batch axes), and the clip norm is the whole model's
(``optimizer.global_norm``): the reference's GSPMD step on the global
batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.runtime.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    leaves,
    tree_map,
)

AUX_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


def loss_fn(params, batch: dict, cfg: ModelConfig, ctx: ParallelCtx):
    """``(ce + AUX_WEIGHT * aux, {"ce", "aux"})`` of one batch (``tokens``,
    ``labels``, and ``embeds`` for a frontend-stub model)."""
    logits, aux = T.forward(params, batch["tokens"], cfg, ctx, embeds=batch.get("embeds"))
    ce = cross_entropy(logits, batch["labels"])
    return ce + AUX_WEIGHT * aux["loss"], {"ce": ce, "aux": aux["loss"]}


def grads_of(params, batch: dict, cfg: ModelConfig, ctx: ParallelCtx):
    """``(grads, metrics)`` of one batch: the gradient of :func:`loss_fn`
    for every leaf (zeros for a leaf the loss does not reach, as JAX gives),
    in the leaf's dtype, and the detached ``loss``, ``ce`` and ``aux``."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, met = loss_fn(live, batch, cfg, ctx)
    flat = list(leaves(live))
    got = dict(zip(map(id, flat), torch.autograd.grad(loss, flat, allow_unused=True)))
    grads = tree_map(lambda p: torch.zeros_like(p) if got[id(p)] is None else got[id(p)],
                     live)
    met = {k: v.detach() for k, v in met.items()}
    met["loss"] = loss.detach()
    mesh = ctx.mesh
    if mesh is not None and mesh.n_batch > 1:
        def mean(g):
            g = g.contiguous()
            dist.all_reduce(g, group=mesh.data_group)
            return g.div_(mesh.n_batch)

        grads = tree_map(mean, grads)
        keys = sorted(met)
        vals = torch.stack([met[k] for k in keys])
        dist.all_reduce(vals, group=mesh.data_group)
        met = dict(zip(keys, vals / mesh.n_batch))
    return grads, met


def _sharded_flags(tree, layout: dict, prefix: str = ""):
    """Is each leaf (in ``optimizer.leaves`` order) one of ``layout``'s?"""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sharded_flags(tree[k], layout, f"{prefix}{k}/")
    elif tree is not None:
        yield prefix.rstrip("/") in layout


def make_train_step(cfg: ModelConfig, ctx: ParallelCtx, opt: AdamWConfig,
                    microbatches: int = 1, grad_compress: bool = False):
    """Build the train step. ``batch["tokens"]``: ``(B, S)``, or with
    ``microbatches > 1`` ``(microbatches, B, S)`` (every batch entry with
    that leading dim; under a mesh the rank's rows). The step updates the
    state in place and returns it with the metrics ``loss``, ``ce``,
    ``aux`` (the microbatches' means), ``grad_norm`` (before clipping) and
    ``lr``, as 0-dim tensors.

    ``grad_compress`` is taken and changes nothing, as in the reference:
    its cross-pod sync is the training loop's, every ``--pod-sync`` steps
    (``parallel.grad_compress.compressed_pod_mean``)."""
    T.check_mesh(cfg, ctx)
    layout = sharding.param_layout(cfg, ctx)
    group = ctx.mesh.model_group if ctx.mesh is not None else None

    def step(state: dict, batch: dict):
        params = state["params"]
        if microbatches > 1:
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            mets = []
            for i in range(microbatches):
                g, met = grads_of(params, {k: v[i] for k, v in batch.items()}, cfg, ctx)
                tree_map(lambda acc, gi: acc.add_(gi.float()), grads, g)
                mets.append(met)
                del g
            grads = tree_map(lambda g: g / microbatches, grads)
            met = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
        else:
            grads, met = grads_of(params, batch, cfg, ctx)
        sharded = None if ctx.mesh is None else list(_sharded_flags(params, layout))
        new_params, new_opt, om = adamw_update(grads, state["opt"], params, opt,
                                               sharded, group)
        met.update(om)
        return {"params": new_params, "opt": new_opt}, met

    return step


def init_state(cfg: ModelConfig, seed: int = 0, dtype=torch.float32, device="cuda",
               ctx: ParallelCtx | None = None) -> dict:
    """``{"params", "opt"}``: seeded random parameters on ``device`` (the
    card unless the caller passes ``device='cpu'``) and fresh AdamW state.
    Under ``ctx``'s mesh every rank draws the same full parameters and
    keeps its slices (``sharding.rank_params``), so any mesh trains the
    same model."""
    params = T.init_params(cfg, seed=seed, dtype=dtype, device=device)
    if ctx is not None:
        params = sharding.rank_params(params, cfg, ctx)
    return {"params": params, "opt": adamw_init(params)}
