"""Training step: loss, gradients, microbatch accumulation, remat (PyTorch
port of ``repro.runtime.train``), on one process.

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

The reference's cross-pod gradient compression (``grad_compress``) and
training under a mesh are ROADMAP Queue 1 item 7b: asking for either
raises.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
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
    return grads, met


def make_train_step(cfg: ModelConfig, ctx: ParallelCtx, opt: AdamWConfig,
                    microbatches: int = 1, grad_compress: bool = False):
    """Build the train step. ``batch["tokens"]``: ``(B, S)``, or with
    ``microbatches > 1`` ``(microbatches, B, S)`` (every batch entry with
    that leading dim). The step updates the state in place and returns it
    with the metrics ``loss``, ``ce``, ``aux`` (the microbatches' means),
    ``grad_norm`` (before clipping) and ``lr``, as 0-dim tensors."""
    T.check_train_mesh(ctx)
    if grad_compress:
        raise NotImplementedError(
            "grad_compress (the reference's int8 cross-pod gradient sync, "
            "parallel/grad_compress.py) is not ported yet: ROADMAP Queue 1 item 7b"
        )

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
        new_params, new_opt, om = adamw_update(grads, state["opt"], params, opt)
        met.update(om)
        return {"params": new_params, "opt": new_opt}, met

    return step


def init_state(cfg: ModelConfig, seed: int = 0, dtype=torch.float32, device="cuda") -> dict:
    """``{"params", "opt"}``: seeded random parameters on ``device`` (the
    card unless the caller passes ``device='cpu'``) and fresh AdamW state."""
    params = T.init_params(cfg, seed=seed, dtype=dtype, device=device)
    return {"params": params, "opt": adamw_init(params)}
