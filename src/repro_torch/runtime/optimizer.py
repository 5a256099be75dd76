"""AdamW + cosine schedule + global-norm clipping (PyTorch port of
``repro.runtime.optimizer``) over nested dicts of tensors.

The arithmetic is the reference's, in fp32 on the device: the gradients
are clipped by their global norm, the moments (fp32 whatever the
parameters' dtype) take bias correction, and the weight decay is
decoupled and applies to every leaf. The step counter is an int32 scalar
tensor, and the schedule is computed from it on the device, so a step
reads nothing back to the host.

``adamw_update`` works leaf by leaf and in place: each parameter and its
two moments are overwritten, and only one leaf's fp32 temporaries are
alive at a time (at mixtral-8x22b width one expert tensor's fp32 copy is
3.2 GB). The reference's CLI donates the state to its jitted step, which
leaves the caller the same single copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_lr(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay to
    ``min_lr_frac * lr`` at ``total_steps``; fp32 of a step tensor."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = cfg.lr * torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)

    return lr


def adamw_init(params) -> dict:
    """``{"step": int32 0, "mu", "nu"}``: fp32 zero moments shaped as the
    parameters, on their devices."""
    leaf = next(iter(leaves(params)))
    return {"step": torch.zeros((), dtype=torch.int32, device=leaf.device),
            "mu": tree_map(_fp32_zeros, params), "nu": tree_map(_fp32_zeros, params)}


def _fp32_zeros(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(t, dtype=torch.float32)


def leaves(tree):
    """The tensors of a nested dict in the reference's flatten order (keys
    sorted; ``None`` subtrees hold none)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure (``None``
    subtrees stay ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def global_norm(tree, sharded=None, group=None) -> torch.Tensor:
    """sqrt of the sum over leaves of the sum of squares, each in fp32.

    Under a mesh the norm is the whole model's, the same on every rank:
    ``sharded`` (one bool a leaf, in :func:`leaves` order) marks the leaves
    split over ``group`` (the model group), whose sums of squares are
    all-reduced there; a replicated leaf counts once."""
    xs = list(leaves(tree))
    flags = [False] * len(xs) if sharded is None else sharded
    parts = [torch.zeros((), dtype=torch.float32, device=xs[0].device) for _ in range(2)]
    for x, split in zip(xs, flags, strict=True):
        parts[split] += x.float().square().sum()
    if any(flags):
        dist.all_reduce(parts[1], group=group)
    return torch.sqrt(parts[0] + parts[1])


def adamw_update(grads, opt_state: dict, params, cfg: AdamWConfig, sharded=None,
                 group=None):
    """One AdamW step, in place: ``params``, ``opt_state["mu"]`` and
    ``["nu"]`` are overwritten and ``opt_state["step"]`` advances. Returns
    ``(params, opt_state, {"grad_norm": pre-clip norm, "lr": lr})``, the
    same objects, as the reference returns its new state. ``sharded`` and
    ``group``: the clip norm's under a mesh (:func:`global_norm`)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, sharded, group)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = cosine_lr(cfg)(step)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    with torch.no_grad():
        for g, m, v, p in zip(leaves(grads), leaves(opt_state["mu"]),
                              leaves(opt_state["nu"]), leaves(params), strict=True):
            g = g.float() * scale
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            v.mul_(cfg.b2).add_(g.square_() * (1 - cfg.b2))
            del g
            delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            pf = p.float()
            delta.add_(cfg.weight_decay * pf)
            p.copy_(pf.sub_(lr * delta))
            del delta, pf
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
