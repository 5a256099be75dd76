"""Cross-pod communication compression, int8 on the wire (PyTorch port of
``repro.parallel.grad_compress``).

The ``pod`` axis rides the slow links between pods, so its traffic is the
byte budget that matters at scale. :func:`compressed_pod_mean` averages a
tree of tensors across pods with an int8 wire format (4x fewer bytes than
fp32): the training loop's periodic cross-pod parameter sync
(``launch.train --pod-sync K``), which pods run between instead of an
all-reduce every step. :func:`_quant` and :func:`_pod_psum_int8` are its
building blocks: an unbiased stochastic rounding to int8 with one scale a
tensor, and the reduce-scatter / all-gather over ``Mesh.pod_group`` that
carries int8 both ways.

The rounding noise comes from an explicit ``torch.Generator`` seeded from
``(seed, leaf index)``, as the reference folds the leaf index into its
key. Every pod ends with the same result: the last step all-gathers one
requantised chunk from each pod.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.runtime.optimizer import leaves


def _generator(seed: int, index: int, device: torch.device) -> torch.Generator:
    state = np.random.SeedSequence([seed, index]).generate_state(2, dtype=np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def _quant(x: torch.Tensor, gen: torch.Generator):
    """``(q int8, scale)``: one scale ``max|x| / 127 + 1e-12`` for the whole
    tensor, and ``x / scale`` rounded stochastically (uniform noise in
    [-0.5, 0.5) before the rounding), clipped to [-127, 127]."""
    scale = x.abs().max() / 127.0 + 1e-12
    y = x / scale
    noise = torch.rand(y.shape, generator=gen, device=y.device, dtype=torch.float32) - 0.5
    q = torch.clamp(torch.round(y + noise), -127, 127).to(torch.int8)
    return q, scale


def _gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """``(n, *t.shape)``: every rank's ``t`` in group-rank order."""
    out = t.new_empty(n * t.numel())
    dist.all_gather_into_tensor(out, t.reshape(-1).contiguous(), group=group)
    return out.reshape(n, *t.shape)


def _pod_psum_int8(x: torch.Tensor, group, n_pods: int, gen: torch.Generator) -> torch.Tensor:
    """The sum of one fp32 tensor over ``group`` (the pod group), int8 on
    the wire: each pod's int8 chunks exchanged (chunk i lands on pod i),
    the scales all-gathered, the chunk summed in fp32 and requantised, and
    the summed chunks all-gathered in int8."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n_pods
    flat = torch.nn.functional.pad(flat, (0, pad)).reshape(n_pods, -1)
    q, scale = _quant(flat, gen)
    recv = torch.empty_like(q)
    dist.all_to_all_single(recv, q, group=group)
    scales = _gather(scale.reshape(()), group, n_pods)            # (n_pods,)
    part = (recv.float() * scales[:, None]).sum(dim=0)
    q2, scale2 = _quant(part[None], gen)
    got = _gather(q2[0], group, n_pods)                            # (n_pods, chunk)
    scales2 = _gather(scale2.reshape(()), group, n_pods)
    full = (got.float() * scales2[:, None]).reshape(-1)
    return full[: x.numel()].reshape(x.shape)


def compressed_pod_mean(tree, mesh, seed: int = 0):
    """Average a nested dict of tensors over ``mesh``'s pod axis, int8 on
    the wire. Each leaf is the rank's own slice; the pod group joins the
    ranks of one ``(data, model)`` coordinate, which hold the same slices.
    Returns ``tree`` itself when the mesh has one pod, else a new tree of
    the leaves' dtypes."""
    n_pods = mesh.pod
    if n_pods == 1:
        return tree
    out = iter([
        (_pod_psum_int8(x.float(), mesh.pod_group, n_pods, _generator(seed, i, x.device))
         / n_pods).to(x.dtype)
        for i, x in enumerate(leaves(tree))
    ])

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(t[k]) for k in sorted(t)}
        return None if t is None else next(out)

    return rebuild(tree)
