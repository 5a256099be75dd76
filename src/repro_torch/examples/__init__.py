"""The reference's five examples as the port's entry points.

Each module is the counterpart of a script under the repository's
``examples/`` and runs as ``python -m repro_torch.examples.<name>``: on
the card by default, on the CPU with ``--device cpu``. Each has one entry
point, ``main(argv=None, *, params=None, use_kernels=True) -> dict``,
which prints the reference script's lines in its format and returns the
figures it printed:

* ``balancer_demo``: the NI-Balancer on the analytic evaluator (numpy on
  the host, no kernel);
* ``quickstart``: ER-Mapping against the baseline mapping, the smoke
  mixtral-8x22b forward, ``Server.generate`` on the dense cache;
* ``continuous_serving``: the ``RequestScheduler`` under a seeded fault
  plan, held to sequential fault-free runs;
* ``serve_moe``: batched MoE serving, under a ``(W // 4, 4)`` mesh when
  ``torchrun`` starts 8 or more ranks, else the no-mesh fallback, then a
  failure drill where the balancer runs;
* ``train_tiny_lm``: a narrowed llama3.2-1b trained with checkpoints and
  restart.

``params`` hands in parameters drawn elsewhere (the tests bridge the JAX
examples' own); without it an example draws them with the port's seeded
``init_params``. ``use_kernels=False`` runs the plain PyTorch paths on
any device (the card's plain comparison run); ``True`` launches the CUDA
kernels for CUDA tensors and takes the plain versions for CPU tensors.

The ``[core]`` lines of ``quickstart`` and every line of
``balancer_demo`` print modelled times of the paper's platforms (the
analytic model), not times of the card.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, smoke
from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS


def parser(doc: str) -> argparse.ArgumentParser:
    """An example's argument parser with the port's ``--device``."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    return ap


def kernels(use_kernels: bool) -> str | bool:
    """``main``'s switch -> ``ParallelCtx.use_kernels``: the kernels for
    CUDA tensors (``"auto"``), or the plain paths everywhere."""
    return "auto" if use_kernels else False


def smoke_model(arch: str, device: torch.device, **changes):
    """``smoke(get_config(arch))`` with ``changes``, as the reference's
    examples build it. Its head dim of 16 is below the smallest the
    Hopper attention kernels instantiate, so on the card the model takes
    that one (32); on the CPU it is the reference's model."""
    cfg = dataclasses.replace(smoke(get_config(arch)), **changes)
    if device.type == "cuda" and cfg.head_dim_ not in HEAD_DIMS:
        cfg = dataclasses.replace(cfg, head_dim=min(HEAD_DIMS))
    return cfg
