"""Parallel context threaded through model code (no-mesh subset of
``repro.parallel.ctx``; multi-GPU EP over ``torch.distributed`` comes with
a later slice).

``use_kernels`` decides, per tensor, whether a hot-path call launches its
hand-written CUDA kernel or runs the plain PyTorch version:

* ``"auto"`` (default) — the kernel for CUDA tensors, the plain version for
  CPU tensors;
* ``True`` — the kernel; on a CPU tensor this raises (there is no CUDA
  kernel to run there, and silently taking the plain path would hide it);
* ``False`` — an explicit request for the plain math on any device.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    moe_impl: str = "auto"           # auto | dense | ep | esp
    capacity_factor: float = 2.0     # MoE dispatch capacity
    use_kernels: str | bool = "auto"
    # Split the expert groups into this many chunks for the grouped FFN
    # (collectives.validate_ep_chunks); 1 = one call over every group.
    ep_chunks: int = 1

    def __post_init__(self):
        if self.use_kernels not in ("auto", True, False):
            raise ValueError(
                f"use_kernels={self.use_kernels!r}: want 'auto', True or False"
            )

    def kernels_on(self, t: torch.Tensor) -> bool:
        """Does a hot-path call on ``t`` take the CUDA kernel?"""
        if self.use_kernels is False:
            return False
        if t.is_cuda:
            return True
        if self.use_kernels is True:
            raise RuntimeError(
                f"use_kernels=True but the tensor lies on {t.device}: the "
                f"CUDA kernels run only on CUDA tensors (use 'auto' or False "
                f"for the plain PyTorch path)"
            )
        return False


NO_MESH = ParallelCtx()
