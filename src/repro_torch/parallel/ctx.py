"""Parallel context threaded through model code (port of
``repro.parallel.ctx``).

``mesh`` is ``None`` for one process, or a :class:`~repro_torch.parallel.
mesh.Mesh` of ``torch.distributed`` ranks. Under a mesh the batch is split
over the batch axes (``pod x data``) and every other computation is replicated on the ranks
of a data index, except the regions the reference writes by hand: the EP
dispatch and combine (``collectives.ep_moe_shardmap``) with its decode
ownership sum; ESP's hidden-dim shards and their reduce-scatter
(``collectives.esp_expert_ffn``); and decode attention over a KV cache
split over the model axis, by sequence (partials LSE-merged across the
model group) or by KV heads (each rank attends its heads, then the heads
are gathered). The layouts are ``parallel.sharding``'s.

``seq_parallel_kv`` is the reference's switch: the dense cache's sequence
over the model axis when it divides (default), else its KV heads.
``batch_replicated`` marks operands whose batch rows are the same on every
data rank (the prefill lane's chunk, a batch-1 admission prefill, a batch
that does not divide the data axis): the reference's eligibility tests see
them as a batch that does not divide ``n_batch``.

``remat`` is the reference's switch for training: ``T.forward`` runs each
layer body under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of its scan bodies), so the backward recomputes the
layer's forward, kernels included, instead of keeping its activations.

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

from repro_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    mesh: Mesh | None = None
    moe_impl: str = "auto"           # auto | dense | ep | esp
    capacity_factor: float = 2.0     # MoE dispatch capacity
    use_kernels: str | bool = "auto"
    # Split the expert groups into this many chunks for the grouped FFN
    # (collectives.validate_ep_chunks); 1 = one call over every group.
    ep_chunks: int = 1
    # decode: the dense KV cache's sequence over the model axis (flash
    # decode partials, LSE merge) instead of its KV heads.
    seq_parallel_kv: bool = True
    # the operands' batch rows are the same on every data rank
    batch_replicated: bool = False
    # training: recompute each layer's activations in the backward
    # (``torch.utils.checkpoint``) instead of keeping them
    remat: bool = False

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

    @property
    def n_model(self) -> int:
        return 1 if self.mesh is None else self.mesh.model

    @property
    def n_batch(self) -> int:
        return 1 if self.mesh is None else self.mesh.n_batch

    @property
    def model_rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.model_rank

    @property
    def batch_rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.batch_rank

    @property
    def batch_split(self) -> bool:
        """Do the operands' batch rows differ between data ranks (the
        reference's ``b % n_batch == 0`` under a mesh)?"""
        return not self.batch_replicated or self.n_batch == 1


NO_MESH = ParallelCtx()
