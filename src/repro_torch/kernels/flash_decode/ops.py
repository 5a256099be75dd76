"""The flash-decode op layer: the JAX package's
``repro/kernels/flash_decode/ops.py`` under its names and signatures
(without ``interpret``), over the dense and paged decode wrappers. CUDA
tensors take the kernels, CPU tensors their plain versions; ``valid`` is
any integer or bool mask and is passed on as int32."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode.flash_decode import flash_decode
from repro_torch.kernels.flash_decode.paged import flash_decode_paged


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def flash_decode_op(q, k, v, valid):
    return flash_decode(q, k, v, _i32(valid))


def flash_decode_partials_op(q, k, v, valid):
    """fp32 ``(acc, m, l)`` online-softmax state over the (masked) cache —
    the operand of the cross-slice LSE merge."""
    return flash_decode(q, k, v, _i32(valid), return_partials=True)


def flash_decode_paged_op(q, pool_k, pool_v, block_tables, lengths):
    return flash_decode_paged(q, pool_k, pool_v, _i32(block_tables), _i32(lengths))
