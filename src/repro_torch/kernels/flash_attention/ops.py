"""The flash-attention op layer: the JAX package's
``repro/kernels/flash_attention/ops.py`` under its name and signature
(without ``interpret``). CUDA tensors take the kernel, CPU tensors its
plain version."""

from __future__ import annotations

from repro_torch.kernels.flash_attention.flash_attention import flash_attention


def flash_attention_op(q, k, v, causal: bool = True, window: int = 0):
    return flash_attention(q, k, v, causal=causal, window=window)
