"""Wrapper for the flash-attention CUDA kernel (``csrc/flash_attention.cu``),
replacing the TPU kernel
``repro/kernels/flash_attention/flash_attention.py::flash_attention``.

On a CUDA tensor it launches the kernel (or raises on what the kernel does
not take); on a CPU tensor it runs :func:`ref.mha`.
``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)   # instantiated in the kernel (register tiles)


def can_flash_attend(s: int, t: int, nh: int, nkv: int, hd: int,
                     dtype: torch.dtype) -> bool:
    """Hopper gate: fp32/bf16, an instantiated head dim, GQA grouping, and
    queries no longer than keys (they sit at the key range's tail)."""
    return (
        dtype in DTYPES and nkv > 0 and nh % nkv == 0
        and hd in HEAD_DIMS and 0 < s <= t
    )


def flash_attention(q, k, v, causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, T, K, hd) -> (B, S, H, hd)."""
    if not q.is_cuda:
        return ref.mha(q, k, v, causal=causal, window=window)
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    if k.shape != (b, t, nkv, hd) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if not can_flash_attend(s, t, nh, nkv, hd, q.dtype):
        raise ValueError(
            f"flash_attention: S={s}, T={t}, H={nh}, K={nkv}, hd={hd}, "
            f"{q.dtype} is outside the kernel's gate"
        )
    for x in (q, k, v):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError("flash_attention: q, k, v must share dtype and device")
        if not x.is_contiguous():
            raise ValueError("flash_attention: inputs must be contiguous")
    out = torch.empty_like(q)
    fn = build.entry("flash_attention", "flash_attention_launch", 4, 9)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, t, nh, nkv, hd, int(causal), int(window), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
