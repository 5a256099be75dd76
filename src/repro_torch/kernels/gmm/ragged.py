"""Wrappers for the ragged grouped-matmul CUDA kernels
(``csrc/gmm_ragged.cu``), replacing the TPU kernels
``repro/kernels/gmm/ragged.py::gmm_ragged`` and ``::gmm_dual_act_ragged``.

On a CUDA tensor a wrapper launches its kernel (or raises on what the
kernel does not take); on a CPU tensor it runs the plain version in
:mod:`repro_torch.kernels.gmm.ref`. ``<wrapper>.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gmm import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def can_gmm(d: int, f: int, dtype: torch.dtype) -> bool:
    """Hopper gate: fp32/bf16 and inner dims that split into 16-byte
    vectors (the kernel loads weights and rows 16 bytes at a time)."""
    if dtype not in DTYPES:
        return False
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    return d % vec == 0 and f % vec == 0


def _check(x, ws, group_sizes, gpw: int, name: str):
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (G, C, D), got {tuple(x.shape)}")
    g, c, d = x.shape
    f = ws[0].shape[-1]
    for w in ws:
        if w.shape != (g // gpw, d, f) or g % gpw:
            raise ValueError(
                f"{name}: weight {tuple(w.shape)} does not match x "
                f"{tuple(x.shape)} with groups_per_weight={gpw}"
            )
        if w.dtype != x.dtype or w.device != x.device:
            raise ValueError(f"{name}: weights must match x's dtype and device")
    if group_sizes.shape != (g,) or group_sizes.dtype != torch.int32:
        raise ValueError(f"{name}: group_sizes must be int32 of shape ({g},)")
    if group_sizes.device != x.device:
        raise ValueError(f"{name}: group_sizes must lie on {x.device}")
    if not can_gmm(d, f, x.dtype):
        raise ValueError(
            f"{name}: dtype {x.dtype} with D={d}, F={f} is outside the "
            f"kernel's gate (fp32/bf16, D and F multiples of 16 bytes)"
        )
    for t in (x, *ws, group_sizes):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    for t in (x, *ws):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    return g, c, d, f


def _launch(x, wa, wb, group_sizes, gpw: int, dual: bool) -> torch.Tensor:
    name = "gmm_dual_act_ragged" if dual else "gmm_ragged"
    ws = (wa, wb) if dual else (wa,)
    g, c, d, f = _check(x, ws, group_sizes, gpw, name)
    out = torch.empty((g, c, f), dtype=x.dtype, device=x.device)
    fn = build.entry("gmm_ragged", "gmm_ragged_launch", 5, 7)
    rc = fn(
        x.data_ptr(), wa.data_ptr(), (wb if dual else wa).data_ptr(),
        group_sizes.data_ptr(), out.data_ptr(),
        g, c, d, f, gpw, DTYPES[x.dtype], int(dual),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, name)
    return out


def gmm_ragged(x, w, group_sizes, groups_per_weight: int = 1) -> torch.Tensor:
    """y[g, :count_g] = x[g, :count_g] @ w[g // gpw]; tail rows zero."""
    if not x.is_cuda:
        return ref.gmm_ragged(x, w, group_sizes, groups_per_weight)
    out = _launch(x, w, None, group_sizes, groups_per_weight, dual=False)
    gmm_ragged.launches += 1
    return out


def gmm_dual_act_ragged(
    x, wg, wu, group_sizes, groups_per_weight: int = 1
) -> torch.Tensor:
    """h[g] = silu(x@wg) * (x@wu) on the first count_g rows; tail zero."""
    if not x.is_cuda:
        return ref.gmm_dual_act_ragged(x, wg, wu, group_sizes, groups_per_weight)
    out = _launch(x, wg, wu, group_sizes, groups_per_weight, dual=True)
    gmm_dual_act_ragged.launches += 1
    return out


gmm_ragged.launches = 0
gmm_dual_act_ragged.launches = 0
