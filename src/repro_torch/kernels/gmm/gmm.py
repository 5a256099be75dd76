"""Wrappers for the padded grouped matmul, replacing the TPU kernels of
``repro/kernels/gmm/gmm.py``:

* ``gmm`` — y[g] = x[g] @ w[g];
* ``gmm_dual_act`` — h[g] = silu(x[g] @ wg[g]) * (x[g] @ wu[g]), the
  SwiGLU front half.

x is (G, C, D), the weights (G, D, F): one weight row per group and every
one of the C rows live (no counts). The kernel is ``csrc/gmm_ragged.cu``'s
bodies at their every-row layout, so the gates and checks are those of
:mod:`.ragged`.

On a CUDA tensor a wrapper launches its kernel (or raises on what the
kernel does not take); on a CPU tensor it runs the plain version in
:mod:`repro_torch.kernels.gmm.ref`. ``<wrapper>.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.gmm import ref
from repro_torch.kernels.gmm.ragged import _launch


def gmm(x, w) -> torch.Tensor:
    """(G, C, D) @ (G, D, F) -> (G, C, F), every row."""
    if not x.is_cuda:
        return ref.gmm(x, w)
    out = _launch(x, w, None, None, 1, dual=False, name="gmm")
    gmm.launches += 1
    return out


def gmm_dual_act(x, wg, wu) -> torch.Tensor:
    """silu(x @ wg) * (x @ wu) per group, every row: (G, C, D) -> (G, C, F)."""
    if not x.is_cuda:
        return ref.gmm_dual_act(x, wg, wu)
    out = _launch(x, wg, wu, None, 1, dual=True, name="gmm_dual_act")
    gmm_dual_act.launches += 1
    return out


gmm.launches = 0
gmm_dual_act.launches = 0
