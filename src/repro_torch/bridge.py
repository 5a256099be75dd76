"""Carry parameters and train states over from the JAX package as numpy.

``params_from_numpy`` takes the JAX package's params as a nested dict of
numpy arrays (e.g. ``jax.tree.map(np.asarray, T.init_params(...))`` on the
JAX side) and returns the port's tensors with the same keys and layouts:
``x @ W`` orientation, layers stacked on dim 0. ``None`` leaves (the
reference's empty stacks, e.g. zamba's ``trailing`` when no Mamba layer
trails the last unit) stay ``None``. With ``dtype=None`` it carries a
whole train state too (``params`` and ``opt``: the int32 ``step``
scalar, the fp32 ``mu`` and ``nu``), every leaf in its own dtype. bf16
leaves arrive as ``ml_dtypes.bfloat16`` arrays (numpy has no bf16 of its
own) and become bf16 tensors bit for bit. This module itself imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

# Leaves the reference keeps in fp32 whatever the model dtype.
FP32_LEAVES = ("router",)


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":      # ml_dtypes: its raw 2-byte patterns
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_numpy(tree, device="cpu", dtype: torch.dtype | None = None,
                      _key: str = ""):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``.
    ``dtype`` casts the floating leaves (except the fp32 router); None keeps
    each array's own dtype."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype, k) for k, v in tree.items()}
    if tree is None:
        return None
    t = _tensor(tree).to(device)
    if dtype is not None and t.is_floating_point() and _key not in FP32_LEAVES:
        t = t.to(dtype)
    return t

