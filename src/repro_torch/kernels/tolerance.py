"""How a kernel's output is held against a reference on the card.

Elementwise: ``|got - want| <= rtol * |want| + atol * rms(want's row)``,
where a row is the last axis (a token's FFN output, one head's attention
output). The rms term is the output's own scale, for values that cancel to
near zero; a row that is all zeros in ``want`` (a dead row) must match
exactly.
"""

from __future__ import annotations

import math

import torch

# Kernel vs its plain version on the same inputs: (rtol, atol).
PLAIN = {
    # summation order only (TF32 off)
    torch.float32: (1e-4, 1e-4),
    # The plain GMM rounds x@wg and x@wu to bf16 before the activation that
    # the kernel applies to fp32 sums, and both round their output: up to
    # about 4.3 x 2^-8 of the value. Both attention versions round p to
    # bf16, at different scales (the kernel's running max, the plain final
    # softmax): a sum of per-key roundings, about 2^-8 of the row's rms in
    # spread. 2^-5 leaves a margin of two over both.
    torch.bfloat16: (2.0**-5, 2.0**-5),
}

# A bf16 kernel vs the fp32 product of the same bf16 inputs (TF32 off): only
# the kernel's final rounding to bf16 separates them, at most half a unit in
# the last place (2^-8 of the value); the atol term takes fp32 summation order.
ROUNDING = (2.0**-8, 2.0**-10)


def excess(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """``max |got - want| / (rtol |want| + atol rms_row(want))`` over the
    elements; at most 1 passes. A non-finite ``got`` reads as infinity."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return math.inf
    rms = w.square().mean(dim=-1, keepdim=True).sqrt()
    err = (g - w).abs()
    ratio = err / (rtol * w.abs() + atol * rms)
    # 0 / 0 where a dead row matches exactly; x / 0 stays infinite
    ratio = torch.nan_to_num(ratio, nan=0.0, posinf=math.inf)
    return float(ratio.max())
