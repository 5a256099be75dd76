"""Shared layer primitives: norms, RoPE, SwiGLU MLP, initializers.

Casts follow ``repro.models.layers``: RMSNorm normalises in fp32, casts
back, then multiplies by ``w``; RoPE is computed in fp32. Products go
through :func:`mm`, which promotes mixed float operands as JAX does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def normal_init(gen: torch.Generator, shape, scale: float = 0.02,
                dtype=torch.float32, device="cpu") -> torch.Tensor:
    """N(0, scale^2) weights drawn from ``gen`` (a generator on ``device``),
    in ``dtype``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w


def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)                 # (hd/2,)
    angles = positions[..., None].float() * freqs                    # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                            # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's promotion of mixed float operands: both operands
    in the wider dtype (torch's ``@`` refuses mixed dtypes). The reference
    relies on it where fp32 operands meet bf16 weights: its encoder takes
    the frontend embeds uncast, and its recurrences carry fp32 states.
    Same-dtype operands, every path the card serves, take the plain
    product."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32,
             device="cpu") -> dict:
    return {
        "w_gate": normal_init(gen, (d_model, d_ff), dtype=dtype, device=device),
        "w_up": normal_init(gen, (d_model, d_ff), dtype=dtype, device=device),
        "w_down": normal_init(gen, (d_ff, d_model), dtype=dtype, device=device),
    }


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = mm(x, p["w_gate"])
    u = mm(x, p["w_up"])
    return mm(F.silu(h) * u, p["w_down"])
