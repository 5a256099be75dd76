"""State-space / recurrent blocks: Mamba2 (zamba2) and xLSTM (mLSTM + sLSTM)
(PyTorch port of ``repro.models.ssm``).

Every block has one entry point, ``*_apply(p, x, cfg, state)``: the full
sequence from ``state`` (zeros when None), returning ``(y, final_state)``,
so a prefill seeds the decode state and a decode step is the same call on
one token (``mamba_decode``). States are fp32 whatever the model dtype.

The reference runs the time recurrences as ``lax.scan``s, outside any
Pallas kernel; the port runs them as plain Python loops over time, on the
card too (one step's handful of launches per token and layer: a prefill is
launch-bound, as the reference's scan is a loop).

Dtypes follow the reference's promotion: the fp32 conv state decides the
dtype of the causal conv (so Mamba's x/B/C come out fp32), the scan and
the gates compute in fp32, and each block's output is cast back to the
input's dtype before its norm and out-projection.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mm, normal_init

CONV_W = 4  # causal conv width (Mamba2)
FP32 = torch.float32  # the states' dtype, whatever the model's


def _out_norm(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The blocks' RMS norm before the out-projection (eps 1e-5): variance
    in fp32, the scale cast to ``y``'s dtype."""
    var = y.float().square().mean(dim=-1, keepdim=True)
    return (y * torch.rsqrt(var + 1e-5).to(y.dtype)) * w


# ---------------------------------------------------------------------------
# Mamba2 (simplified SSD: scalar decay per head, shared B/C group)
# ---------------------------------------------------------------------------

def mamba_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    d_inner = 2 * cfg.d_model
    head = 64 if d_inner % 64 == 0 else d_inner
    n_heads = d_inner // head
    return d_inner, head, n_heads, cfg.ssm_state


def mamba_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device="cpu") -> dict:
    d = cfg.d_model
    d_inner, _, n_heads, n = mamba_dims(cfg)

    def w(shape):
        return normal_init(gen, shape, dtype=dtype, device=device)

    return {
        "w_z": w((d, d_inner)),
        "w_xbc": w((d, d_inner + 2 * n)),
        "w_dt": w((d, n_heads)),
        "conv_w": w((CONV_W, d_inner + 2 * n)),
        "conv_b": torch.zeros(d_inner + 2 * n, dtype=dtype, device=device),
        "a_log": torch.zeros(n_heads, dtype=torch.float32, device=device),
        "dt_bias": torch.zeros(n_heads, dtype=torch.float32, device=device),
        "d_skip": torch.ones(n_heads, dtype=torch.float32, device=device),
        "w_out": w((d_inner, d)),
        "norm_w": torch.ones(d_inner, dtype=dtype, device=device),
    }


def _conv_causal(p: dict, xbc: torch.Tensor, conv_state: torch.Tensor):
    """Depthwise causal conv over time from ``conv_state`` (the last
    ``CONV_W - 1`` inputs); returns silu(out) and the new state. JAX's
    concatenate promotes, so the fp32 state decides the dtype."""
    dt = torch.promote_types(conv_state.dtype, xbc.dtype)
    full = torch.cat([conv_state.to(dt), xbc.to(dt)], dim=1)
    t = xbc.shape[1]
    out = sum(full[:, i : i + t] * p["conv_w"][i] for i in range(CONV_W)) + p["conv_b"]
    return F.silu(out), full[:, -(CONV_W - 1):]


def _ssm_scan(p: dict, xh, b, c, dt, cfg: ModelConfig, h: torch.Tensor):
    """h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T ; y_t = h_t C_t + D x_t,
    in fp32, stepping over time from ``h`` (B, H, hd, N)."""
    _, head, n_heads, _ = mamba_dims(cfg)
    bt, t = xh.shape[0], xh.shape[1]
    a = -torch.exp(p["a_log"])                                          # (H,)
    # jax.nn.softplus is logaddexp(x, 0)
    dt = torch.logaddexp(dt.float() + p["dt_bias"], torch.zeros((), device=dt.device))
    xh = xh.reshape(bt, t, n_heads, head).float()
    b, c = b.float(), c.float()
    ys = []
    for i in range(t):
        dt_i = dt[:, i]                                                 # (B, H)
        decay = torch.exp(a * dt_i)[..., None, None]                   # (B, H, 1, 1)
        upd = (dt_i[..., None] * xh[:, i])[..., None] * b[:, i, None, None, :]
        h = decay * h + upd                                             # (B, H, hd, N)
        ys.append(torch.einsum("bhdn,bn->bhd", h, c[:, i]))
    y = torch.stack(ys, dim=1) + p["d_skip"][:, None] * xh              # (B, T, H, hd)
    return y.reshape(bt, t, -1), h


def mamba_state_init(cfg: ModelConfig, batch: int, device="cpu") -> dict:
    d_inner, head, n_heads, n = mamba_dims(cfg)
    return {
        "conv": torch.zeros((batch, CONV_W - 1, d_inner + 2 * n), dtype=FP32, device=device),
        "ssm": torch.zeros((batch, n_heads, head, n), dtype=FP32, device=device),
    }


def mamba_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, state: dict | None = None):
    d_inner, _, _, n = mamba_dims(cfg)
    if state is None:
        state = mamba_state_init(cfg, x.shape[0], x.device)
    z, xbc, dt = mm(x, p["w_z"]), mm(x, p["w_xbc"]), mm(x, p["w_dt"])
    xbc, conv_state = _conv_causal(p, xbc, state["conv"])
    xh, b, c = torch.split(xbc, [d_inner, n, n], dim=-1)
    y, h_last = _ssm_scan(p, xh, b, c, dt, cfg, state["ssm"])
    y = _out_norm(y.to(x.dtype) * F.silu(z), p["norm_w"])
    return mm(y, p["w_out"]), {"conv": conv_state, "ssm": h_last}


def mamba_decode(p: dict, x1: torch.Tensor, state: dict, cfg: ModelConfig):
    """x1: (B, 1, d), one token; an O(1) state update."""
    return mamba_apply(p, x1, cfg, state)


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory) blocks
# ---------------------------------------------------------------------------

def xlstm_dims(cfg: ModelConfig) -> tuple[int, int]:
    return cfg.n_heads, cfg.d_model // cfg.n_heads


def mlstm_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device="cpu") -> dict:
    d = cfg.d_model
    h, _ = xlstm_dims(cfg)
    return {
        "w_qkv": normal_init(gen, (d, 3 * d), dtype=dtype, device=device),
        "w_gates": normal_init(gen, (d, 2 * h), scale=0.01, dtype=dtype, device=device),
        "b_gates": torch.zeros(2 * h, dtype=torch.float32, device=device),
        "w_out": normal_init(gen, (d, d), dtype=dtype, device=device),
        "norm_w": torch.ones(d, dtype=dtype, device=device),
    }


def mlstm_state_init(cfg: ModelConfig, batch: int, device="cpu") -> dict:
    h, hd = xlstm_dims(cfg)
    return {
        "C": torch.zeros((batch, h, hd, hd), dtype=FP32, device=device),
        "n": torch.zeros((batch, h, hd), dtype=FP32, device=device),
        "m": torch.full((batch, h), -1e30, dtype=FP32, device=device),
    }


def mlstm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, state: dict | None = None):
    bsz, t, d = x.shape
    h, hd = xlstm_dims(cfg)
    if state is None:
        state = mlstm_state_init(cfg, bsz, x.device)
    qkv = mm(x, p["w_qkv"]).reshape(bsz, t, 3, h, hd)
    q, k, v = qkv[:, :, 0].float(), qkv[:, :, 1].float(), qkv[:, :, 2].float()
    gates = mm(x, p["w_gates"]).float() + p["b_gates"]
    log_i, log_f = gates[..., :h], F.logsigmoid(gates[..., h:])
    c_s, n_s, m_s = state["C"], state["n"], state["m"]
    scale = math.sqrt(hd)
    ys = []
    for i in range(t):
        li, lf = log_i[:, i], log_f[:, i]                               # (B, H)
        m_new = torch.maximum(lf + m_s, li)
        f_t = torch.exp(lf + m_s - m_new)[..., None]
        i_t = torch.exp(li - m_new)[..., None]
        k_t, v_t = k[:, i], v[:, i]                                     # (B, H, hd)
        c_s = f_t[..., None] * c_s + i_t[..., None] * (v_t[..., :, None] * k_t[..., None, :])
        n_s = f_t * n_s + i_t * k_t
        q_t = q[:, i] / scale
        num = torch.einsum("bhvk,bhk->bhv", c_s, q_t)
        den = torch.einsum("bhk,bhk->bh", n_s, q_t).abs()
        ys.append(num / torch.maximum(den, torch.exp(-m_new))[..., None])
        m_s = m_new
    y = torch.stack(ys, dim=1).reshape(bsz, t, d).to(x.dtype)
    return mm(_out_norm(y, p["norm_w"]), p["w_out"]), {"C": c_s, "n": n_s, "m": m_s}


def slstm_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device="cpu") -> dict:
    d = cfg.d_model
    h, hd = xlstm_dims(cfg)
    return {
        "w_in": normal_init(gen, (d, 4 * d), dtype=dtype, device=device),     # z,i,f,o
        "r_block": normal_init(gen, (h, hd, 4 * hd), scale=0.01, dtype=dtype,
                               device=device),
        "b_in": torch.zeros(4 * d, dtype=torch.float32, device=device),
        "w_out": normal_init(gen, (d, d), dtype=dtype, device=device),
        "norm_w": torch.ones(d, dtype=dtype, device=device),
    }


def slstm_state_init(cfg: ModelConfig, batch: int, device="cpu") -> dict:
    h, hd = xlstm_dims(cfg)
    shape = (batch, h, hd)
    return {
        "c": torch.zeros(shape, dtype=FP32, device=device),
        "n": torch.ones(shape, dtype=FP32, device=device),
        "m": torch.zeros(shape, dtype=FP32, device=device),
        "h": torch.zeros(shape, dtype=FP32, device=device),
    }


def slstm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, state: dict | None = None):
    bsz, t, d = x.shape
    h, hd = xlstm_dims(cfg)
    if state is None:
        state = slstm_state_init(cfg, bsz, x.device)
    wx = (mm(x, p["w_in"]).float() + p["b_in"]).reshape(bsz, t, h, 4 * hd)
    r = p["r_block"].float()
    c_s, n_s, m_s, h_s = state["c"], state["n"], state["m"], state["h"]
    ys = []
    for i in range(t):
        rec = torch.einsum("bhk,hke->bhe", h_s, r)
        z, ig, fg, o = torch.split(wx[:, i] + rec, hd, dim=-1)         # (B, H, hd) each
        li, lf = ig, F.logsigmoid(fg)
        m_new = torch.maximum(lf + m_s, li)
        i_t = torch.exp(li - m_new)
        f_t = torch.exp(lf + m_s - m_new)
        c_s = f_t * c_s + i_t * torch.tanh(z)
        n_s = f_t * n_s + i_t
        h_s = torch.sigmoid(o) * c_s / torch.clamp(n_s, min=1e-6)
        m_s = m_new
        ys.append(h_s)
    y = torch.stack(ys, dim=1).reshape(bsz, t, d).to(x.dtype)
    return mm(_out_norm(y, p["norm_w"]), p["w_out"]), {"c": c_s, "n": n_s, "m": m_s, "h": h_s}
