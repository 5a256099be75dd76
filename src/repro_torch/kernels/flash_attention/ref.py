"""Plain PyTorch causal (optionally windowed) GQA attention: the oracle of
the flash-attention kernel and the path CPU tensors take."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def mha(
    q: torch.Tensor,       # (B, S, H, hd)
    k: torch.Tensor,       # (B, T, K, hd)
    v: torch.Tensor,       # (B, T, K, hd)
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Queries cover the tail of the key range (query i sits at absolute
    position i + T - S); query head h reads KV head h // (H / K). Scores
    and softmax in fp32, p cast to v.dtype before the PV product."""
    b, s, nh, hd = q.shape
    t, nk = k.shape[1], k.shape[2]
    g = nh // nk
    qg = q.reshape(b, s, nk, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / math.sqrt(hd)
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None] + (t - s)
        kpos = torch.arange(t, device=q.device)[None, :]
        m = kpos <= qpos
        if window:
            m &= kpos > qpos - window
        scores = torch.where(m, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", p, v)
    return o.reshape(b, s, nh, hd)
