"""Full forward pass of the served decoder (``attn`` blocks with a top-k
SwiGLU mixture), in fp32, over whole sequences, layer by layer.

The equations follow what the port serves for dbrx-132b and
mixtral-8x22b: RMSNorm (normalise in fp32, then scale), RoPE on the query
and key heads (rotate-half, fp32 angles), causal grouped-query attention
with an fp32 softmax, a router in fp32 whose top-k probabilities are
renormalised to sum to one, SwiGLU experts, a final RMSNorm and an untied
output head. Nothing here depends on how the program placed, replicated or
bucketed the experts: with no routed copy dropped, the layer is the plain
top-k mixture.

Each layer's weights are made again from the run's seed by
``portbench.weights`` when the layer runs, and freed after it, so the
reference needs one fp32 layer at a time. ``quant="fp8"`` computes the
lower-precision control: every product's weight rounded to float8 e4m3
with a scale per output column, and its input with a scale per row.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from portbench import weights as W

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """fp32 products in fp32 inside the block: TF32 off for cuBLAS and
    cuDNN, the settings restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(x: torch.Tensor, w: torch.Tensor, quant: str | None) -> torch.Tensor:
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, -2)
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd); pos (S,)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p: dict, x: torch.Tensor, m: dict, quant, q_block: int = 1024) -> torch.Tensor:
    """Causal GQA over one sequence x (S, d)."""
    s = x.shape[0]
    hd = W.head_dim(m)
    nh, nk = m["n_heads"], m["n_kv_heads"]
    g = nh // nk
    pos = torch.arange(s, device=x.device)
    q = rope(_mm(x, p["wq"], quant).reshape(s, nh, hd), pos, m["rope_theta"])
    k = rope(_mm(x, p["wk"], quant).reshape(s, nk, hd), pos, m["rope_theta"])
    v = _mm(x, p["wv"], quant).reshape(s, nk, hd)
    qg = q.reshape(s, nk, g, hd)
    out = torch.empty((s, nk, g, hd), dtype=torch.float32, device=x.device)
    for a in range(0, s, q_block):
        b = min(s, a + q_block)
        sc = torch.einsum("skgd,tkd->kgst", qg[a:b], k[:b]) / math.sqrt(hd)
        keys, queries = torch.arange(b, device=x.device), torch.arange(a, b, device=x.device)
        mask = keys[None, :] <= queries[:, None]
        sc = sc.masked_fill(~mask, float("-inf"))
        out[a:b] = torch.einsum("kgst,tkd->skgd", torch.softmax(sc, dim=-1), v[:b])
    return _mm(out.reshape(s, nh * hd), p["wo"], quant)


def moe(p: dict, x: torch.Tensor, m: dict, quant) -> torch.Tensor:
    """The top-k SwiGLU mixture over rows x (N, d)."""
    ids, w = route(x, p["router"], m["experts_per_token"])
    out = torch.zeros_like(x)
    for e in range(m["n_experts"]):
        rows, slot = torch.nonzero(ids == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(_mm(xe, p["w_gate"][e], quant)) * _mm(xe, p["w_up"][e], quant)
        out.index_add_(0, rows, _mm(h, p["w_down"][e], quant) * w[rows, slot][:, None])
    return out


def _fp32(tree):
    if isinstance(tree, dict):
        return {k: _fp32(v) for k, v in tree.items()}
    return tree.float()


@torch.no_grad()
def logits_at(m: dict, seed: int, dtype, device, sequences: list, reads: list,
              quant: str | None = None, std: float = W.STD) -> list[torch.Tensor]:
    """fp32 logits ``(len(reads[i]), V)`` at positions ``reads[i]`` of each
    token sequence ``sequences[i]`` (int arrays), with the weights of
    ``seed`` (drawn at ``std``) as served in ``dtype``, upcast."""
    top = W.top(m, seed, dtype, device, std)
    toks = [torch.as_tensor(s, dtype=torch.long, device=device) for s in sequences]
    lens = [len(t) for t in toks]
    starts = [sum(lens[:i]) for i in range(len(lens))]
    x = top["embed"][torch.cat(toks)].float()
    for l in range(m["n_layers"]):
        p = _fp32(W.layer(m, seed, l, dtype, device, std))
        z = rms_norm(x, p["ln1"], m["norm_eps"])
        x = x + torch.cat([attention(p["attn"], z[a:a + n], m, quant)
                           for a, n in zip(starts, lens)])
        x = x + moe(p["moe"], rms_norm(x, p["ln2"], m["norm_eps"]), m, quant)
        del p, z
    out = []
    norm, head = top["final_norm"].float(), top["lm_head"].float()
    for a, r in zip(starts, reads):
        rows = rms_norm(x[a + torch.as_tensor(r, dtype=torch.long, device=device)],
                        norm, m["norm_eps"])
        out.append(_mm(rows, head, quant))
    return out


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """Top-k routing in fp32: (expert ids, renormalised weights)."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    w, ids = torch.topk(probs, k, dim=-1)
    return ids, w / w.sum(dim=-1, keepdim=True)
