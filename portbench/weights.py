"""Seeded weights, made on the device, that both the program and the
reference receive.

Every leaf, and every expert of an expert leaf, draws from a generator
seeded by a hash of (seed, leaf, layer, expert), so any layer can be made
again alone: the reference rebuilds each layer when it needs it instead of
holding the model beside the program's copy. Values are N(0, std^2) drawn
in fp32 and rounded once to the served dtype (``std`` is the
configuration's ``init_std``, 0.02 as the program's own initialiser);
norm weights are ones and the router stays fp32, as the program makes
them. The model is a plain dict of sizes (``configs/<name>.json``'s
``model``).
"""

from __future__ import annotations

import hashlib

import torch

STD = 0.02


def leaf_seed(seed: int, *key) -> int:
    """A 63-bit generator seed for one leaf of one run's weights."""
    text = ":".join(str(k) for k in (int(seed), *key))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def normal(shape, seed: int, key: tuple, dtype, device, std: float = STD) -> torch.Tensor:
    """N(0, std^2) of ``shape`` in ``dtype``, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, *key))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(std).to(dtype)


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def attn_shapes(m: dict) -> dict:
    d, hd = m["d_model"], head_dim(m)
    return {"wq": (d, m["n_heads"] * hd), "wk": (d, m["n_kv_heads"] * hd),
            "wv": (d, m["n_kv_heads"] * hd), "wo": (m["n_heads"] * hd, d)}


def expert_shapes(m: dict) -> dict:
    d, f = m["d_model"], m["moe_d_ff"]
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def layer(m: dict, seed: int, l: int, dtype, device, std: float = STD) -> dict:
    """Layer ``l``'s leaves, unstacked, in the program's layout: ``ln1``,
    ``ln2``, ``attn`` {wq, wk, wv, wo}, ``moe`` {router (fp32), w_gate,
    w_up, w_down (experts on dim 0)}."""
    e = m["n_experts"]
    out = {
        "ln1": torch.ones(m["d_model"], dtype=dtype, device=device),
        "ln2": torch.ones(m["d_model"], dtype=dtype, device=device),
        "attn": {n: normal(s, seed, (n, l), dtype, device, std)
                 for n, s in attn_shapes(m).items()},
        "moe": {"router": normal((m["d_model"], e), seed, ("router", l), torch.float32,
                                 device, std)},
    }
    for n, s in expert_shapes(m).items():
        w = torch.empty((e, *s), dtype=dtype, device=device)
        for x in range(e):
            w[x] = normal(s, seed, (n, l, x), dtype, device, std)
        out["moe"][n] = w
    return out


def top(m: dict, seed: int, dtype, device, std: float = STD) -> dict:
    """``embed`` (V, d), ``lm_head`` (d, V) and ``final_norm``."""
    v, d = m["vocab_size"], m["d_model"]
    return {"embed": normal((v, d), seed, ("embed",), dtype, device, std),
            "lm_head": normal((d, v), seed, ("lm_head",), dtype, device, std),
            "final_norm": torch.ones(d, dtype=dtype, device=device)}


def model(m: dict, seed: int, dtype, device, std: float = STD) -> dict:
    """The whole model in the program's layout (layers stacked on dim 0),
    filled one layer at a time so no second copy of a stacked leaf
    exists."""
    params = top(m, seed, dtype, device, std)
    n = m["n_layers"]
    stacked = None
    for l in range(n):
        one = layer(m, seed, l, dtype, device, std)
        if stacked is None:
            stacked = _alloc(one, n)
        _put(stacked, one, l)
        del one
    params["layers"] = stacked
    return params


def _alloc(tree, n: int):
    if isinstance(tree, dict):
        return {k: _alloc(v, n) for k, v in tree.items()}
    return tree.new_empty((n, *tree.shape))


def _put(stacked, one, l: int) -> None:
    for k, v in one.items():
        if isinstance(v, dict):
            _put(stacked[k], v, l)
        else:
            stacked[k][l].copy_(v)
