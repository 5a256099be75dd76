"""The table of peaks and the operations and bytes that the served work
needs, computed from shapes and counts alone.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates: 989 TFLOP/s
in bf16, 3.35 TB/s of HBM3. They assume the card's full 700 W limit; the
run records the card's limit beside every number.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def layer_params(m: dict) -> int:
    """Parameters one token meets in a layer: attention projections, the
    router and its top-k experts."""
    d, hd = m["d_model"], m.get("head_dim") or m["d_model"] // m["n_heads"]
    attn = d * hd * (2 * m["n_heads"] + 2 * m["n_kv_heads"])
    return attn + d * m["n_experts"] + m["experts_per_token"] * 3 * d * m["moe_d_ff"]


def token_flops(m: dict, context: int) -> float:
    """Model FLOPs of one token at absolute context length ``context`` (it
    attends to ``context`` keys, itself included): 2 per parameter it
    meets in every layer, plus attention's score and value products."""
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    attn = 4 * m["n_heads"] * hd * context
    return m["n_layers"] * (2 * layer_params(m) + attn)


def logits_flops(m: dict) -> float:
    """The output head for one row of logits."""
    return 2 * m["d_model"] * m["vocab_size"]


def prefill_flops(m: dict, length: int) -> float:
    """A prompt of ``length`` real tokens and its one row of logits
    (sum of contexts 1..length)."""
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    attn = 4 * m["n_heads"] * hd * length * (length + 1) / 2
    return m["n_layers"] * (2 * layer_params(m) * length + attn) + logits_flops(m)


def decode_flops(m: dict, context: int) -> float:
    """One decoded token at context ``context`` and its row of logits."""
    return token_flops(m, context) + logits_flops(m)


def moe_call(m: dict, rows_per_expert, dtype: str) -> tuple[float, float]:
    """(bytes, FLOPs) one MoE layer call needs: every expert that received
    rows has its three weights read once, every routed row is read and
    written once, and each routed row costs 2 x 3 x d x moe_d_ff FLOPs.
    Bucket padding, replicas and rows of empty slots are not work."""
    d, f = m["d_model"], m["moe_d_ff"]
    b = DTYPE_BYTES[dtype]
    rows = sum(int(r) for r in rows_per_expert)
    hit = sum(1 for r in rows_per_expert if r > 0)
    nbytes = hit * 3 * d * f * b + rows * 2 * d * b
    return float(nbytes), float(rows * 6 * d * f)


def least_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take: the larger of bytes over peak
    bandwidth and FLOPs over the dtype's peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
