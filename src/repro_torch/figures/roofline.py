"""Three-term roofline per (arch x shape x mesh) cell from the port's dry
run (``repro_torch.launch.dryrun``, records under ``results/torch/dryrun``);
a port of the reference's ``benchmarks/roofline.py``.

Terms (seconds, per step, per rank):
  compute    = flops / PEAK_FLOPS
  memory     = bytes_accessed / HBM_BW
  collective = collective bytes / LINK_BW

The record is rank 0's program, so its values are already per device.
The port runs every layer eagerly, so the dry run writes no layer probes
and ``_extrapolate`` returns the full values (it still reads probes,
as the reference's records carry them).

The three constants are datasheet figures for one NVIDIA H100 80GB HBM3
(SXM) at its 700 W limit, not measurements; every time this module gives
is model output at those constants. ``MODEL_FLOPS`` uses 6*N*D for
training and 2*N_active*D for inference; the roofline fraction is the
ideal time at the attainable rate over max(term). ``_useful_bytes`` and the
suggestions are the reference's, unchanged (its parameter traffic assumes
the reference's 16-way tensor parallelism, which the port does not have
yet: ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import glob
import json
import os

from repro_torch.configs import SHAPES, get_config

# NVIDIA H100 SXM datasheet: dense bf16 tensor-core peak.
PEAK_FLOPS = 989e12      # FLOP/s / GPU
# NVIDIA H100 SXM datasheet: HBM3 bandwidth.
HBM_BW = 3.35e12         # bytes/s / GPU
# One 400 Gb/s NDR InfiniBand port a GPU (ConnectX-7): the model axis of
# 16 spans two 8-GPU NVLink nodes, so its collectives cross this link.
# Within a node NVLink 4 gives 450 GB/s a direction (the intra-node bound).
LINK_BW = 50e9           # bytes/s / GPU

DRYRUN_DIR = os.path.join("results", "torch", "dryrun")
ROOFLINE_MD = os.path.join("results", "torch", "roofline.md")

SUGGEST = {
    "compute": "raise MXU utilization: fuse ops/pack GQA heads; reduce "
               "replicated compute on the model axis",
    "memory": "cut HBM traffic: fuse attention (flash), avoid materialized "
              "score/hidden tensors, bf16 end-to-end",
    "collective": "re-place collectives: ER tile locality, fewer/larger "
                  "fused all-reduces, overlap with compute",
}


def _extrapolate(rec: dict, key: str) -> float:
    full = rec.get(key) or 0.0
    p1, p2 = rec.get("probe1"), rec.get("probe2")
    units = rec.get("units", 1)
    if not p1 or not p2:
        return float(full)

    def get(p):
        if key == "collective_total":
            return (p.get("collectives") or {}).get("total", 0.0)
        return p.get(key) or 0.0

    per_unit = max(get(p2) - get(p1), 0.0)
    return float(get(p1) + (units - 1) * per_unit)


def _model_flops(arch: str, shape_name: str) -> float:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token/seq


def _useful_bytes(arch: str, shape_name: str, n_dev: int) -> float:
    """Analytic floor on per-device HBM traffic for one step (bf16 params/
    activations, fp32 optimizer moments). This anchors the roofline's
    operational intensity — the HLO ``bytes accessed`` from the CPU-lowered
    module overestimates TPU traffic (no TPU-style fusion), so the
    *fraction* is computed against this floor while the raw HLO terms stay
    in the table for hillclimbing."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    n_total = cfg.param_count()
    d = cfg.d_model
    model_shard = 16 if cfg.block_pattern != "xlstm" else 1

    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        # params: bf16 fwd read + bwd read, fp32 m/v read+write, param write
        param_traffic = n_total * (2 + 2 + 16 + 4) / model_shard
        act_traffic = 3 * cfg.n_layers * tokens * d * 2 / n_dev
        return param_traffic + act_traffic
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        param_traffic = 2 * n_active / model_shard
        act_traffic = 2 * cfg.n_layers * tokens * d * 2 / n_dev
        return param_traffic + act_traffic
    # decode: active params + KV/state cache stream through once
    kv_len = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
    if cfg.block_pattern in ("zamba", "xlstm"):
        kv_len = 1  # O(1) recurrent state
    kv_layers = (
        cfg.n_layers // max(cfg.attn_every, 1)
        if cfg.block_pattern == "zamba"
        else cfg.n_layers
    )
    cache = (
        2 * kv_layers * shape.global_batch * kv_len
        * cfg.n_kv_heads * cfg.head_dim_ * 2
    )
    return 2 * n_active / model_shard + cache / n_dev


def analyze_record(rec: dict) -> dict | None:
    if rec.get("status") != "OK":
        return None
    n_dev = rec["n_devices"]
    flops_dev = _extrapolate(rec, "flops")
    bytes_dev = _extrapolate(rec, "bytes_accessed")
    coll_rec = dict(rec.get("collectives") or {})
    # extrapolate total collective bytes through the probes
    rec2 = dict(rec)
    rec2["collective_total"] = coll_rec.get("total", 0.0)
    coll_dev = _extrapolate(
        {**rec2, "probe1": rec.get("probe1"), "probe2": rec.get("probe2")},
        "collective_total",
    )
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_collective = coll_dev / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_collective}
    dominant = max(terms, key=terms.get)
    t_step = max(terms.values())
    model_flops = _model_flops(rec["arch"], rec["shape"])
    hlo_total = flops_dev * n_dev
    # Classic roofline: achieved useful FLOP/s per chip vs the attainable
    # rate at the workload's operational intensity (useful FLOPs / analytic
    # minimum HBM bytes) — bandwidth-bound cells get a fair ceiling.
    useful_bytes = _useful_bytes(rec["arch"], rec["shape"], n_dev)
    oi = model_flops / n_dev / max(useful_bytes, 1.0)
    attainable = min(PEAK_FLOPS, oi * HBM_BW)
    achieved = model_flops / n_dev / t_step if t_step else 0.0
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "t_step_s": t_step,
        "model_flops": model_flops,
        "hlo_flops_total": hlo_total,
        "useful_ratio": model_flops / hlo_total if hlo_total else 0.0,
        "oi": oi,
        "roofline_fraction": achieved / attainable if attainable else 0.0,
        "suggestion": SUGGEST[dominant],
        "hbm_per_device_gb": (
            rec.get("argument_size_in_bytes", 0) + rec.get("temp_size_in_bytes", 0)
        )
        / 1e9,
    }


def load_all(dirname: str = DRYRUN_DIR) -> list[dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        a = analyze_record(rec)
        if a:
            out.append(a)
        elif rec.get("status", "").startswith("SKIP"):
            out.append(
                {
                    "arch": rec["arch"],
                    "shape": rec["shape"],
                    "mesh": rec["mesh"],
                    "dominant": "SKIP",
                    "status": rec["status"],
                }
            )
    return out


def write_markdown(rows: list[dict], path: str = ROOFLINE_MD):
    lines = [
        "| arch | shape | mesh | compute (ms) | memory (ms) | collective (ms) "
        "| dominant | useful FLOP ratio | roofline frac | HBM/dev (GB) |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["dominant"] == "SKIP":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | "
                f"{r['status']} | — | — | — |"
            )
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s'] * 1e3:.2f} | {r['t_memory_s'] * 1e3:.2f} "
            f"| {r['t_collective_s'] * 1e3:.2f} | {r['dominant']} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.2f} "
            f"| {r['hbm_per_device_gb']:.1f} |"
        )
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def run() -> list[dict]:
    """The figure runner's rows: one per ``OK`` record of the dry run
    (none when it has not run); the table goes to ``ROOFLINE_MD``."""
    rows = load_all()
    if rows:
        write_markdown(rows)
    out = []
    for r in rows:
        if r["dominant"] == "SKIP":
            continue
        out.append(
            {
                "name": f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}",
                "us_per_call": round(r["t_step_s"] * 1e6, 1),
                "derived": (
                    f"dominant={r['dominant']};frac={r['roofline_fraction']:.2f};"
                    f"useful={r['useful_ratio']:.2f}"
                ),
            }
        )
    return out
