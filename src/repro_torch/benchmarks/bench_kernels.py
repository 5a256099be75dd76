"""Kernel-path benchmark of the port (PyTorch port of the reference's
``benchmarks/bench_kernels.py``): dispatch + expert FFN + combine along
six paths, dense vs paged decode attention, stepped migration, the
chunked-admission prefill lane and the chunked EP dispatch, each through
the port's hand-written CUDA kernels on the card.

The six FFN paths end in the per-token weighted combine, so their outputs
compare directly (the reference's names, the port's calls):

* ``einsum_padded_dispatch`` -- ``bucket_dispatch`` + the plain padded FFN
  (``kernels/gmm/ref.py::expert_ffn``) + ``bucket_combine``;
* ``gmm_padded_dispatch`` -- ``bucket_dispatch`` + ``gmm_dual_act`` +
  ``gmm`` (every capacity row computed);
* ``gmm_ragged_padded_dispatch`` -- ``bucket_dispatch`` + the count-aware
  pair (``gmm_dual_act_ragged`` + ``gmm_ragged``);
* ``gmm_gather_fused_dispatch`` -- ``dispatch_metadata`` +
  ``gmm_dual_act_gather`` (rows read in place) + ``gmm_ragged``;
* ``gmm_compact_fused_combine`` -- ``gmm_dual_act_gather`` +
  ``gmm_scatter`` + ``combine_from_rows``;
* ``gmm_fused_ffn_combine`` -- ``gmm_fused_ffn`` (the three products in
  one kernel) + ``combine_from_rows``.

The deterministic columns (shape metadata, FLOP and HBM-byte accounting,
the exposed-communication schedule) are the reference's numpy, copied
unchanged: they model the Pallas kernels' tiles (``BM``, the ceil-tile
convention) and ``--check BENCH_kernels.json`` recomputes them against the
committed file, read only. Beside them each FFN and EP-chunk path carries
the port's own columns for its CUDA tiles under ``port_*`` keys
(:func:`port_ffn_columns`). Every timed row records ``wall_ms`` (best of N,
host clock around a synchronised call), ``event_ms`` (best of N, CUDA
events; ``None`` on the CPU) and ``launches``: the kernels one call of the
path launched, from the wrappers' launch counters. Parity is checked
before any timing; a failure exits non-zero.

The bench shapes are the reference's (d 16-128, fp32): on an H100 their
times are launch-bound, not bandwidth- or compute-bound.

Usage::

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_kernels [--out F]
    PYTHONPATH=src python -m repro_torch.benchmarks.bench_kernels --smoke
    PYTHONPATH=src python -m repro_torch.benchmarks.bench_kernels \\
        --check BENCH_kernels.json

``--device cuda`` (default) runs the kernels and raises without a card;
``--device cpu`` runs their plain versions (wrappers take CPU tensors to
them), for the tests. The default ``--out`` is
``results/torch/bench_kernels.json``; the bench never writes the
reference's ``BENCH_kernels.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import platform
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

from repro_torch.configs import get_config, smoke
from repro_torch.device import resolve_device

SHAPES = [
    ("smoke_4x64", 4, 64, 64, 128, False),
    ("balanced_8x128", 8, 128, 128, 256, True),
    ("ep_16x128", 16, 128, 128, 512, False),
    ("skewed_32x64", 32, 64, 128, 256, False),
]
SMOKE_SHAPES = [("smoke_4x16", 4, 16, 16, 32, False)]

BM = 128  # row-tile the ragged kernels mask at (see kernels/gmm/ragged.py)

# Decode cells: (name, B, max_seq, lengths, K, H, hd, page_size). Dense
# flash-decode streams the whole (B, max_seq) cache and masks; paged decode
# walks only each request's live pages — `kv_hbm_mb` is the bandwidth story.
DECODE_SHAPES = [
    # hd/page multiples of 128 so the cells stay compiled-eligible on TPU
    # (can_flash_decode / can_flash_decode_paged gates).
    ("decode_short_balanced", 4, 1024, [256, 256, 256, 256], 2, 8, 128, 128),
    ("decode_long_balanced", 4, 1024, [1024, 1024, 1024, 1024], 2, 8, 128, 128),
    ("decode_ragged", 4, 2048, [128, 256, 512, 1024], 2, 8, 128, 128),
]
# The reference's smoke cell has head dim 16; the port's decode kernels
# take head dims that are multiples of 32 (``can_flash_decode``), so the
# port's smoke cell (not ``--check``-gated) runs at 32.
PORT_MIN_HEAD_DIM = 32
DECODE_SMOKE_SHAPES = [("decode_smoke", 2, 64, [20, 48], 2, 4, PORT_MIN_HEAD_DIM, 16)]

# Live stepped migration cells: (name, L, n_slots, D, F, n_slices, n_tok).
# One cell = one in-flight expert migration sliced over n_slices decode
# ticks (the MigrationDriver's per-tick _copy_row_slice on all three slot
# tensors) riding a decode-step-sized expert FFN. The accounting columns
# (slice/expert bytes, tick counts) are deterministic and CI-gated; the
# wall columns — including migration_exposed_ms, the per-tick cost the
# decode step cannot hide = (step + slice) − step — are not.
MIGRATION_SHAPES = [
    ("mig_smoke_4x64", 2, 4, 64, 128, 4, 64),
    ("mig_ep_8x128", 4, 8, 128, 256, 4, 128),
    ("mig_finegrain_8x128", 4, 8, 128, 256, 8, 128),
]
MIGRATION_SMOKE_SHAPES = [("mig_smoke", 2, 4, 16, 32, 4, 16)]

# Chunked-admission interleave cells: (name, model, B, chunk, prompt_len,
# page_size, max_seq). One cell = the fused two-lane decode step
# (runtime/serve.py with ServeConfig(prefill_chunk=C)) admitting a
# prompt_len prompt one C-token chunk per tick while a B-slot decode batch
# rides the same program. The deterministic columns — `ttft_ticks` (chunk
# ticks to the first token) and `chunk_hbm_mb` (KV bytes the prefill lane
# moves over the whole admission) — are CI-gated; the wall columns,
# including chunk_exposed_ms = wall(decode + live chunk) − wall(decode +
# no-op chunk), are not.
PREFILL_SHAPES = [
    ("prefill_interleave_c8", "llama3.2-1b", 3, 8, 40, 8, 64),
    ("prefill_interleave_c16", "llama3.2-1b", 3, 16, 48, 8, 64),
]
PREFILL_SMOKE_SHAPES = [("prefill_smoke", "llama3.2-1b", 2, 8, 16, 8, 32)]

# Chunked EP dispatch cells: (name, EP, SPD, CAP, D, F, chunk_counts,
# balanced). One cell = one EP step's expert hot path — EP ranks x SPD
# expert groups per rank at capacity CAP — run single-shot (ep_chunks=1)
# and chunked (each K in chunk_counts): the per-chunk fused row-FFN over
# K contiguous slices of the rank-compacted row layout, exactly the
# per-chunk `expert_ffn_from_rows` calls the pipelined
# `ep_moe_shardmap` fused branch issues between its all_to_all legs.
# Deterministic gated columns per K: per-chunk dispatch/combine HBM
# bytes (same ceil-tile convention as the FFN cells — per-chunk offsets
# keep BOTH legs compact, so the K lists sum to the single-shot
# numbers), per-chunk exchange wire bytes (the statically shaped
# all_to_all buffer splits exactly K ways), and `exposed_comm_ms` — the
# analytic pipeline schedule's wall(step) − wall(overlapped ideal):
# with D_i/B_i the dispatch/combine leg times and C_i the chunk-i
# compute time, chunk i's compute slot must cover chunk i−1's combine
# and chunk i+1's dispatch, so
#   exposed(K) = D_0 + B_{K-1} + sum_i max(0, B_{i-1} + D_{i+1} - C_i)
# (absent terms at the boundaries). K=1 degenerates to D + B — the two
# synchronous walls — and every K>1 is strictly below it (asserted).
# The model uses the fixed EP_WIRE_GBPS / EP_MODEL_TFLOPS constants so
# the column is seed-deterministic and --check-gated; `wall_ms` per K
# is measured (interpret semantics off-TPU) and NOT gated.
EP_CHUNK_SHAPES = [
    ("epchunk_balanced_8x64", 4, 2, 64, 64, 128, (1, 2), True),
    ("epchunk_skewed_16x64", 4, 4, 64, 128, 256, (1, 2, 4), False),
    ("epchunk_skewed_32x32", 8, 4, 32, 128, 256, (1, 2, 4), False),
]
EP_CHUNK_SMOKE_SHAPES = [("epchunk_smoke", 2, 2, 16, 16, 32, (1, 2), False)]

# Fixed analytic-model constants for the exposed-comm schedule: a
# mid-range per-device all_to_all leg bandwidth and MXU throughput.
# Deliberately NOT measured — the exposed_comm_ms column is a
# deterministic schedule property (what the pipeline hides at a given
# comm:compute ratio), not a backend benchmark; changing these changes
# the committed baseline.
EP_WIRE_GBPS = 40.0
EP_MODEL_TFLOPS = 20.0


def _tile(n: int, pref: int) -> int:
    """The largest divisor of ``n`` that is at most ``pref`` (the Pallas
    kernels' row tile, ``repro/kernels/gmm/gmm.py::_tile``)."""
    t = min(pref, n)
    while n % t:
        t -= 1
    return t


def _skewed_counts(g: int, c: int, seed: int) -> np.ndarray:
    """Zipf-ish routing skew: a few hot experts near capacity, a long tail
    (incl. empties) — the fig. 6 imbalance regime."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(1.5, size=g).astype(np.float64)
    counts = np.floor(c * raw / raw.max()).astype(np.int64)
    counts[rng.permutation(g)[: max(g // 8, 1)]] = 0  # idle slots
    return np.clip(counts, 0, c)


def _ids_from_counts(counts: np.ndarray) -> np.ndarray:
    """A token stream whose per-bucket histogram is exactly ``counts``,
    in a seeded random order so dispatch never sees pre-sorted input."""
    ids = np.concatenate([np.full(c, g, np.int32) for g, c in enumerate(counts)])
    rng = np.random.default_rng(int(counts.sum()))
    return rng.permutation(ids)


def ffn_cell_accounting(name, g, c, d, f, balanced):
    """Deterministic columns of one FFN shape cell — seeded routing draw,
    FLOP model, and per-leg HBM-byte model. No kernels run; this is what
    ``--check`` recomputes against the committed baseline."""
    counts = (
        np.full(g, c, np.int64) if balanced else _skewed_counts(g, c, seed=g * c)
    )
    n_tok = int(counts.sum())
    flop_per_row = 6 * d * f  # 3 matmuls, 2 flop/MAC
    padded_gf = g * c * flop_per_row / 1e9
    achieved_gf = n_tok * flop_per_row / 1e9
    # The kernels' actual row tile: the largest divisor of the capacity
    # <= BM (min(BM, c) agrees only when that happens to divide c).
    bm = _tile(c, BM)
    ragged_rows = sum(math.ceil(cnt / bm) * bm for cnt in counts)
    ragged_exec_gf = ragged_rows * flop_per_row / 1e9
    row_bytes = d * np.dtype(np.float32).itemsize
    hidden_row_bytes = f * np.dtype(np.float32).itemsize
    # Padded legs: scatter out + read in of the full (G, C, ·) buffer.
    padded_leg_mb = 2 * g * c * row_bytes / 1e6
    # Fused legs are half row-granular (XLA scatter/gather of the
    # compacted rows), half tile-granular (the kernel's dynamic-offset
    # DMAs move whole (bm, ·) tiles, padding included — same ceil-tile
    # convention as exec_gflop): dispatch writes n_tok rows and the
    # gather prologue reads ragged_rows; the scatter epilogue writes
    # ragged_rows and the combine gathers n_tok.
    fused_dispatch_mb = (n_tok + ragged_rows) * row_bytes / 1e6
    compact_combine_mb = (ragged_rows + n_tok) * row_bytes / 1e6
    # Hidden leg: every two-kernel path writes the (G, C, F) SwiGLU output
    # and the down-projection reads it back (the Pallas pipeline moves all
    # blocks of a BlockSpec-driven operand, dead tiles included, so this
    # leg is full-size even for the ragged kernels). The single-kernel
    # fused path keeps the hidden tile in VMEM: exactly zero.
    hidden_mb = 2 * g * c * hidden_row_bytes / 1e6

    def acc(exec_gf, dispatch_mb, combine_mb, hidden):
        return {
            "exec_gflop": round(exec_gf, 4),
            "utilization": round(achieved_gf / exec_gf, 4) if exec_gf else 1.0,
            "dispatch_hbm_mb": round(dispatch_mb, 4),
            "combine_hbm_mb": round(combine_mb, 4),
            "hidden_hbm_mb": round(hidden, 4),
        }

    meta = {
        "shape": name,
        "G": g,
        "C": c,
        "D": d,
        "F": f,
        "routing": "balanced" if balanced else "skewed",
        "tokens_routed": n_tok,
        "tokens_padded": g * c,
        "group_sizes": counts.tolist(),
        "padded_gflop": round(padded_gf, 4),
        "achieved_gflop": round(achieved_gf, 4),
    }
    paths = {
        "einsum_padded_dispatch": acc(
            padded_gf, padded_leg_mb, padded_leg_mb, hidden_mb
        ),
        "gmm_padded_dispatch": acc(
            padded_gf, padded_leg_mb, padded_leg_mb, hidden_mb
        ),
        "gmm_ragged_padded_dispatch": acc(
            ragged_exec_gf, padded_leg_mb, padded_leg_mb, hidden_mb
        ),
        "gmm_gather_fused_dispatch": acc(
            ragged_exec_gf, fused_dispatch_mb, padded_leg_mb, hidden_mb
        ),
        "gmm_compact_fused_combine": acc(
            ragged_exec_gf, fused_dispatch_mb, compact_combine_mb, hidden_mb
        ),
        "gmm_fused_ffn_combine": acc(
            ragged_exec_gf, fused_dispatch_mb, compact_combine_mb, 0.0
        ),
    }
    return counts, meta, paths


def decode_cell_accounting(name, b, max_seq, lengths, kv, h, hd, bs):
    """Deterministic columns of one decode cell (KV HBM-byte model)."""
    nb = -(-max_seq // bs)
    row_bytes = 2 * kv * hd * np.dtype(np.float32).itemsize  # k + v
    dense_mb = b * nb * bs * row_bytes / 1e6
    live_pages = sum(-(-l // bs) for l in lengths)
    paged_mb = live_pages * bs * row_bytes / 1e6
    meta = {
        "shape": name,
        "B": b,
        "max_seq": max_seq,
        "page_size": bs,
        "lengths": list(lengths),
        "tokens_live": int(sum(lengths)),
        "tokens_streamed_dense": b * nb * bs,
        "tokens_streamed_paged": live_pages * bs,
    }
    paths = {
        "flash_decode_dense_masked": {"kv_hbm_mb": round(dense_mb, 4)},
        "flash_decode_paged": {"kv_hbm_mb": round(paged_mb, 4)},
    }
    ratio = round(dense_mb / paged_mb, 3)
    return meta, paths, ratio


def migration_cell_accounting(name, layers, s, d, f, n_slices, n_tok):
    """Deterministic columns of one stepped-migration cell: the byte/tick
    schedule the MigrationDriver produces for one expert move. Gated by
    ``--check``; the wall columns are not."""
    itemsize = np.dtype(np.float32).itemsize
    # Rows axis is axis 2 of every slot tensor: d for w_gate/w_up, f for
    # w_down — the driver chunks each tensor independently.
    chunks = {
        "w_gate": (-(-d // n_slices), f),
        "w_up": (-(-d // n_slices), f),
        "w_down": (-(-f // n_slices), d),
    }
    expert_bytes = layers * (2 * d * f + f * d) * itemsize
    slice_bytes = sum(
        layers * rows * cols * itemsize for rows, cols in chunks.values()
    )
    return {
        "shape": name,
        "L": layers,
        "n_slots": s,
        "D": d,
        "F": f,
        "tokens_per_step": n_tok,
        "n_slices": n_slices,
        "slice_rows": {k: rows for k, (rows, _) in chunks.items()},
        "expert_mb": round(expert_bytes / 1e6, 4),
        "slice_mb": round(slice_bytes / 1e6, 4),
        # one commit tick after the last slice tick (the atomic table swap
        # happens at the next step boundary).
        "ticks_to_commit": n_slices + 1,
    }


def prefill_cell_accounting(name, model, b, chunk, prompt_len, bs, max_seq):
    """Deterministic columns of one chunked-admission cell: the tick and
    KV-byte schedule the decode step's prefill lane pays to admit one
    prompt. Gated by ``--check``; the wall columns are not."""
    cfg = smoke(get_config(model))
    kv_row_bytes = 2 * cfg.n_kv_heads * cfg.head_dim_ * np.dtype(np.float32).itemsize
    ticks = -(-prompt_len // chunk)
    # Every tick writes the full padded chunk (padding rows land on the
    # write-off page — still a write) and the lane's attention gathers the
    # request's whole capacity table (max_seq rows of k + v), per layer.
    rows_written = ticks * chunk
    rows_streamed = ticks * max_seq
    return {
        "shape": name,
        "model": model,
        "B": b,
        "chunk": chunk,
        "prompt_len": prompt_len,
        "page_size": bs,
        "max_seq": max_seq,
        "L": cfg.n_layers,
        "kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim_,
        # first token lands on the final chunk's tick; live decode slots
        # never stall (they share the one fused program).
        "ttft_ticks": ticks,
        "decode_stall_ticks": 0,
        "chunk_rows_written": rows_written,
        "chunk_rows_streamed": rows_streamed,
        "chunk_hbm_mb": round(
            cfg.n_layers * (rows_written + rows_streamed) * kv_row_bytes / 1e6, 4
        ),
    }


def ep_chunk_cell_accounting(name, ep, spd, cap, d, f, chunk_counts, balanced):
    """Deterministic columns of one chunked-EP cell: seeded routing draw,
    per-chunk HBM/wire-byte model, and the analytic ``exposed_comm_ms``
    pipeline schedule. Gated by ``--check``; the wall columns are not.
    Raises if any chunked schedule fails to beat the single-shot one —
    the overlap property itself is part of the gate."""
    g = ep * spd
    counts = (
        np.full(g, cap, np.int64) if balanced else _skewed_counts(g, cap, seed=g * cap)
    )
    n_tok = int(counts.sum())
    row_bytes = d * np.dtype(np.float32).itemsize
    flop_per_row = 6 * d * f
    bm = _tile(cap, BM)
    # One all_to_all leg moves the full statically shaped exchange buffer:
    # EP * SPD buckets of CAP rows per device. Chunking splits it exactly
    # K ways (the per-chunk buffers are (EP, SPD/K * CAP, D)).
    wire_total = g * cap * row_bytes

    def leg_ms(nbytes):
        return nbytes / (EP_WIRE_GBPS * 1e9) * 1e3

    def compute_ms(nflop):
        return nflop / (EP_MODEL_TFLOPS * 1e12) * 1e3

    per_k = {}
    exposed_by_k = {}
    for kk in chunk_counts:
        assert g % kk == 0, f"{name}: ep_chunks={kk} does not divide {g} groups"
        gpc = g // kk
        t_leg = leg_ms(wire_total / kk)
        disp, comb, exec_gf, comp = [], [], [], []
        for cc in range(kk):
            cnts = counts[cc * gpc : (cc + 1) * gpc]
            tok_c = int(cnts.sum())
            ragged_c = sum(math.ceil(cnt / bm) * bm for cnt in cnts)
            disp.append(round((tok_c + ragged_c) * row_bytes / 1e6, 4))
            comb.append(round((ragged_c + tok_c) * row_bytes / 1e6, 4))
            exec_gf.append(round(ragged_c * flop_per_row / 1e9, 4))
            comp.append(compute_ms(ragged_c * flop_per_row))
        # Pipeline schedule: chunk i's compute slot must cover chunk i-1's
        # combine and chunk i+1's dispatch; the first dispatch and last
        # combine have nothing to hide behind.
        exposed = t_leg + t_leg
        for i in range(kk):
            net = (t_leg if i > 0 else 0.0) + (t_leg if i < kk - 1 else 0.0)
            exposed += max(0.0, net - comp[i])
        exposed_by_k[kk] = exposed
        per_k[str(kk)] = {
            "groups_per_chunk": gpc,
            "wire_mb_per_chunk": round(wire_total / kk / 1e6, 4),
            "exec_gflop": exec_gf,
            "dispatch_hbm_mb": disp,
            "combine_hbm_mb": comb,
            "exposed_comm_ms": round(exposed, 6),
        }
    for kk, exp in exposed_by_k.items():
        if kk > 1 and not exp < exposed_by_k[1]:
            raise AssertionError(
                f"{name}: exposed_comm_ms(K={kk})={exp:.6f} is not strictly "
                f"below the single-shot baseline {exposed_by_k[1]:.6f} — the "
                "chunked schedule stopped hiding the all_to_all legs"
            )
    meta = {
        "shape": name,
        "EP": ep,
        "SPD": spd,
        "CAP": cap,
        "D": d,
        "F": f,
        "routing": "balanced" if balanced else "skewed",
        "tokens_routed": n_tok,
        "tokens_padded": g * cap,
        "group_sizes": counts.tolist(),
        "wire_mb_per_leg": round(wire_total / 1e6, 4),
    }
    return counts, meta, per_k


# ---------------------------------------------------------------------------
# the port's own tile accounting (CUDA bodies, csrc/)
# ---------------------------------------------------------------------------

DECODE_ROWS = 8      # gmm_ragged.cu DEC_ROWS: a group's rows in the decode body (C <= 8)
GMM_FMA_BM = 64      # gmm_ragged.cu fp32 body: rows a block (launch<float, 64, 128, 16, ...>)
GMM_FMA_BK = 16      # gmm_ragged.cu fp32 body: k a step


def port_row_tile(c: int, fused: bool) -> int:
    """Rows one block of the port's fp32 body computes for a group of
    capacity ``c``: the decode body's group of 8 at ``c <= 8`` (ragged
    GMMs), else 64-row tiles; the fused FFN's FMA body 16-row tiles at
    ``c <= 16``, else 64."""
    if fused:
        return 16 if c <= 16 else 64
    return DECODE_ROWS if c <= DECODE_ROWS else GMM_FMA_BM


def port_ffn_columns(c: int, d: int, f: int, counts, fused: bool) -> dict:
    """The port's executed rows and GFLOP for one count-aware path: a
    block whose first row is past its group's count exits without reading
    weights, so a group of count n runs ``min(ceil(n / tile) * tile, c)``
    rows (the last tile bounds-checked at the capacity)."""
    tile = port_row_tile(c, fused)
    rows = sum(min(math.ceil(int(n) / tile) * tile, c) for n in counts)
    return {
        "port_row_tile": tile,
        "port_k_tile": GMM_FMA_BK,
        "port_exec_rows": rows,
        "port_exec_gflop": round(rows * 6 * d * f / 1e9, 4),
    }


# ---------------------------------------------------------------------------
# timing and launch counting
# ---------------------------------------------------------------------------

PARITY = dict(rtol=2e-4, atol=2e-4)   # the reference's limit for every path


def kernel_wrappers() -> tuple:
    """Every kernel wrapper of the port (thirteen, each partials mode
    apart); each counts its launches in ``.launches``."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode.flash_decode import (
        flash_decode,
        flash_decode_partials,
    )
    from repro_torch.kernels.flash_decode.paged import (
        flash_decode_paged,
        flash_decode_paged_partials,
    )
    from repro_torch.kernels.gmm import gmm as P
    from repro_torch.kernels.gmm import ragged as K

    return (K.gmm_ragged, K.gmm_dual_act_ragged, K.gmm_gather, K.gmm_dual_act_gather,
            K.gmm_scatter, K.gmm_fused_ffn, P.gmm, P.gmm_dual_act, flash_decode,
            flash_decode_partials, flash_decode_paged, flash_decode_paged_partials,
            flash_attention)


def launches_of(fn, *args) -> dict:
    """The kernels one call of ``fn(*args)`` launches (name -> count,
    those launched only); the counters are left at 0."""
    ks = kernel_wrappers()
    for k in ks:
        k.launches = 0
    fn(*args)
    out = {k.__name__: k.launches for k in ks if k.launches}
    for k in ks:
        k.launches = 0
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, *args, device: torch.device, iters: int = 20, warmup: int = 3) -> tuple:
    """``(wall_s, event_ms)``: the best of ``iters`` synchronised calls by
    the host clock, and by CUDA events around each call (``None`` on the
    CPU). The minimum is the noise-robust estimator on a shared host."""
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    walls, events = [], []
    for _ in range(iters):
        if device.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        fn(*args)
        if device.type == "cuda":
            b.record()
        _sync(device)
        walls.append(time.perf_counter() - t0)
        if device.type == "cuda":
            events.append(a.elapsed_time(b))
    return float(np.min(walls)), (float(np.min(events)) if events else None)


def _timed(fn, *args, device, iters: int) -> dict:
    wall, event = _time(fn, *args, device=device, iters=iters)
    return {"wall_ms": round(wall * 1e3, 3),
            "event_ms": None if event is None else round(event, 4),
            "launches": launches_of(fn, *args)}


def _normal(gen, shape, device, scale: float = 1.0) -> torch.Tensor:
    """Seeded float32 normals drawn on the host (the same on every device)."""
    return (torch.randn(shape, generator=gen, dtype=torch.float32) * scale).to(device)


def _close(got, want, what: str) -> None:
    np.testing.assert_allclose(got.detach().cpu().numpy(), want.detach().cpu().numpy(),
                               err_msg=what, **PARITY)


# ---------------------------------------------------------------------------
# the timed paths
# ---------------------------------------------------------------------------

def run(iters: int = 20, smoke: bool = False, device="cuda") -> list[dict]:
    from repro_torch.kernels.gmm import ops
    from repro_torch.kernels.gmm.ref import expert_ffn as expert_ffn_ref
    from repro_torch.parallel.collectives import (
        bucket_combine,
        bucket_dispatch,
        combine_from_rows,
        dispatch_metadata,
        kept_counts,
    )

    device = resolve_device(device)
    rows = []
    for name, g, c, d, f, balanced in SMOKE_SHAPES if smoke else SHAPES:
        gen = torch.Generator().manual_seed(zlib.crc32(name.encode()))
        counts, meta, path_acc = ffn_cell_accounting(name, g, c, d, f, balanced)
        n_tok = int(counts.sum())
        ids = torch.as_tensor(_ids_from_counts(counts), device=device)[:, None]   # (n, 1)
        xt = _normal(gen, (n_tok, d), device)
        wg = _normal(gen, (g, d, f), device, 0.1)
        wu = _normal(gen, (g, d, f), device, 0.1)
        wd = _normal(gen, (g, f, d), device, 0.1)
        wt = torch.ones(ids.shape, dtype=torch.float32, device=device)   # router weights (k = 1)

        def einsum_fn(xt, ids, wg, wu, wd):
            bufs, slots, keep = bucket_dispatch(xt, ids, g, c)
            return bucket_combine(expert_ffn_ref(bufs, wg, wu, wd), ids, slots, keep, wt)

        def padded_fn(xt, ids, wg, wu, wd):
            bufs, slots, keep = bucket_dispatch(xt, ids, g, c)
            return bucket_combine(ops.expert_ffn(bufs, wg, wu, wd), ids, slots, keep, wt)

        def ragged_fn(xt, ids, wg, wu, wd):
            bufs, slots, keep = bucket_dispatch(xt, ids, g, c)
            gs = kept_counts(ids, keep, g)
            y = ops.expert_ffn_ragged(bufs, wg, wu, wd, gs)
            return bucket_combine(y, ids, slots, keep, wt)

        def gather_fn(xt, ids, wg, wu, wd):
            row_ids, offsets, gs, slots, keep = dispatch_metadata(ids, g, c)
            y = ops.expert_ffn_gather(xt[row_ids.long()], wg, wu, wd, offsets, gs, capacity=c)
            return bucket_combine(y, ids, slots, keep, wt)

        def compact_fn(xt, ids, wg, wu, wd):
            row_ids, offsets, gs, slots, keep = dispatch_metadata(ids, g, c)
            y = ops.expert_ffn_gather_compact(xt[row_ids.long()], wg, wu, wd, offsets, gs,
                                              capacity=c)
            return combine_from_rows(y, offsets[ids.long()] + slots, keep, wt)

        def fused_ffn_fn(xt, ids, wg, wu, wd):
            row_ids, offsets, gs, slots, keep = dispatch_metadata(ids, g, c)
            y = ops.expert_ffn_fused(xt[row_ids.long()], wg, wu, wd, offsets, gs, capacity=c)
            return combine_from_rows(y, offsets[ids.long()] + slots, keep, wt)

        fns = {
            "einsum_padded_dispatch": einsum_fn,
            "gmm_padded_dispatch": padded_fn,
            "gmm_ragged_padded_dispatch": ragged_fn,
            "gmm_gather_fused_dispatch": gather_fn,
            "gmm_compact_fused_combine": compact_fn,
            "gmm_fused_ffn_combine": fused_ffn_fn,
        }
        args = (xt, ids, wg, wu, wd)
        # Cross-check every path before timing: the outputs are per-token
        # combined results, so a fault on either leg fails here.
        ref = einsum_fn(*args)
        for label, fn in fns.items():
            _close(fn(*args), ref, f"{name}:{label} parity")
        port = {
            "gmm_padded_dispatch": {"port_exec_rows": g * c,
                                    "port_exec_gflop": meta["padded_gflop"]},
            **{p: port_ffn_columns(c, d, f, counts, fused=False) for p in (
                "gmm_ragged_padded_dispatch", "gmm_gather_fused_dispatch",
                "gmm_compact_fused_combine")},
            "gmm_fused_ffn_combine": port_ffn_columns(c, d, f, counts, fused=True),
        }
        rows.append({
            **meta,
            "paths": {p: {**_timed(fns[p], *args, device=device, iters=iters), **acc,
                          **port.get(p, {})}
                      for p, acc in path_acc.items()},
        })
    return rows


def run_decode(iters: int = 20, smoke: bool = False, device="cuda") -> list[dict]:
    """Dense vs paged decode attention: parity against the plain decode,
    then the KV HBM-byte accounting and the times."""
    from repro_torch.kernels.flash_decode.ops import flash_decode_op, flash_decode_paged_op
    from repro_torch.kernels.flash_decode.ref import decode as decode_ref

    device = resolve_device(device)
    rows = []
    for name, b, max_seq, lengths, kv, h, hd, bs in (
        DECODE_SMOKE_SHAPES if smoke else DECODE_SHAPES
    ):
        gen = torch.Generator().manual_seed(zlib.crc32(name.encode()))
        nb = -(-max_seq // bs)
        q = _normal(gen, (b, h, hd), device)
        k = _normal(gen, (b, nb * bs, kv, hd), device)
        v = _normal(gen, (b, nb * bs, kv, hd), device)
        ln = torch.tensor(lengths, dtype=torch.int32, device=device)
        valid = (torch.arange(nb * bs, device=device)[None, :] < ln[:, None]).to(torch.int32)
        pool_k = k.reshape(b * nb, bs, kv, hd)
        pool_v = v.reshape(b * nb, bs, kv, hd)
        tables = torch.arange(b * nb, dtype=torch.int32, device=device).reshape(b, nb)

        ref = decode_ref(q, k, v, valid.bool())
        _close(flash_decode_op(q, k, v, valid), ref, f"{name}:dense parity")
        _close(flash_decode_paged_op(q, pool_k, pool_v, tables, ln), ref, f"{name}:paged parity")

        meta, path_acc, ratio = decode_cell_accounting(name, b, max_seq, lengths, kv, h, hd, bs)
        timed = {
            "flash_decode_dense_masked": _timed(flash_decode_op, q, k, v, valid,
                                                device=device, iters=iters),
            "flash_decode_paged": _timed(flash_decode_paged_op, q, pool_k, pool_v, tables, ln,
                                         device=device, iters=iters),
        }
        rows.append({
            **meta,
            "paths": {p: {**timed[p], **acc} for p, acc in path_acc.items()},
            "kv_bytes_ratio_dense_over_paged": ratio,
        })
    return rows


def run_migration(iters: int = 20, smoke: bool = False, device="cuda") -> list[dict]:
    """Stepped-migration cells: one tick's weight-row slice copies
    (``runtime/migration_driver.py::copy_row_slice``, the driver's own
    copy, on all three slot tensors) beside a decode-step-sized expert FFN
    (the batch's tokens through one slot's FFN in every layer, through the
    count-aware pair: what one EP rank computes a tick).
    ``migration_exposed_ms`` = wall(step + slice) - wall(step)."""
    from repro_torch.kernels.gmm import ops
    from repro_torch.kernels.gmm.ref import expert_ffn as expert_ffn_ref
    from repro_torch.runtime.migration_driver import copy_row_slice

    device = resolve_device(device)
    rows = []
    for name, layers, s, d, f, n_slices, n_tok in (
        MIGRATION_SMOKE_SHAPES if smoke else MIGRATION_SHAPES
    ):
        gen = torch.Generator().manual_seed(zlib.crc32(name.encode()))
        wg = _normal(gen, (layers, s, d, f), device, 0.1)
        wu = _normal(gen, (layers, s, d, f), device, 0.1)
        wd = _normal(gen, (layers, s, f, d), device, 0.1)
        x = _normal(gen, (n_tok, d), device)
        meta = migration_cell_accounting(name, layers, s, d, f, n_slices, n_tok)
        src, dst = 0, s - 1
        chunks = {"w_gate": -(-d // n_slices), "w_up": -(-d // n_slices),
                  "w_down": -(-f // n_slices)}
        gs = torch.tensor([n_tok], dtype=torch.int32, device=device)

        def step(x, wg, wu, wd):
            return torch.stack([
                ops.expert_ffn_ragged(x[None], wg[l, src][None], wu[l, src][None],
                                      wd[l, src][None], gs)[0]
                for l in range(layers)])

        def one_slice(i, wg, wu, wd):
            for w, n in ((wg, chunks["w_gate"]), (wu, chunks["w_up"]), (wd, chunks["w_down"])):
                total = w.shape[2]
                lo = max(0, min(i * n, total - n))
                copy_row_slice(w, src, dst, lo, n)

        def step_plus_slice(x, wg, wu, wd):
            y = step(x, wg, wu, wd)
            one_slice(0, wg, wu, wd)
            return y

        # Parity: the step against the plain FFN, and n_slices slice copies
        # landing the whole expert exactly.
        plain = torch.stack([expert_ffn_ref(x[None], wg[l, src][None], wu[l, src][None],
                                            wd[l, src][None])[0] for l in range(layers)])
        _close(step(x, wg, wu, wd), plain, f"{name}: step parity")
        cg, cu, cd = wg.clone(), wu.clone(), wd.clone()
        for i in range(n_slices):
            one_slice(i, cg, cu, cd)
        for full, copied, label in ((wg, cg, "w_gate"), (wu, cu, "w_up"), (wd, cd, "w_down")):
            np.testing.assert_array_equal(
                copied[:, dst].cpu().numpy(), full[:, src].cpu().numpy(),
                err_msg=f"{name}:{label} sliced copy != whole expert")

        t_step = _timed(step, x, wg, wu, wd, device=device, iters=iters)
        t_both = _timed(step_plus_slice, x, cg, cu, cd, device=device, iters=iters)
        rows.append({
            **meta,
            "step_wall_ms": t_step["wall_ms"],
            "step_event_ms": t_step["event_ms"],
            "step_plus_slice_wall_ms": t_both["wall_ms"],
            "step_plus_slice_event_ms": t_both["event_ms"],
            "migration_exposed_ms": round(max(0.0, t_both["wall_ms"] - t_step["wall_ms"]), 3),
            "launches": t_both["launches"],
        })
    return rows


def _clone_cache(cache: dict) -> dict:
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out[k] = _clone_cache(v)
        elif isinstance(v, torch.Tensor):
            out[k] = v.clone()
        else:
            out[k] = v
    return out


def run_prefill(iters: int = 20, smoke_mode: bool = False, device="cuda") -> list[dict]:
    """Chunked-admission interleave cells: the decode step with a live
    prefill chunk against the no-op chunk, on the cell's ``smoke()`` model
    at head dim 32 (``PORT_MIN_HEAD_DIM``: the reference's 16 is below the
    port's paged decode kernel; the row's ``port_*`` columns count the KV
    bytes at the run's head dim). The decode lane's logits must be
    bitwise equal with the lane off, idle (the no-op chunk, which the
    port's eager step skips) and mid-chunk. Each call steps a fresh copy
    of the cache (the step writes it in place), as the reference's
    undonated step returns a new one. ``chunk_exposed_ms`` = wall(decode +
    live chunk) - wall(decode + no-op chunk)."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx

    device = resolve_device(device)
    ctx = ParallelCtx()
    rows = []
    for name, model, b, chunk, prompt_len, bs, max_seq in (
        PREFILL_SMOKE_SHAPES if smoke_mode else PREFILL_SHAPES
    ):
        meta = prefill_cell_accounting(name, model, b, chunk, prompt_len, bs, max_seq)
        cfg = dataclasses.replace(smoke(get_config(model)), head_dim=PORT_MIN_HEAD_DIM)
        kv_row_bytes = 2 * cfg.n_kv_heads * cfg.head_dim_ * 4
        rows_moved = meta["chunk_rows_written"] + meta["chunk_rows_streamed"]
        params = T.init_params(cfg, seed=zlib.crc32(name.encode()), device=device)
        cache = T.init_cache(cfg, b, max_seq, paged=True, page_size=bs, device=device)
        nb = -(-max_seq // bs)
        token = torch.zeros((b, 1), dtype=torch.int32, device=device)
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        buf = rng.integers(0, cfg.vocab_size, size=chunk).astype(np.int32)
        live_chunk = {"tokens": torch.as_tensor(buf[None, :], device=device),
                      "table": torch.arange(nb, dtype=torch.int32, device=device),
                      "start": 0, "length": chunk}
        trash = cache["layers"]["pool_k"].shape[1] - 1
        noop_chunk = {"tokens": torch.zeros((1, chunk), dtype=torch.int32, device=device),
                      "table": torch.full((nb,), trash, dtype=torch.int32, device=device),
                      "start": 0, "length": 0}

        def step(chunk_op):
            return T.decode_step(params, token, _clone_cache(cache), cfg, ctx,
                                 chunk=chunk_op)[0]

        with torch.no_grad():
            ref = step(None)
            for label, op in (("noop", noop_chunk), ("live", live_chunk)):
                np.testing.assert_array_equal(
                    step(op).cpu().numpy(), ref.cpu().numpy(),
                    err_msg=f"{name}: chunk lane ({label}) leaked into decode lane")
            t_dec = _timed(step, noop_chunk, device=device, iters=iters)
            t_both = _timed(step, live_chunk, device=device, iters=iters)
        rows.append({
            **meta,
            "port_head_dim": cfg.head_dim_,
            "port_chunk_hbm_mb": round(cfg.n_layers * rows_moved * kv_row_bytes / 1e6, 4),
            "decode_wall_ms": t_dec["wall_ms"],
            "decode_event_ms": t_dec["event_ms"],
            "decode_plus_chunk_wall_ms": t_both["wall_ms"],
            "decode_plus_chunk_event_ms": t_both["event_ms"],
            "chunk_exposed_ms": round(max(0.0, t_both["wall_ms"] - t_dec["wall_ms"]), 3),
            "launches": t_both["launches"],
        })
    return rows


def run_ep_chunk(iters: int = 20, smoke: bool = False, device="cuda") -> list[dict]:
    """Chunked EP dispatch cells: the per-chunk fused row FFN
    (``registry.expert_ffn_from_rows(compact_out=True, fused=True)``) that
    the pipelined ``ep_moe_shardmap`` runs between its all-to-all legs,
    over K contiguous slices of one ``dispatch_metadata``'s offsets. Every
    K > 1 must be bitwise equal to K = 1."""
    from repro_torch.kernels import registry
    from repro_torch.parallel.collectives import combine_from_rows, dispatch_metadata

    device = resolve_device(device)
    rows = []
    for name, ep, spd, cap, d, f, chunk_counts, balanced in (
        EP_CHUNK_SMOKE_SHAPES if smoke else EP_CHUNK_SHAPES
    ):
        g = ep * spd
        counts, meta, per_k = ep_chunk_cell_accounting(
            name, ep, spd, cap, d, f, chunk_counts, balanced)
        n_tok = int(counts.sum())
        gen = torch.Generator().manual_seed(zlib.crc32(name.encode()))
        ids = torch.as_tensor(_ids_from_counts(counts), device=device)[:, None]
        xt = _normal(gen, (n_tok, d), device)
        wg = _normal(gen, (g, d, f), device, 0.1)
        wu = _normal(gen, (g, d, f), device, 0.1)
        wd = _normal(gen, (g, f, d), device, 0.1)
        wt = torch.ones(ids.shape, dtype=torch.float32, device=device)

        def make_fn(kk):
            gpc = g // kk

            def fn(xt, ids, wg, wu, wd):
                row_ids, offsets, gs, slots, keep = dispatch_metadata(ids, g, cap)
                rows_in = xt[row_ids.long()]

                def chunk_ffn(cc):
                    ws = slice(cc * gpc, (cc + 1) * gpc)
                    return registry.expert_ffn_from_rows(
                        rows_in, wg[ws], wu[ws], wd[ws], offsets[ws], gs[ws],
                        capacity=cap, groups_per_weight=1, compact_out=True, fused=True)

                y = chunk_ffn(0)
                if kk > 1:
                    # rows outside a chunk's buckets are unspecified in its
                    # output: each row comes from its owner chunk
                    r_idx = torch.arange(rows_in.shape[0], dtype=torch.int32, device=device)
                    owner = torch.searchsorted(offsets, r_idx, right=True) - 1
                    owner_c = owner.clamp(0, g - 1) // gpc
                    for cc in range(1, kk):
                        y = torch.where((owner_c == cc)[:, None], chunk_ffn(cc), y)
                return combine_from_rows(y, offsets[ids.long()] + slots, keep, wt)

            return fn

        fns = {kk: make_fn(kk) for kk in chunk_counts}
        args = (xt, ids, wg, wu, wd)
        with torch.no_grad():
            base = fns[1](*args)
            for kk in chunk_counts[1:]:
                np.testing.assert_array_equal(
                    fns[kk](*args).cpu().numpy(), base.cpu().numpy(),
                    err_msg=f"{name}: ep_chunks={kk} is not bit-identical to the single-shot path")
            chunks_out = {}
            for kk in chunk_counts:
                gpc = g // kk
                port = [port_ffn_columns(cap, d, f, counts[cc * gpc:(cc + 1) * gpc], fused=True)
                        for cc in range(kk)]
                chunks_out[str(kk)] = {
                    **_timed(fns[kk], *args, device=device, iters=iters), **per_k[str(kk)],
                    "port_row_tile": port[0]["port_row_tile"],
                    "port_exec_gflop": [p["port_exec_gflop"] for p in port],
                }
        rows.append({**meta, "chunks": chunks_out})
    return rows


def card() -> dict | None:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return {"nvidia_smi": out.splitlines()[0] if out else None}

# ---------------------------------------------------------------------------
# baseline regression gate (--check)
# ---------------------------------------------------------------------------

def check_baseline(baseline_path: str) -> list[str]:
    """Recompute every deterministic column from the same seeded draws and
    diff against the committed baseline. Returns human-readable failure
    lines (empty == green). Wall-clock, backend, and version fields are
    deliberately ignored — only the accounting the fused kernels exist to
    improve is gated."""
    with open(baseline_path) as fh:
        base = json.load(fh)
    failures: list[str] = []

    def cmp(cell: str, key: str, want, got) -> None:
        if want != got:
            failures.append(
                f"{cell}.{key}: baseline {want!r} != recomputed {got!r}"
            )

    base_shapes = {r.get("shape"): r for r in base.get("shapes", [])}
    expected = []
    for name, g, c, d, f, balanced in SHAPES:
        expected.append(name)
        _, meta, path_acc = ffn_cell_accounting(name, g, c, d, f, balanced)
        row = base_shapes.get(name)
        if row is None:
            failures.append(f"shapes[{name}]: missing from baseline")
            continue
        for key, val in meta.items():
            cmp(f"shapes[{name}]", key, row.get(key), val)
        for pname, acc in path_acc.items():
            prow = (row.get("paths") or {}).get(pname)
            if prow is None:
                failures.append(f"shapes[{name}].paths.{pname}: missing from baseline")
                continue
            for key, val in acc.items():
                cmp(f"shapes[{name}].paths.{pname}", key, prow.get(key), val)
    for name in set(base_shapes) - set(expected):
        failures.append(f"shapes[{name}]: in baseline but no longer benchmarked")

    base_dec = {r.get("shape"): r for r in base.get("decode_shapes", [])}
    expected = []
    for name, b, max_seq, lengths, kv, h, hd, bs in DECODE_SHAPES:
        expected.append(name)
        meta, path_acc, ratio = decode_cell_accounting(
            name, b, max_seq, lengths, kv, h, hd, bs
        )
        row = base_dec.get(name)
        if row is None:
            failures.append(f"decode_shapes[{name}]: missing from baseline")
            continue
        for key, val in meta.items():
            cmp(f"decode_shapes[{name}]", key, row.get(key), val)
        cmp(
            f"decode_shapes[{name}]", "kv_bytes_ratio_dense_over_paged",
            row.get("kv_bytes_ratio_dense_over_paged"), ratio,
        )
        for pname, acc in path_acc.items():
            prow = (row.get("paths") or {}).get(pname)
            if prow is None:
                failures.append(
                    f"decode_shapes[{name}].paths.{pname}: missing from baseline"
                )
                continue
            for key, val in acc.items():
                cmp(f"decode_shapes[{name}].paths.{pname}", key, prow.get(key), val)
    for name in set(base_dec) - set(expected):
        failures.append(f"decode_shapes[{name}]: in baseline but no longer benchmarked")

    base_mig = {r.get("shape"): r for r in base.get("migration_shapes", [])}
    expected = []
    for name, layers, s, d, f, n_slices, n_tok in MIGRATION_SHAPES:
        expected.append(name)
        meta = migration_cell_accounting(name, layers, s, d, f, n_slices, n_tok)
        row = base_mig.get(name)
        if row is None:
            failures.append(f"migration_shapes[{name}]: missing from baseline")
            continue
        for key, val in meta.items():
            cmp(f"migration_shapes[{name}]", key, row.get(key), val)
    for name in set(base_mig) - set(expected):
        failures.append(
            f"migration_shapes[{name}]: in baseline but no longer benchmarked"
        )

    base_pf = {r.get("shape"): r for r in base.get("prefill_shapes", [])}
    expected = []
    for name, model, b, chunk, prompt_len, bs, max_seq in PREFILL_SHAPES:
        expected.append(name)
        meta = prefill_cell_accounting(name, model, b, chunk, prompt_len, bs, max_seq)
        row = base_pf.get(name)
        if row is None:
            failures.append(f"prefill_shapes[{name}]: missing from baseline")
            continue
        for key, val in meta.items():
            cmp(f"prefill_shapes[{name}]", key, row.get(key), val)
    for name in set(base_pf) - set(expected):
        failures.append(
            f"prefill_shapes[{name}]: in baseline but no longer benchmarked"
        )

    base_ec = {r.get("shape"): r for r in base.get("ep_chunk_shapes", [])}
    expected = []
    for name, ep, spd, cap, d, f, chunk_counts, balanced in EP_CHUNK_SHAPES:
        expected.append(name)
        _, meta, per_k = ep_chunk_cell_accounting(
            name, ep, spd, cap, d, f, chunk_counts, balanced
        )
        row = base_ec.get(name)
        if row is None:
            failures.append(f"ep_chunk_shapes[{name}]: missing from baseline")
            continue
        for key, val in meta.items():
            cmp(f"ep_chunk_shapes[{name}]", key, row.get(key), val)
        base_chunks = row.get("chunks") or {}
        for kk, acc in per_k.items():
            crow = base_chunks.get(kk)
            if crow is None:
                failures.append(
                    f"ep_chunk_shapes[{name}].chunks[{kk}]: missing from baseline"
                )
                continue
            for key, val in acc.items():
                cmp(f"ep_chunk_shapes[{name}].chunks[{kk}]", key, crow.get(key), val)
        for kk in set(base_chunks) - set(per_k):
            failures.append(
                f"ep_chunk_shapes[{name}].chunks[{kk}]: in baseline but no "
                "longer benchmarked"
            )
    for name in set(base_ec) - set(expected):
        failures.append(
            f"ep_chunk_shapes[{name}]: in baseline but no longer benchmarked"
        )
    return failures


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="BENCH_kernels.json")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument(
        "--smoke",
        action="store_true",
        help="tiny FFN + decode cells, 2 iters: fast kernel regression gate",
    )
    ap.add_argument(
        "--check",
        metavar="BASELINE_JSON",
        help="recompute the deterministic columns (FLOP + HBM-byte "
        "accounting, not wall-clock) and fail on any drift from the "
        "committed baseline",
    )
    args = ap.parse_args()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="results/torch/bench_kernels.json")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu (their "
                         "plain versions)")
    ap.add_argument("--smoke", action="store_true",
                    help="one tiny cell of each family, 2 iters: the parity gate")
    ap.add_argument("--check", metavar="BASELINE_JSON",
                    help="recompute the deterministic columns (FLOP and HBM-byte "
                         "accounting, not wall-clock) and fail on any drift from "
                         "the baseline, which is only read")
    args = ap.parse_args(argv)

    if args.check:
        failures = check_baseline(args.check)
        if failures:
            print(f"BENCH BASELINE DRIFT vs {args.check} ({len(failures)} mismatches):",
                  file=sys.stderr)
            for line in failures:
                print(f"  {line}", file=sys.stderr)
            raise SystemExit(1)
        print(f"BENCH BASELINE OK ({args.check}: deterministic columns match, 0 mismatches)")
        return

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # fp32 compared as fp32
        torch.backends.cudnn.allow_tf32 = False
    iters = 2 if args.smoke else args.iters
    try:
        rows = run(iters=iters, smoke=args.smoke, device=device)
        decode_rows = run_decode(iters=iters, smoke=args.smoke, device=device)
        migration_rows = run_migration(iters=iters, smoke=args.smoke, device=device)
        prefill_rows = run_prefill(iters=iters, smoke_mode=args.smoke, device=device)
        ep_chunk_rows = run_ep_chunk(iters=iters, smoke=args.smoke, device=device)
    except AssertionError as e:   # a parity failure fails the gate loudly
        print(f"KERNEL PARITY FAILURE: {e}", file=sys.stderr)
        raise SystemExit(1)
    doc = {
        "bench": "kernels_expert_ffn_dispatch",
        "backend": device.type,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "card": card() if device.type == "cuda" else None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "host": platform.machine(),
        "smoke": args.smoke,
        "note": (
            "The port's kernel-path bench. wall_ms: best of N synchronised calls by the "
            "host clock; event_ms: best of N by CUDA events (null on the CPU); launches: "
            "the kernels one call of the path launched. On the CPU every path runs the "
            "kernels' plain versions (launches are empty): times there are not the "
            "card's. The FLOP and HBM-byte columns are the reference's accounting of its "
            "Pallas tiles, unchanged (--check BENCH_kernels.json); port_* columns count "
            "the port's CUDA tiles. The cells are the reference's small shapes (d 16-128, "
            "fp32): on the card their times are launch-bound."
        ),
        "shapes": rows,
        "decode_shapes": decode_rows,
        "migration_shapes": migration_rows,
        "prefill_shapes": prefill_rows,
        "ep_chunk_shapes": ep_chunk_rows,
    }
    if args.smoke:
        print(json.dumps(doc, indent=2))
        print("BENCH SMOKE OK")
        return
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")
    print(json.dumps(doc, indent=2))


if __name__ == "__main__":
    main()
