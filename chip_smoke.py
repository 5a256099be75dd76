#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is non-zero):

1. the card's name and power limit (``nvidia-smi``); build the CUDA kernels
   from ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel),
   with ptxas's registers and spills of each (a spill in a ``wgmma`` body,
   the decode GMM body or a bf16 body of ``gmm_fused_ffn`` fails the run),
   and the decode gates' and the fused bodies' shared-memory counts held
   against the kernels'; then the analytic model's fast paper figures
   (``repro_torch.figures`` fig06 through fig14b: numpy on the host, no
   kernel) on this machine's Python and numpy, each returning rows with a
   finite, positive ``us_per_call`` (modelled times of the paper's
   platforms, not of this card), and the phase's wall seconds;
2. small fp32 models served on the card with the kernels and with the
   plain path: the greedy tokens must agree. One serves EP with the
   balancer on the paged cache, the other ESP on the dense cache with its
   sliding window kept and wrapped (it takes ``gmm_fused_ffn`` and
   ``flash_decode``);
   A third small fp32 model is served under a 1 x 1 ``("data", "model")``
   mesh over NCCL (a world of one): its greedy tokens with the kernels
   must equal those of the plain path and of the same model's no-mesh EP
   Server (it takes ``ep_moe_shardmap``'s all-to-all legs and the
   sequence-parallel decode on ``flash_decode``'s partials mode), and
   through the scheduler on the mesh it crashes at tick 3 and, restored
   from its snapshot file on the mesh, serves every stream of its no-mesh
   run;
   then the ``smoke()`` model of each of the seven other families
   (qwen2-72b, tinyllama-1.1b, deepseek-7b, zamba2-1.2b, xlstm-350m,
   seamless-m4t-medium, internvl2-76b) at head dim 32, fp32, with the
   kernels and on the plain path: the greedy tokens must agree and the
   kernel run's launches equal the layer count's prediction (internvl2
   and seamless with the CLI's stub embeds, internvl2 paged);
3. the main paths, each after a short warm-up run of its server, with
   prefill (TTFT) and the decode loop timed apart with CUDA events and 8
   more decode steps under ``torch.profiler`` for the device busy share.
   Every kernel's launch count is set to 0 just before the timed run and
   must equal what the layer count predicts just after it:
   a. ``Server.generate`` at dbrx-132b width (4 layers, bf16, 8 requests x
      256-token prompts, 32 new tokens) with the NI-Balancer live and one
      stepped migration forced through ``apply_plan``, on the paged cache;
   b. ``Server.generate`` at mixtral-8x22b width (4 layers, bf16, the same
      traffic) with ESP on the dense cache;
   c. ``Server.generate`` at dbrx-132b width (the same traffic) on the 1 x 1
      NCCL mesh: EP through ``ep_moe_shardmap``, the dense cache of 1024
      slots attended through the partials kernel and the LSE merge, the
      balancer live with one forced migration;
   d. serving under faults: 12 requests through the ``RequestScheduler``
      over the paged EP ``Server`` at dbrx-132b width (4 layers, bf16,
      virtual EP 4 x 8 slots, capacity factor 5.0, alpha 0.1, page 128,
      batch 8, a 24-page pool; prompts of 64-256 tokens from the run's
      seed, 32 new tokens, request i at tick i // 2, request 0 stopping at
      its own third fault-free token) under ``FaultPlan.chaos`` (seed
      ``CHAOS_SEED``, 24 ticks, pressure 6 pages, NaN on slot 0, revival):
      device death, revival with blank rows, a straggler, stolen pages and
      a NaN step all fire and a request is preempted; every request
      finishes; never-preempted streams equal the fault-free run of the
      same batch on a fully backed pool bit for bit (recomputed streams
      log the prefix they share); no decode tick routes to the dead device
      before its first re-committed replica; the table is consistent; a
      migration commits; both runs' launches equal the prediction from
      their admissions and decode ticks. First a small fp32 model serves
      the same plan with the kernels and on the plain path: every stream,
      recomputed ones included, equals its fault-free run's, and the two
      runs agree event for event;
   e. chunked admission and crash-safe snapshots: a small fp32 model first
      (chunked against splice admission with the kernels and on the plain
      path, every stream equal; a crash with a request mid-prefill restored
      from the snapshot file, every stream equal to the uninterrupted
      run's), then at dbrx-132b width with 3d's model, slots, capacity
      factor, batch and requests and ``prefill_chunk=128``: a probe of where
      a recomputed bf16 context's K/V leave the K/V decode wrote (per layer,
      and layer 0's K projection at 8 rows against the context's rows);
      (i) a fault-free chunked run on 64 pages beside 3d's splice run (no
      live request stalls, each first token within ceil(len/128) + 1 ticks
      of admission, no chunk-lane copy dropped, launches as predicted with
      no ``flash_attention``; prefixes shared with the splice run logged);
      (ii) a chunked run under 3d's chaos plan on 24 pages with a
      ``crash_restart`` landing on the first tick from the death that
      starts with a request mid-prefill: the crashed server is freed, the
      scheduler restored from the snapshot file serves on, every request
      finishes, streams neither preempted nor live at the crash equal run
      (i)'s, the restore's peak memory stays within the setup peak plus the
      restored cache; snapshot ms and bytes, restore ms;
   f. serving under the 1 x 1 NCCL mesh: small fp32 models first (3d's
      small model with chunked admission under the chaos plan through the
      scheduler, and 2b's small ESP model), each with the kernels and on
      the plain path equal to its no-mesh run (streams and events, greedy
      tokens), launches as predicted; then 3e (ii)'s chunked run under 3d's
      chaos plan on 24 pages without the crash, with no mesh and on the
      mesh (each server freed before the next), then on the mesh with the
      crash, restored on the mesh from the file (3e's checks: the streams
      not recomputed equal the uninterrupted mesh run's, the restore peak
      within the setup peak plus the cache; snapshot ms and bytes, restore
      ms): every request finishes,
      every fault kind fires, no tick routes to the dead device before its
      first re-commit, a migration commits, each tick's launches as its
      kind predicts (on the mesh the gather/scatter pair of
      ``ep_moe_shardmap``), ticks 16-31 under the profiler for the busy
      share, the mesh streams' bf16 prefix shared with the no-mesh run
      logged; then mixtral-8x22b width with 3b's traffic, ESP on the mesh
      (``esp_expert_ffn``: the ragged pair, the reduce-scatter), timed
      beside 3b, launches as predicted;
   g. the other families at full width, one server at a time: bf16, 8
      requests x 256-token prompts, 32 new tokens, max_seq 1024, a warm-up
      run first; qwen2-72b and internvl2-76b cut to 4 layers (internvl2
      with 256 bf16 stub embeds prepended, on the paged cache of page
      128), seamless-m4t-medium (12 + 12 layers, 1024 bf16 frame
      embeds), zamba2-1.2b (38 layers: 6 units of 6 Mamba2 layers + 2
      trailing) and xlstm-350m (24 blocks) at full depth on the dense
      cache. Every kernel's launches equal the layer count's prediction
      (``family_launches``: the MLPs, cross-attention and the recurrences
      are plain, so xlstm launches none); TTFT, decode tok/s, the busy
      share over 8 profiled decode steps, peak memory and the phase's wall
      time; for zamba2 and xlstm the host and device time inside the plain
      recurrences over 8 more decode steps. (m) The families that serve
      under a mesh since item 6 on the 1 x 1 NCCL mesh: each one's smoke()
      model, head dim 32, fp32, on the mesh and without it, greedy tokens
      equal and every step's logits within the fp32 limit; then
      zamba2-1.2b, xlstm-350m and seamless-m4t-medium at full depth, bf16,
      3g's prompts, embeds and weights, after a short warm-up on the mesh:
      launches as predicted (``family_mesh_launches``: the dense-cache
      decode through ``flash_decode``'s partials mode, the normalised
      kernel 0), TTFT, decode tok/s, the busy share over 4 profiled decode
      steps, peak memory, and each request's bf16 token prefix shared with
      its no-mesh run.
   h. training on one process (``runtime/train.py``, the registry's
      autograd Functions: kernel forward, plain backward), after every
      server is freed: (a) the smoke() model, head dim 32, fp32, of
      mixtral-8x22b under ``ep``, ``esp`` (``gmm_fused_ffn``'s fp32 body)
      and ``dense``, llama3.2-1b, zamba2-1.2b, xlstm-350m, and
      seamless-m4t-medium and internvl2-76b with the CLI's stub embeds:
      3 ``make_train_step`` steps from one state with the kernels and on
      the plain path, every step's metrics and gradients and the state
      after them within the fp32 limit (elements of a near-zero gradient
      that the runs round apart at the most AdamW can move them), launches
      as predicted (the forward's, one a kernel call); then 2 steps, a
      ``CheckpointManager`` save, a fresh state restored and 2 more steps
      against 4 uninterrupted; (b) mixtral-8x22b width cut to 1 layer,
      bf16 (2.91B parameters), 8 x 256 ``SyntheticLM`` tokens, under
      ``ep`` (the ragged pair) and ``esp`` (the gather/scatter pair), each
      on a fresh state: step 0's gradients with the kernels against the
      plain path's and an fp32 run's, the same step under remat (twice the
      launches, gradients within the bf16 limit), 5 timed steps (ms a
      step, tokens/s, ``adamw_update`` alone, peak memory, finite losses,
      one launch a kernel form a step); (c) ``launch.train.main`` for
      llama3.2-1b at full size, fp32, 16 layers, 20 steps of 8 x 512 with
      the reference CLI's defaults (losses finite, logged; 16
      ``flash_attention`` launches a step), and its ``--steps 3
      --use-kernels off`` losses equal to the first three; (d) training
      on the 1 x 1 NCCL mesh, autograd through the EP and ESP collectives:
      (i) the smoke() models of dbrx-132b under ``ep`` (the fused branch)
      and mixtral-8x22b under ``esp``, fp32, 3 steps on the mesh against
      3 without it, both with the kernels, within the fp32 limit, launches
      as predicted on a mesh, and one such step of zamba2-1.2b,
      xlstm-350m and seamless-m4t-medium; (ii) inside (b), on the same state after
      its no-mesh steps, mixtral-8x22b width on the mesh under ``ep`` and
      ``esp``: step 0's gradients within (b)'s bf16 bound (their distance
      from the fp32 run's at most twice the plain path's plus 2^-5) and
      beside the no-mesh kernels', then 5 timed steps beside (b)'s, peak
      memory; (iii) ``launch.train.main --mesh 1x1`` at llama3.2-1b for 3
      steps, its losses those of (c)'s first three.
   i. the kernel bench, the dry run and the roofline: (a) the
      bench's ``--smoke`` cells of its five families
      (``repro_torch.benchmarks.bench_kernels``: the six FFN paths, dense
      and paged decode, stepped migration, the chunked-admission lane,
      the chunked EP dispatch) on the card through the kernels, every
      parity check held and every kernel path launching its kernels;
      (b) the reference's full shape lists of the five families, 20
      iterations, one line a family with each path's wall and CUDA-event
      ms and the kernels it launched; (c) ``check_baseline`` against the
      committed ``BENCH_kernels.json`` (read only), 0 mismatches; (d) in
      a subprocess (the dry run's fake world of ranks cannot share this
      process with the NCCL group), the dry run of llama3.2-1b cut to 2
      layers at ``decode_32k`` on a 2 x 4 test mesh and of dbrx-132b,
      zamba2-1.2b and seamless-m4t-medium at ``decode_32k`` on the ER 16
      x 16 mesh at full depth (each cell's tensor-parallel parameter and
      argument bytes and collective calls and bytes held to the layout's
      prediction, ``tp_prediction``: the card's own world of one splits
      nothing, so the splits show only here and on gloo ranks in the CPU
      tests), each cell's
      status, FLOPs, argument, temp and collective GB and wall seconds
      (host only, fake tensors: no memory on the card); (e) the
      roofline's rows over those records (model output at the H100's
      datasheet constants, not measurements).
   The expert groups' row counts (and offsets) of layer 0 in one prefill
   and one decode tick of 3a-3c and of 3f's ESP run are kept for phases
   4-5 (the EP path's dispatched buckets too);
4. the kernel op layer (``kernels/*/ops.py``), driven after the servers are
   freed, in bf16, with its launch counts set to 0 before and read after:
   the padded ``ops.expert_ffn`` (``gmm_dual_act`` + ``gmm``) on the EP
   path's dispatched layer-0 buckets, equal on live rows to
   ``registry.expert_ffn`` (ragged); ``ops.gmm_gather_op`` at the mesh
   path's layouts; the paged decode cut into 4 slices through
   ``flash_decode_paged``'s partials mode, LSE-merged, equal to the
   normalised paged kernel. No served path launches these four kernels;
5. every kernel at the main paths' shapes and row counts, in bf16 and in
   fp32 (TF32 off), held elementwise against its plain PyTorch version
   (``repro_torch.kernels.tolerance``) with dead rows, gap rows of dropped
   copies, dead pages and invalid keys poisoned with NaN, and flat outputs
   filled with NaN first (rows outside the live segments must stay NaN);
   the bf16 GMMs also against the fp32 product of the same bf16 inputs;
   the ragged pair also at 3f's ESP buckets (mixtral's 8 experts, F 16384);
   the gather/scatter pair at both paths that run it (mixtral's 8 experts
   under ESP; dbrx's 20 slots with the mesh path's rank-compacted rows);
   ``gmm_fused_ffn`` at the widest shape its gate admits (D = D_out =
   4096) with mixtral's F, also against the kernel pair (and, logged, both
   against the fp32 products), two calls bitwise equal, one hidden split
   (decode) or one cluster rank's hidden slice (prefill) dropped as a
   fault; ``flash_decode``'s
   partials mode with ``acc`` at the run's dtype limit and ``m``, ``l`` at
   the fp32 limit, a slice with no valid key, and the merge of four slices
   against the normalised kernel; deliberate faults (a dropped K tile, a
   dropped live row, offsets one row off, a dropped key, an invalid key
   read; for both decode kernels the first key of the second 64-key chunk
   and one whole chunk dropped; for every decode GMM form one K split of
   the decode body's plan dropped) must fail the bf16 limit. The op layer's kernels likewise:
   ``gmm_dual_act`` and ``gmm`` with every row live at the EP path's
   bucket shapes (a dropped K tile, a dropped last row), ``gmm_gather`` at
   the mesh path's layouts (NaN gap rows; a dropped K tile, a dropped live
   row, offsets one row off), the paged partials at the EP path's decode
   shapes (a request of length 0, NaN dead pages, 4 slices merged; a
   dropped key, a dead page read). Phase 3g's new attention shapes
   likewise: ``flash_attention`` at seamless's encoder (B 8, S = T 1024,
   16 heads of 64, K = H, non-causal; a dropped key tile of 64 must fail)
   and at zamba2's shared block (B 8, S 256, 32 heads of 64, K = H,
   causal), ``flash_decode`` at zamba2's decode (32 heads of 64, K = H). Then each kernel is timed beside its
   plain version and a PyTorch library call the port never makes, with its
   roofline bound; the four decode attention modes (split-KV bodies) also
   by their device time under ``torch.profiler`` beside SDPA's, with the
   GB/s of their live bytes and the times of the bodies they replaced; the
   nine decode GMM forms with the GB/s of the bytes they must move, their
   share of the bytes bound and their ratio to ``torch.bmm``, and every
   redesigned body beside the time of the body it replaced (the two bf16
   bodies of ``gmm_fused_ffn`` also beside the kernel pair, timed in the
   same run, and their share of the bound);
6. an ``{"analytic_figures": ...}`` line (phase 1's rows), a
   ``{"kernels": [...]}`` line (thirteen entries, each partials mode
   apart), the card line, and the final ``{"ok": true, "device": {...}}``
   line.

Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense tensor-core bf16 / fp32 non-tensor
# K columns a GMM fault drops: half of the bf16 prefill body's K stage of 64
# (csrc/gmm_ragged.cu WG_BK), a smaller fault than a whole stage dropped
GMM_BK = 32
# Recorded times of the bodies that redesigned ones replaced, constants
# copied from PERF.md section 6 (NVIDIA H100 80GB HBM3, 700.00 W), not
# measured by this script: the bf16 bodies the wgmma bodies replaced (the
# WMMA GMM, the CUDA-core flash attention), three runs each; the decode
# attention bodies the split-KV bodies replaced (one block per KV head and
# request), and the decode GMM body the TMA-ring body replaced (the skinny
# register-streaming body), the fastest and the slowest of six runs; the
# FMA bodies of gmm_fused_ffn the hidden-slice decode body and the cluster
# prefill body replaced, the fastest and the slowest of six runs. They
# are logged beside this run's times and go into no JSON line.
REPLACED_MS = {
    "gmm_dual_act_ragged decode": (1.949, 2.000),
    "gmm_ragged decode": (1.093, 1.120),
    "gmm_dual_act_gather ESP decode": (0.937, 0.969),
    "gmm_scatter ESP decode": (0.838, 0.853),
    "gmm_dual_act_gather mesh decode": (1.941, 1.995),
    "gmm_scatter mesh decode": (1.116, 1.143),
    "gmm_gather mesh decode": (1.150, 1.178),
    "gmm_dual_act decode": (2.306, 2.370),
    "gmm decode": (1.259, 1.280),
    "flash_decode_paged": (0.1795, 0.1876),
    "flash_decode_paged partials": (0.1933, 0.2331),
    "flash_decode": (0.1835, 0.1855),
    "flash_decode partials": (0.1821, 0.1845),
    "flash_attention": (1.4195, 1.4173, 1.4285),
    "gmm_dual_act_ragged prefill": (12.884, 12.965, 12.786),
    "gmm_ragged prefill": (7.053, 7.145, 7.773),
    "gmm_dual_act_gather ESP prefill": (9.886, 9.936, 9.996),
    "gmm_scatter ESP prefill": (6.036, 6.629, 6.679),
    "gmm_dual_act_gather mesh prefill": (13.411, 13.540, 13.443),
    "gmm_scatter mesh prefill": (7.203, 7.245, 7.763),
    "gmm_gather mesh prefill": (7.103, 7.100, 7.126),
    "gmm_dual_act prefill": (25.558, 25.701, 26.192),
    "gmm prefill": (16.214, 15.006, 15.436),
    "gmm_fused_ffn decode": (102.713, 103.279),
    "gmm_fused_ffn prefill": (1396.010, 1397.208),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean milliseconds per call over ``reps`` launches, CUDA events."""

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn, reps: int, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int = 20) -> float:
    """Device milliseconds per call of ``fn``: the time of every kernel,
    copy and fill it ran on the card over ``reps`` calls under
    ``torch.profiler`` (CUDA activity only), without the host's time to
    make the calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a profile may hold no device activity at all: measure again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages())
        if total > 0:
            return total / reps / 1e3
    raise AssertionError("torch.profiler recorded no device activity in three profiles")


def split_kernel_ptxas(report: dict) -> list[str]:
    """Registers and spill bytes of each split-KV decode kernel, from
    nvcc's ``-Xptxas -v`` report: "<library> <dtype> G<=<n> <mode>: ..."."""
    out = []
    for name in ("flash_decode", "flash_decode_paged"):
        what, spill = None, ""
        for line in report[name]["ptxas"].splitlines():
            m = re.search(r"split_kernelI(13__nv_bfloat16|f)Li(\d+)ELb([01])E", line)
            if "Compiling entry function" in line:
                what = (f"{name} {'bf16' if m.group(1) != 'f' else 'fp32'} G<={m.group(2)} "
                        f"{'partials' if m.group(3) == '1' else 'normalised'}") if m else None
            elif what and "spill" in line:
                spill = "/".join(re.findall(r"(\d+) bytes spill", line))
            elif what and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                out.append(f"{what}: {regs} registers, spills {spill or '0/0'}")
                what = None
    return out


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def held(torch, got, want, tol, what: str) -> dict:
    """Hold ``got`` against ``want`` elementwise at ``tol`` = (rtol, atol);
    raises on a miss. Returns the largest error and the excess (error over
    its limit, at most 1)."""
    from repro_torch.kernels.tolerance import excess

    torch.cuda.synchronize()
    ex = excess(got, want, *tol)
    if ex > 1.0:
        raise AssertionError(f"{what}: error is {ex:.3f} x its limit (rtol, atol) = {tol}")
    return {"max_abs_err": float((got.float() - want.float()).abs().max()), "excess": ex}


def caught(tol, faults: dict, what: str) -> dict:
    """The limit must fail every fault: a plain output computed with one
    deliberate mistake (``name -> (make, want)``). Returns each excess."""
    from repro_torch.kernels.tolerance import excess

    out = {}
    for name, (make, want) in faults.items():
        ex = excess(make(), want, *tol)
        if ex <= 1.0:
            raise AssertionError(f"{what}: the limit {tol} does not catch '{name}' "
                                 f"(excess {ex:.3f})")
        out[name] = ex
    return out


def _drop_k_tile(t):
    t = t.clone()
    t[..., :GMM_BK] = 0
    return t


def _drop_k_split(t, splits: int):
    """The last of ``splits`` K ranges of the decode body's plan (whole
    stages, at least two ranges) zeroed along the last axis: a split merge
    that loses one split's partials."""
    from repro_torch.kernels.gmm.ragged import DECODE_BK

    s = max(splits, 2)
    nk = -(-t.shape[-1] // DECODE_BK)
    t = t.clone()
    t[..., (s - 1) * -(-nk // s) * DECODE_BK:] = 0
    return t


def _drop_last_row(t):
    """Every group's last row zeroed: (G, C, ·) buckets with one row less."""
    t = t.clone()
    t[:, -1] = 0
    return t


def _weights(torch, gen, G, D, F, dt):
    """Random expert weights wg, wu (G, D, F) and wd (G, F, D) at scale 0.02."""
    return tuple((torch.randn(shape, generator=gen, device="cuda") * 0.02).to(dt)
                 for shape in ((G, D, F), (G, D, F), (G, F, D)))


# ---------------------------------------------------------------------------
# phase 5: kernels against their plain versions
# ---------------------------------------------------------------------------

def gmm_cells(torch, groups, dtype, timer, time_it: bool, G: int = 20, D: int = 6144,
              F: int = 10752):
    """gmm_dual_act_ragged and gmm_ragged at a path's bucket shapes (the
    main path's 20 slots, D=6144, F=10752 by default; ESP under the mesh:
    mixtral's 8 experts, F=16384) and row counts (``groups``: phase ->
    (capacity C, counts))."""
    from repro_torch.kernels.gmm import ragged as K
    from repro_torch.kernels.gmm import ref as R
    from repro_torch.kernels.tolerance import PLAIN, ROUNDING

    dt = getattr(torch, dtype)
    tol = PLAIN[dt]
    gen = torch.Generator(device="cuda").manual_seed(1)
    wg, wu, wd = _weights(torch, gen, G, D, F, dt)
    results = {}
    for phase, (C, counts, _) in groups.items():
        gs = torch.as_tensor(counts, dtype=torch.int32, device="cuda")
        x = torch.randn((G, C, D), generator=gen, device="cuda").to(dt)
        dead = torch.arange(C, device="cuda")[None, :] >= gs[:, None]
        x[dead] = float("nan")
        what = f"{phase} {dtype}"
        h = K.gmm_dual_act_ragged(x, wg, wu, gs)
        h_ref = R.gmm_dual_act_ragged(x, wg, wu, gs)
        hin = h_ref.clone()
        hin[dead] = float("nan")
        y = K.gmm_ragged(hin, wd, gs)
        y_ref = R.gmm_ragged(hin, wd, gs)
        cell = {"gmm_dual_act_ragged": held(torch, h, h_ref, tol, f"gmm_dual_act_ragged {what}"),
                "gmm_ragged": held(torch, y, y_ref, tol, f"gmm_ragged {what}")}
        if dt == torch.bfloat16:
            # the fp32 products of the same bf16 inputs: only the kernel's
            # output rounding may separate them
            ref32 = R.gmm_dual_act_ragged(x.float(), wg.float(), wu.float(), gs)
            cell["gmm_dual_act_ragged"]["excess_fp32_product"] = held(
                torch, h, ref32, ROUNDING, f"gmm_dual_act_ragged {what} vs fp32")["excess"]
            ref32 = R.gmm_ragged(hin.float(), wd.float(), gs)
            cell["gmm_ragged"]["excess_fp32_product"] = held(
                torch, y, ref32, ROUNDING, f"gmm_ragged {what} vs fp32")["excess"]
            del ref32
            short = (gs - 1).clamp(min=0).to(torch.int32)
            cell["gmm_dual_act_ragged"]["faults"] = caught(tol, {
                f"{phase}: K tile of {GMM_BK} dropped":
                    (lambda: R.gmm_dual_act_ragged(_drop_k_tile(x), wg, wu, gs), h_ref),
                f"{phase}: last live row dropped":
                    (lambda: R.gmm_dual_act_ragged(x, wg, wu, short), h_ref),
            }, f"gmm_dual_act_ragged {what}")
            cell["gmm_ragged"]["faults"] = caught(tol, {
                f"{phase}: K tile of {GMM_BK} dropped":
                    (lambda: R.gmm_ragged(_drop_k_tile(hin), wd, gs), y_ref),
                f"{phase}: last live row dropped":
                    (lambda: R.gmm_ragged(hin, wd, short), y_ref),
            }, f"gmm_ragged {what}")
            if C <= K.DECODE_ROWS:
                sd, ss = K.decode_splits(G, D, F, dt), K.decode_splits(G, F, D, dt)
                cell["gmm_dual_act_ragged"]["faults"].update(caught(tol, {
                    f"{phase}: one K split of {max(sd, 2)} dropped":
                        (lambda: R.gmm_dual_act_ragged(_drop_k_split(x, sd), wg, wu, gs), h_ref),
                }, f"gmm_dual_act_ragged {what}"))
                cell["gmm_ragged"]["faults"].update(caught(tol, {
                    f"{phase}: one K split of {max(ss, 2)} dropped":
                        (lambda: R.gmm_ragged(_drop_k_split(hin, ss), wd, gs), y_ref),
                }, f"gmm_ragged {what}"))
        if time_it:
            reps = 10 if phase == "decode" else 3
            xz = torch.nan_to_num(x)
            hz = torch.nan_to_num(hin)
            wgu = torch.cat([wg, wu], dim=2)
            isz = x.element_size()
            live_rows = int(counts.sum())
            live_groups = int((counts > 0).sum())
            for name, fn, plain, lib, nbytes, ops in (
                ("gmm_dual_act_ragged",
                 lambda: K.gmm_dual_act_ragged(xz, wg, wu, gs),
                 lambda: R.gmm_dual_act_ragged(xz, wg, wu, gs),
                 lambda: torch.bmm(xz, wgu),
                 isz * (live_rows * D + 2 * live_groups * D * F + G * C * F),
                 2 * 2 * live_rows * D * F),
                ("gmm_ragged",
                 lambda: K.gmm_ragged(hz, wd, gs),
                 lambda: R.gmm_ragged(hz, wd, gs),
                 lambda: torch.bmm(hz, wd),
                 isz * (live_rows * F + live_groups * F * D + G * C * D),
                 2 * live_rows * F * D),
            ):
                b_ms, b_by = bound(nbytes, ops, dtype)
                cell[name].update(
                    ms=timer(fn, reps), plain_ms=timer(plain, reps),
                    library_ms=timer(lib, reps), bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                    shape=f"G={G} C={C} D={D if name != 'gmm_ragged' else F} "
                          f"F={F if name != 'gmm_ragged' else D} sum(gs)={live_rows} "
                          f"live groups={live_groups}",
                )
            del xz, hz, wgu
        results[phase] = cell
        del x, h, h_ref, hin, y, y_ref
    del wg, wu, wd
    torch.cuda.empty_cache()
    return results


def padded_cells(torch, groups, dtype, timer, time_it: bool):
    """gmm_dual_act and gmm (padded, every row live) at the EP path's
    layer-0 bucket shapes (20 slots, D=6144, F=10752; capacity 8 at decode,
    820 at prefill): against their plain versions, the bf16 results also
    against the fp32 product; timed beside torch.bmm over the same
    buckets."""
    from repro_torch.kernels.gmm import gmm as K
    from repro_torch.kernels.gmm import ragged as KR
    from repro_torch.kernels.gmm import ref as R
    from repro_torch.kernels.tolerance import PLAIN, ROUNDING

    dt = getattr(torch, dtype)
    tol = PLAIN[dt]
    G, D, F = 20, 6144, 10752
    gen = torch.Generator(device="cuda").manual_seed(13)
    wg, wu, wd = _weights(torch, gen, G, D, F, dt)
    results = {}
    for phase, (C, _, _) in groups.items():
        x = torch.randn((G, C, D), generator=gen, device="cuda").to(dt)
        what = f"{phase} {dtype}"
        h = K.gmm_dual_act(x, wg, wu)
        h_ref = R.gmm_dual_act(x, wg, wu)
        y = K.gmm(h_ref, wd)
        y_ref = R.gmm(h_ref, wd)
        cell = {"gmm_dual_act": held(torch, h, h_ref, tol, f"gmm_dual_act {what}"),
                "gmm": held(torch, y, y_ref, tol, f"gmm {what}")}
        if dt == torch.bfloat16:
            ref32 = R.gmm_dual_act(x.float(), wg.float(), wu.float())
            cell["gmm_dual_act"]["excess_fp32_product"] = held(
                torch, h, ref32, ROUNDING, f"gmm_dual_act {what} vs fp32")["excess"]
            ref32 = R.gmm(h_ref.float(), wd.float())
            cell["gmm"]["excess_fp32_product"] = held(
                torch, y, ref32, ROUNDING, f"gmm {what} vs fp32")["excess"]
            del ref32
            cell["gmm_dual_act"]["faults"] = caught(tol, {
                f"{phase}: K tile of {GMM_BK} dropped":
                    (lambda: R.gmm_dual_act(_drop_k_tile(x), wg, wu), h_ref),
                f"{phase}: last row dropped":
                    (lambda: R.gmm_dual_act(_drop_last_row(x), wg, wu), h_ref),
            }, f"gmm_dual_act {what}")
            cell["gmm"]["faults"] = caught(tol, {
                f"{phase}: K tile of {GMM_BK} dropped":
                    (lambda: R.gmm(_drop_k_tile(h_ref), wd), y_ref),
                f"{phase}: last row dropped":
                    (lambda: R.gmm(_drop_last_row(h_ref), wd), y_ref),
            }, f"gmm {what}")
            if C <= KR.DECODE_ROWS:
                sd = KR.decode_splits(G, D, F, dt, every_row=True)
                ss = KR.decode_splits(G, F, D, dt, every_row=True)
                cell["gmm_dual_act"]["faults"].update(caught(tol, {
                    f"{phase}: one K split of {max(sd, 2)} dropped":
                        (lambda: R.gmm_dual_act(_drop_k_split(x, sd), wg, wu), h_ref),
                }, f"gmm_dual_act {what}"))
                cell["gmm"]["faults"].update(caught(tol, {
                    f"{phase}: one K split of {max(ss, 2)} dropped":
                        (lambda: R.gmm(_drop_k_split(h_ref, ss), wd), y_ref),
                }, f"gmm {what}"))
        if time_it:
            reps = 10 if phase == "decode" else 3
            wgu = torch.cat([wg, wu], dim=2)
            isz = x.element_size()
            for name, fn, plain, lib, nbytes, ops in (
                ("gmm_dual_act",
                 lambda: K.gmm_dual_act(x, wg, wu),
                 lambda: R.gmm_dual_act(x, wg, wu),
                 lambda: torch.bmm(x, wgu),
                 isz * (G * C * D + 2 * G * D * F + G * C * F),
                 2 * 2 * G * C * D * F),
                ("gmm",
                 lambda: K.gmm(h_ref, wd),
                 lambda: R.gmm(h_ref, wd),
                 lambda: torch.bmm(h_ref, wd),
                 isz * (G * C * F + G * F * D + G * C * D),
                 2 * G * C * F * D),
            ):
                b_ms, b_by = bound(nbytes, ops, dtype)
                cell[name].update(
                    ms=timer(fn, reps), plain_ms=timer(plain, reps),
                    library_ms=timer(lib, reps), bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                    shape=f"G={G} C={C} D={D if name == 'gmm_dual_act' else F} "
                          f"F={F if name == 'gmm_dual_act' else D}, every row live",
                )
            del wgu
        results[phase] = cell
        del x, h, h_ref, y, y_ref
    del wg, wu, wd
    torch.cuda.empty_cache()
    return results


def paged_inputs(torch, dt, seed: int = 2):
    """The EP path's paged decode shapes: 8 requests of 257-288 tokens, 48
    query heads over 8 KV heads of 128, pages of 128, 8 blocks each from a
    scrambled pool. Returns q, the pools with every row past each request's
    length NaN (dead rows of the last live page and every dead page),
    tables, lengths, and the pools as drawn (no NaN)."""
    B, H, KV, hd, bs, NB = 8, 48, 8, 128, 128, 8
    P = B * NB + 1
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, H, hd), generator=gen, device="cuda").to(dt)
    pool_k = torch.randn((P, bs, KV, hd), generator=gen, device="cuda").to(dt)
    pool_v = torch.randn((P, bs, KV, hd), generator=gen, device="cuda").to(dt)
    lengths = torch.randint(257, 289, (B,), generator=gen, device="cuda").to(torch.int32)
    tables = torch.randperm(P - 1, generator=gen, device="cuda")[: B * NB]
    tables = tables.reshape(B, NB).to(torch.int32).contiguous()
    clean_k, clean_v = pool_k.clone(), pool_v.clone()
    for b in range(B):
        n = int(lengths[b])
        for j in range(NB):
            lo = max(0, n - j * bs)
            if lo < bs:
                page = int(tables[b, j])
                pool_k[page, lo:] = float("nan")
                pool_v[page, lo:] = float("nan")
    return q, pool_k, pool_v, tables, lengths, clean_k, clean_v


def decode_cell(torch, dtype, timer, time_it: bool):
    """flash_decode_paged at the main path's decode shapes: 8 requests,
    48 query heads over 8 KV heads of 128, pages of 128, 8 blocks each."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_decode import paged as K
    from repro_torch.kernels.flash_decode import ref as R
    from repro_torch.kernels.tolerance import PLAIN

    dt = getattr(torch, dtype)
    tol = PLAIN[dt]
    q, pool_k, pool_v, tables, lengths, _, _ = paged_inputs(torch, dt)
    B, H, hd = q.shape
    _, bs, KV, _ = pool_k.shape
    NB = tables.shape[1]
    want = R.paged_decode(q, pool_k, pool_v, tables, lengths)
    cell = held(torch, K.flash_decode_paged(q, pool_k, pool_v, tables, lengths), want,
                tol, f"flash_decode_paged {dtype}")
    if dt == torch.bfloat16:
        # the split kernel's chunk edges, built on the gathered pages
        k_all, v_all = R.gather_pages(pool_k, tables), R.gather_pages(pool_v, tables)
        live = torch.arange(NB * bs, device="cuda")[None, :] < lengths[:, None]
        one, chunk = live.clone(), live.clone()
        one[:, K.CHUNK] = False
        chunk[:, K.CHUNK:2 * K.CHUNK] = False
        cell["faults"] = caught(tol, {
            "last live key dropped":
                (lambda: R.paged_decode(q, pool_k, pool_v, tables, lengths - 1), want),
            "first key of the second chunk dropped":
                (lambda: R.decode(q, k_all, v_all, one), want),
            "one whole chunk dropped": (lambda: R.decode(q, k_all, v_all, chunk), want),
        }, f"flash_decode_paged {dtype}")
    if time_it:
        isz = q.element_size()
        live = int(lengths.sum())
        nbytes = isz * (2 * B * H * hd + 2 * live * KV * hd)
        ops = 4 * live * H * hd
        b_ms, b_by = bound(nbytes, ops, dtype)
        T = NB * bs
        kd = torch.nan_to_num(R.gather_pages(pool_k, tables)).transpose(1, 2).contiguous()
        vd = torch.nan_to_num(R.gather_pages(pool_v, tables)).transpose(1, 2).contiguous()
        mask = (torch.arange(T, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        def kernel():
            return K.flash_decode_paged(q, pool_k, pool_v, tables, lengths)

        def library():
            return Fn.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask, enable_gqa=True)

        cell.update(
            ms=timer(kernel, 50),
            plain_ms=timer(lambda: R.paged_decode(q, pool_k, pool_v, tables, lengths), 20),
            library_ms=timer(library, 50),
            device_ms=device_ms(torch, kernel), library_device_ms=device_ms(torch, library),
            live_bytes=nbytes, bound_ms=b_ms, bound_by=b_by,
            shape=f"B={B} H={H} K={KV} hd={hd} bs={bs} NB={NB} sum(len)={live}",
        )
    return cell


def attention_cell(torch, dtype, timer, time_it: bool, B=8, S=256, H=48, KV=8, hd=128,
                   causal=True, seed=3):
    """flash_attention at a served prefill shape, by default the main
    path's: 8 x 256 tokens, 48 query heads over 8 KV heads of 128, causal
    (phase 3g adds seamless's non-causal encoder and zamba2's MHA block).
    Also a shorter query block at the tail of the keys (causal: with a
    window of 64)."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_attention import flash_attention as K
    from repro_torch.kernels.flash_attention import ref as R
    from repro_torch.kernels.tolerance import PLAIN

    dt = getattr(torch, dtype)
    tol = PLAIN[dt]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dt)
    want = R.mha(q, k, v, causal=causal)
    mode = "causal" if causal else "non-causal"
    what = f"flash_attention {mode} H={H} K={KV} hd={hd} {dtype}"
    cell = held(torch, K.flash_attention(q, k, v, causal=causal), want, tol, what)
    qt = q[:, -100:].contiguous()
    window = 64 if causal else 0
    tail = held(torch, K.flash_attention(qt, k, v, causal=causal, window=window),
                R.mha(qt, k, v, causal=causal, window=window), tol, f"{what} tail")
    cell = {key: max(cell[key], tail[key]) for key in cell}
    if dt == torch.bfloat16:
        if causal:
            # queries 1.. without their own (diagonal) key
            faults = {"diagonal key dropped":
                      (lambda: R.mha(q[:, 1:], k[:, :-1], v[:, :-1]), want[:, 1:])}
        else:
            faults = {"the last key tile of 64 dropped":
                      (lambda: R.mha(q, k[:, :-64], v[:, :-64], causal=False), want)}
        cell["faults"] = caught(tol, faults, what)
    if time_it:
        isz = q.element_size()
        pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S
        nbytes = isz * (2 * B * S * H * hd + 2 * B * S * KV * hd)
        ops = 4 * hd * pairs
        b_ms, b_by = bound(nbytes, ops, dtype)
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        cell.update(
            ms=timer(lambda: K.flash_attention(q, k, v, causal=causal), 20),
            plain_ms=timer(lambda: R.mha(q, k, v, causal=causal), 20),
            library_ms=timer(lambda: Fn.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=True), 20),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"B={B} S=T={S} H={H} K={KV} hd={hd} {mode}",
        )
    return cell


def _flat_live(torch, offsets, counts, n_rows):
    """(R,) mask of the rows inside live bucket segments."""
    live = torch.zeros(n_rows, dtype=torch.bool, device="cuda")
    for o, c in zip(offsets.tolist(), counts.tolist()):
        live[o : o + c] = True
    return live


def _nan_rows(torch, shape, dt):
    return torch.full(shape, float("nan"), dtype=dt, device="cuda")


def pair_cells(torch, rows, D, F, dtype, timer, time_it: bool, gather: bool = False):
    """gmm_dual_act_gather and gmm_scatter at one main path's expert widths
    (D, F) and the flat-row layouts it served (``rows``: phase -> (R,
    capacity, offsets, counts, groups_per_weight); the weights have one row
    per ``groups_per_weight`` groups): mixtral's 8 experts (ESP) and
    dbrx's 20 slots (the mesh path's fused branch, rows compacted per
    source rank). Gap rows of the flat input and every row of the flat
    output outside the live segments start as NaN; the latter must still
    be NaN after the scatter. With ``gather``, also gmm_gather (the single
    product over the gathered rows, into padded buckets) on wg."""
    from repro_torch.kernels.gmm import ragged as K
    from repro_torch.kernels.gmm import ref as R
    from repro_torch.kernels.tolerance import PLAIN, ROUNDING

    dt = getattr(torch, dtype)
    tol = PLAIN[dt]
    _, _, _, counts0, gpw = rows["decode"]
    G = len(counts0) // gpw
    gen = torch.Generator(device="cuda").manual_seed(6)
    wg, wu, wd = _weights(torch, gen, G, D, F, dt)
    results = {}
    for phase, (n_rows, cap, offsets, counts, gpw) in rows.items():
        off = torch.as_tensor(offsets, dtype=torch.int32, device="cuda")
        gs = torch.as_tensor(counts, dtype=torch.int32, device="cuda")
        live = _flat_live(torch, off, gs, n_rows)
        x = torch.randn((n_rows, D), generator=gen, device="cuda").to(dt)
        x[~live] = float("nan")
        what = f"{phase} {dtype}"
        h = K.gmm_dual_act_gather(x, wg, wu, off, gs, cap, gpw)
        h_ref = R.gmm_dual_act_gather(x, wg, wu, off, gs, cap, gpw)
        hin = h_ref.clone()
        dead = torch.arange(cap, device="cuda")[None, :] >= gs[:, None]
        hin[dead] = float("nan")
        y = K.gmm_scatter(hin, wd, off, gs, n_rows, gpw, out=_nan_rows(torch, (n_rows, D), dt))
        y_ref = R.gmm_scatter(hin, wd, off, gs, n_rows, gpw)
        if not bool(torch.isnan(y[~live]).all()):
            raise AssertionError(f"gmm_scatter {what}: a row outside the live segments was written")
        cell = {"gmm_dual_act_gather": held(torch, h, h_ref, tol, f"gmm_dual_act_gather {what}"),
                "gmm_scatter": held(torch, y[live], y_ref[live], tol, f"gmm_scatter {what}")}
        if gather:
            y1 = K.gmm_gather(x, wg, off, gs, cap, gpw)
            y1_ref = R.gmm_gather(x, wg, off, gs, cap, gpw)
            cell["gmm_gather"] = held(torch, y1, y1_ref, tol, f"gmm_gather {what}")
        if dt == torch.bfloat16:
            ref32 = R.gmm_dual_act_gather(x.float(), wg.float(), wu.float(), off, gs, cap, gpw)
            cell["gmm_dual_act_gather"]["excess_fp32_product"] = held(
                torch, h, ref32, ROUNDING, f"gmm_dual_act_gather {what} vs fp32")["excess"]
            ref32 = R.gmm_scatter(hin.float(), wd.float(), off, gs, n_rows, gpw)
            cell["gmm_scatter"]["excess_fp32_product"] = held(
                torch, y[live], ref32[live], ROUNDING, f"gmm_scatter {what} vs fp32")["excess"]
            del ref32
            short = (gs - 1).clamp(min=0).to(torch.int32)
            off1 = (off + 1).to(torch.int32)
            cell["gmm_dual_act_gather"]["faults"] = caught(tol, {
                f"{phase}: K tile of {GMM_BK} dropped":
                    (lambda: R.gmm_dual_act_gather(_drop_k_tile(x), wg, wu, off, gs, cap, gpw),
                     h_ref),
                f"{phase}: last live row dropped":
                    (lambda: R.gmm_dual_act_gather(x, wg, wu, off, short, cap, gpw), h_ref),
                f"{phase}: offsets one row off":
                    (lambda: R.gmm_dual_act_gather(x, wg, wu, off1, gs, cap, gpw), h_ref),
            }, f"gmm_dual_act_gather {what}")
            cell["gmm_scatter"]["faults"] = caught(tol, {
                f"{phase}: K tile of {GMM_BK} dropped":
                    (lambda: R.gmm_scatter(_drop_k_tile(hin), wd, off, gs, n_rows, gpw)[live],
                     y_ref[live]),
                f"{phase}: last live row dropped":
                    (lambda: R.gmm_scatter(hin, wd, off, short, n_rows, gpw)[live], y_ref[live]),
                f"{phase}: offsets one row off":
                    (lambda: R.gmm_scatter(hin, wd, off1, gs, n_rows, gpw)[live], y_ref[live]),
            }, f"gmm_scatter {what}")
            if cap <= K.DECODE_ROWS:
                ng = len(counts)
                sd, ss = K.decode_splits(ng, D, F, dt), K.decode_splits(ng, F, D, dt)
                drop = f"{phase}: one K split of {max(sd, 2)} dropped"
                cell["gmm_dual_act_gather"]["faults"].update(caught(tol, {
                    drop: (lambda: R.gmm_dual_act_gather(_drop_k_split(x, sd), wg, wu, off, gs,
                                                         cap, gpw), h_ref),
                }, f"gmm_dual_act_gather {what}"))
                cell["gmm_scatter"]["faults"].update(caught(tol, {
                    f"{phase}: one K split of {max(ss, 2)} dropped":
                        (lambda: R.gmm_scatter(_drop_k_split(hin, ss), wd, off, gs, n_rows,
                                               gpw)[live], y_ref[live]),
                }, f"gmm_scatter {what}"))
            if gather:
                ref32 = R.gmm_gather(x.float(), wg.float(), off, gs, cap, gpw)
                cell["gmm_gather"]["excess_fp32_product"] = held(
                    torch, y1, ref32, ROUNDING, f"gmm_gather {what} vs fp32")["excess"]
                del ref32
                cell["gmm_gather"]["faults"] = caught(tol, {
                    f"{phase}: K tile of {GMM_BK} dropped":
                        (lambda: R.gmm_gather(_drop_k_tile(x), wg, off, gs, cap, gpw), y1_ref),
                    f"{phase}: last live row dropped":
                        (lambda: R.gmm_gather(x, wg, off, short, cap, gpw), y1_ref),
                    f"{phase}: offsets one row off":
                        (lambda: R.gmm_gather(x, wg, off1, gs, cap, gpw), y1_ref),
                }, f"gmm_gather {what}")
                if cap <= K.DECODE_ROWS:
                    cell["gmm_gather"]["faults"].update(caught(tol, {
                        drop: (lambda: R.gmm_gather(_drop_k_split(x, sd), wg, off, gs, cap, gpw),
                               y1_ref),
                    }, f"gmm_gather {what}"))
        if time_it:
            reps = 10 if phase == "decode" else 3
            xz = torch.nan_to_num(x)
            hz = torch.nan_to_num(hin)
            # the library call: one bmm per weight row over its groups'
            # padded buckets
            buckets = R.gather_buckets(xz, off, gs, cap).reshape(G, gpw * cap, D)
            hb = hz.reshape(G, gpw * cap, F)
            wgu = torch.cat([wg, wu], dim=2)
            isz = x.element_size()
            live_rows = int(gs.sum())
            live_groups = int((gs.reshape(G, gpw).sum(1) > 0).sum())   # weight rows read
            timed = [
                ("gmm_gather",
                 lambda: K.gmm_gather(xz, wg, off, gs, cap, gpw),
                 lambda: R.gmm_gather(xz, wg, off, gs, cap, gpw),
                 lambda: torch.bmm(buckets, wg),
                 isz * (live_rows * D + live_groups * D * F + len(counts) * cap * F),
                 2 * live_rows * D * F),
            ] if gather else []
            for name, fn, plain, lib, nbytes, ops in timed + [
                ("gmm_dual_act_gather",
                 lambda: K.gmm_dual_act_gather(xz, wg, wu, off, gs, cap, gpw),
                 lambda: R.gmm_dual_act_gather(xz, wg, wu, off, gs, cap, gpw),
                 lambda: torch.bmm(buckets, wgu),
                 isz * (live_rows * D + 2 * live_groups * D * F + len(counts) * cap * F),
                 2 * 2 * live_rows * D * F),
                ("gmm_scatter",
                 lambda: K.gmm_scatter(hz, wd, off, gs, n_rows, gpw),
                 lambda: R.gmm_scatter(hz, wd, off, gs, n_rows, gpw),
                 lambda: torch.bmm(hb, wd),
                 isz * (live_rows * F + live_groups * F * D + live_rows * D),
                 2 * live_rows * F * D),
            ]:
                b_ms, b_by = bound(nbytes, ops, dtype)
                cell[name].update(
                    ms=timer(fn, reps), plain_ms=timer(plain, reps),
                    library_ms=timer(lib, reps), bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                    shape=f"G={len(counts)} cap={cap} R={n_rows} "
                          f"D={D if name != 'gmm_scatter' else F} "
                          f"F={F if name != 'gmm_scatter' else D} sum(gs)={live_rows} "
                          f"live weight rows={live_groups} of {G}",
                )
            del xz, hz, buckets, hb, wgu
        results[phase] = cell
        del x, h, h_ref, hin, y, y_ref
        if gather:
            del y1, y1_ref
    del wg, wu, wd
    torch.cuda.empty_cache()
    return results


def _drop_hidden_rows(wd, lo: int, hi: int):
    """w_down with hidden rows [lo, hi) zeroed: the FFN without those hidden
    columns' contribution."""
    wd = wd.clone()
    wd[:, lo:hi] = 0
    return wd


def _fused_truth(torch, x, wg, wu, wd, off, gs, cap):
    """The live rows of the SwiGLU FFN in float64 with the hidden values
    rounded to x.dtype, as every bf16 version stores them: (live rows,
    D_out), group by group."""
    out = []
    for g, (o, c) in enumerate(zip(off.tolist(), gs.clamp(max=cap).tolist())):
        if c <= 0:
            continue
        xs = x[o : o + c].double()
        h = torch.nn.functional.silu(xs @ wg[g].double()) * (xs @ wu[g].double())
        out.append(h.to(x.dtype).double() @ wd[g].double())
    return torch.cat(out)


def _fused_slice_ms(torch, timer, x, wg, wu, wd, off, gs, cap, fs: int, reps: int) -> float:
    """Time of the bf16 decode body with hidden slices of ``fs`` columns
    instead of the planned width (the plan's own launch, its slice argument
    replaced): the measurement behind ``fused_decode_slice``."""
    from repro_torch.kernels import build
    from repro_torch.kernels.gmm import ragged as K

    fn = build.entry("gmm_fused_ffn", "gmm_fused_ffn_launch", 9, 9)

    def call():
        out, _, _, ints = K._fused_plan(x, wg, wu, wd, off, gs, cap, 1)
        g, f, d_out = ints[0], ints[3], ints[4]
        s = -(-f // fs)
        part = (torch.empty(s * g * cap * d_out, dtype=torch.float32, device="cuda")
                if s > 1 else None)
        arrived = build.arrival_counters(x.device, g * -(-d_out // K.FUSED_OUT_STRIP))
        build.check(fn(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                       off.data_ptr(), gs.data_ptr(), out.data_ptr(),
                       None if part is None else part.data_ptr(), arrived.data_ptr(),
                       *ints[:-1], fs, torch.cuda.current_stream().cuda_stream),
                    f"gmm_fused_ffn slice {fs}")

    return timer(call, reps, warmup=1)


def fused_cells(torch, rows, dtype, timer, time_it: bool):
    """gmm_fused_ffn at the widest shape its gate admits (D = D_out = 4096)
    with mixtral's F = 16384 and the ESP main path's flat-row layouts:
    against its plain version and against the kernel pair, live rows only;
    every other output row must still be NaN, and two calls must be
    bitwise equal. bf16 also against the fp32 products of the same inputs
    (the hidden tensor rounded to bf16 between them, as the kernel keeps
    it), and one hidden split of the decode body's plan, or one cluster
    rank's 64-column hidden slice of the prefill body's first block,
    dropped as a fault."""
    from repro_torch.kernels.gmm import ragged as K
    from repro_torch.kernels.gmm import ref as R
    from repro_torch.kernels.registry import FUSED_FFN_MAX_DOWN_DIM, can_gmm_fused
    from repro_torch.kernels.tolerance import PLAIN, ROUNDING, excess

    dt = getattr(torch, dtype)
    tol = PLAIN[dt]
    G, D, F = 8, FUSED_FFN_MAX_DOWN_DIM, 16384
    if not can_gmm_fused(8, D, F, dt):
        raise AssertionError(f"the fused gate refuses D={D}, F={F}")
    gen = torch.Generator(device="cuda").manual_seed(7)
    wg, wu, wd = _weights(torch, gen, G, D, F, dt)
    results = {}
    for phase, (n_rows, cap, offsets, counts, _) in rows.items():
        off = torch.as_tensor(offsets, dtype=torch.int32, device="cuda")
        gs = torch.as_tensor(counts, dtype=torch.int32, device="cuda")
        live = _flat_live(torch, off, gs, n_rows)
        x = torch.randn((n_rows, D), generator=gen, device="cuda").to(dt)
        x[~live] = float("nan")
        body = K.fused_body(cap, dt)
        what = f"gmm_fused_ffn {phase} {dtype}"
        y = K.gmm_fused_ffn(x, wg, wu, wd, off, gs, cap, out=_nan_rows(torch, (n_rows, D), dt))
        again = K.gmm_fused_ffn(x, wg, wu, wd, off, gs, cap,
                                out=_nan_rows(torch, (n_rows, D), dt))
        torch.cuda.synchronize()
        if not (bool(torch.isnan(y[~live]).all()) and bool(torch.isnan(again[~live]).all())):
            raise AssertionError(f"{what}: a row outside the live segments was written")
        if not torch.equal(y[live], again[live]):
            raise AssertionError(f"{what}: two calls differ")
        del again
        y_ref = R.gmm_fused_ffn(x, wg, wu, wd, off, gs, cap)
        pair = K.gmm_scatter(K.gmm_dual_act_gather(x, wg, wu, off, gs, cap), wd, off, gs, n_rows)
        cell = held(torch, y[live], y_ref[live], tol, what)
        cell["excess_vs_pair"] = held(torch, y[live], pair[live], tol, f"{what} vs pair")["excess"]
        cell["body"] = body
        if dt == torch.bfloat16:
            # logged, not held: at these reduction lengths the bf16 tensor-core
            # products (the pair's as much as this kernel's) read above the
            # rounding limit against fp32 (PERF.md); the card tests hold
            # both bodies to it at their shapes
            h32 = R.gmm_dual_act_gather(x.float(), wg.float(), wu.float(), off, gs, cap)
            want32 = R.gmm_scatter(h32.to(dt).float(), wd.float(), off, gs, n_rows)
            cell["excess_fp32_product"] = excess(y[live], want32[live], *ROUNDING)
            cell["pair_excess_fp32_product"] = excess(pair[live], want32[live], *ROUNDING)
            truth = _fused_truth(torch, x, wg, wu, wd, off, gs, cap)
            cell["excess_float64"] = {
                name: excess(v, truth, *ROUNDING)
                for name, v in (("kernel", y[live]), ("pair", pair[live]),
                                ("fp32 products", want32[live]))}
            del h32, want32, truth
        del pair
        if dt == torch.bfloat16:
            short = (gs - 1).clamp(min=0).to(torch.int32)
            off1 = (off + 1).to(torch.int32)
            if body == "decode":
                fs = K.fused_decode_slice(G, F)
                s = -(-F // fs)
                drop = (f"{phase}: one hidden split of {s} dropped", (s - 1) * fs, F)
            else:
                lo = (K.FUSED_RANKS - 1) * 64
                drop = (f"{phase}: cluster rank {K.FUSED_RANKS - 1}'s hidden slice of the "
                        "first block dropped", lo, lo + 64)
            wd_drop = _drop_hidden_rows(wd, drop[1], drop[2])
            cell["faults"] = caught(tol, {
                f"{phase}: K tile of {GMM_BK} dropped":
                    (lambda: R.gmm_fused_ffn(_drop_k_tile(x), wg, wu, wd, off, gs, cap)[live],
                     y_ref[live]),
                f"{phase}: last live row dropped":
                    (lambda: R.gmm_fused_ffn(x, wg, wu, wd, off, short, cap)[live], y_ref[live]),
                f"{phase}: offsets one row off":
                    (lambda: R.gmm_fused_ffn(x, wg, wu, wd, off1, gs, cap)[live], y_ref[live]),
                drop[0]:
                    (lambda: R.gmm_fused_ffn(x, wg, wu, wd_drop, off, gs, cap)[live],
                     y_ref[live]),
            }, what)
            del wd_drop
        if time_it:
            reps = 10 if phase == "decode" else 5
            xz = torch.nan_to_num(x)
            isz = x.element_size()
            live_rows = int(gs.sum())
            live_groups = int((gs > 0).sum())
            b_ms, b_by = bound(isz * (2 * live_rows * D + 3 * live_groups * D * F),
                               2 * 3 * live_rows * D * F, dtype)
            plan = (f"hidden slices of {K.fused_decode_slice(G, F)}" if body == "decode" else
                    f"clusters of {K.FUSED_RANKS} CTAs" if body == "cluster" else "FMA tiles")
            cell.update(
                ms=timer(lambda: K.gmm_fused_ffn(xz, wg, wu, wd, off, gs, cap), reps, warmup=1),
                plain_ms=timer(lambda: R.gmm_fused_ffn(xz, wg, wu, wd, off, gs, cap), reps,
                               warmup=1),
                pair_ms=timer(lambda: K.gmm_scatter(K.gmm_dual_act_gather(
                    xz, wg, wu, off, gs, cap), wd, off, gs, n_rows), reps, warmup=1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                shape=f"G={G} cap={cap} R={n_rows} D=D_out={D} F={F} sum(gs)={live_rows} "
                      f"live groups={live_groups}, {body} body ({plan})",
            )
            if body == "decode":
                cell["slice_ms"] = {fs: _fused_slice_ms(torch, timer, xz, wg, wu, wd, off, gs,
                                                        cap, fs, reps)
                                    for fs in K.FUSED_SLICES}
            del xz
        results[phase] = cell
        del x, y, y_ref
    del wg, wu, wd
    torch.cuda.empty_cache()
    return results


def dense_decode_cell(torch, dtype, timer, time_it: bool, H=48, KV=8, hd=128):
    """flash_decode at a served decode shape, by default the ESP main
    path's: 8 requests, 48 query heads over 8 KV heads of 128 (phase 3g
    adds zamba2's 32 heads of 64, K = H), a dense cache of max_seq 1024
    slots, valid prefixes of the served lengths (257-288 keys); every
    invalid K/V row holds NaN."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_decode import flash_decode as K
    from repro_torch.kernels.flash_decode import ref as R
    from repro_torch.kernels.flash_decode.paged import CHUNK
    from repro_torch.kernels.tolerance import PLAIN

    dt = getattr(torch, dtype)
    tol = PLAIN[dt]
    B, T = 8, 1024
    gen = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((B, H, hd), generator=gen, device="cuda").to(dt)
    k0 = torch.randn((B, T, KV, hd), generator=gen, device="cuda").to(dt)
    v0 = torch.randn((B, T, KV, hd), generator=gen, device="cuda").to(dt)
    lengths = torch.randint(257, 289, (B,), generator=gen, device="cuda")
    valid = (torch.arange(T, device="cuda")[None, :] < lengths[:, None]).to(torch.int32)
    k, v = k0.clone(), v0.clone()
    k[valid == 0] = float("nan")
    v[valid == 0] = float("nan")
    want = R.decode(q, k, v, valid.bool())
    what = f"flash_decode H={H} K={KV} hd={hd} {dtype}"
    cell = held(torch, K.flash_decode(q, k, v, valid), want, tol, what)
    if dt == torch.bfloat16:
        dropped, extra = valid.clone(), valid.clone()
        dropped[0, 100] = 0
        extra[0, int(lengths[0])] = 1
        one, chunk = valid.bool(), valid.bool()   # the split kernel's chunk edges
        one[:, CHUNK] = False
        chunk[:, CHUNK:2 * CHUNK] = False
        cell["faults"] = caught(tol, {
            "one valid key dropped": (lambda: R.decode(q, k, v, dropped.bool()), want),
            "one invalid key read": (lambda: R.decode(q, k0, v0, extra.bool()), want),
            "first key of the second chunk dropped": (lambda: R.decode(q, k, v, one), want),
            "one whole chunk dropped": (lambda: R.decode(q, k, v, chunk), want),
        }, what)
    if time_it:
        isz = q.element_size()
        live = int(lengths.sum())
        nbytes = isz * (2 * B * H * hd + 2 * live * KV * hd) + 4 * B * T
        b_ms, b_by = bound(nbytes, 4 * live * H * hd, dtype)
        kz, vz = k0, v0
        kd, vd = kz.transpose(1, 2).contiguous(), vz.transpose(1, 2).contiguous()
        mask = valid.bool()[:, None, None, :]
        q4 = q[:, :, None, :]
        def kernel():
            return K.flash_decode(q, kz, vz, valid)

        def library():
            return Fn.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask, enable_gqa=True)

        cell.update(
            ms=timer(kernel, 50),
            plain_ms=timer(lambda: R.decode(q, kz, vz, valid.bool()), 20),
            library_ms=timer(library, 50),
            device_ms=device_ms(torch, kernel), library_device_ms=device_ms(torch, library),
            live_bytes=nbytes, bound_ms=b_ms, bound_by=b_by,
            shape=f"B={B} H={H} K={KV} hd={hd} T={T} sum(valid)={live}",
        )
    return cell


def partials_cell(torch, dtype, timer, time_it: bool):
    """flash_decode's partials mode at the mesh path's decode shapes: 8
    requests, 48 query heads over 8 KV heads of 128, one rank's slice of a
    1024-slot cache (all of it on the 1 x 1 mesh), valid prefixes of the
    served lengths (257-288 keys); every invalid K/V row holds NaN. acc is
    held at the run's dtype limit, m and l at the fp32 limit (every rank's
    merge weight e^(m - m_max) depends on them); a request with no valid
    key must give m = -1e30, l = 0, acc = 0; four slices merged must give
    the normalised kernel's output."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_decode import flash_decode as K
    from repro_torch.kernels.flash_decode import ref as R
    from repro_torch.kernels.tolerance import PLAIN

    dt = getattr(torch, dtype)
    tol, tol32 = PLAIN[dt], PLAIN[torch.float32]
    B, H, KV, hd, T = 8, 48, 8, 128, 1024
    gen = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((B, H, hd), generator=gen, device="cuda").to(dt)
    k0 = torch.randn((B, T, KV, hd), generator=gen, device="cuda").to(dt)
    v0 = torch.randn((B, T, KV, hd), generator=gen, device="cuda").to(dt)
    lengths = torch.randint(257, 289, (B,), generator=gen, device="cuda")
    valid = (torch.arange(T, device="cuda")[None, :] < lengths[:, None]).to(torch.int32)
    k, v = k0.clone(), v0.clone()
    k[valid == 0] = float("nan")
    v[valid == 0] = float("nan")
    what = f"flash_decode partials {dtype}"
    acc, m, l = K.flash_decode_partials(q, k, v, valid)
    acc_r, m_r, l_r = R.decode_partials(q, k, v, valid.bool())
    cell = held(torch, acc, acc_r, tol, f"{what} acc")
    cell["excess_m"] = held(torch, m, m_r, tol32, f"{what} m")["excess"]
    cell["excess_l"] = held(torch, l, l_r, tol32, f"{what} l")["excess"]
    empty = valid.clone()
    empty[0] = 0
    acc_e, m_e, l_e = K.flash_decode_partials(q, k, v, empty)
    torch.cuda.synchronize()
    if not (bool((m_e[0] == -1e30).all()) and bool((l_e[0] == 0).all())
            and bool((acc_e[0] == 0).all())):
        raise AssertionError(f"{what}: a request with no valid key is not (acc, m, l) = "
                             f"(0, -1e30, 0)")
    held(torch, acc_e[1:], acc_r[1:], tol, f"{what} beside an empty request")
    slices = [K.flash_decode_partials(q, k[:, i:i + T // 4].contiguous(),
                                      v[:, i:i + T // 4].contiguous(),
                                      valid[:, i:i + T // 4].contiguous())
              for i in range(0, T, T // 4)]
    merged = R.merge_partials_local(slices).to(dt)
    cell["excess_merge_vs_normalised"] = held(
        torch, merged, K.flash_decode(q, k, v, valid), tol,
        f"{what}: 4 slices merged vs the normalised kernel")["excess"]
    if dt == torch.bfloat16:
        dropped, extra = valid.clone(), valid.clone()
        dropped[0, 100] = 0
        extra[0, int(lengths[0])] = 1
        cell["faults"] = caught(tol, {
            "one valid key dropped (acc)":
                (lambda: R.decode_partials(q, k, v, dropped.bool())[0], acc_r),
            "one invalid key read (acc)":
                (lambda: R.decode_partials(q, k0, v0, extra.bool())[0], acc_r),
        }, f"{what} acc")
        cell["faults"].update(caught(tol32, {
            "one valid key dropped (l)":
                (lambda: R.decode_partials(q, k, v, dropped.bool())[2], l_r),
            "one invalid key read (l)":
                (lambda: R.decode_partials(q, k0, v0, extra.bool())[2], l_r),
        }, f"{what} l"))
    if time_it:
        isz = q.element_size()
        live = int(lengths.sum())
        nbytes = isz * (B * H * hd + 2 * live * KV * hd) + 4 * B * T + 4 * (B * H * hd + 2 * B * H)
        b_ms, b_by = bound(nbytes, 4 * live * H * hd, dtype)
        kd, vd = k0.transpose(1, 2).contiguous(), v0.transpose(1, 2).contiguous()
        mask = valid.bool()[:, None, None, :]
        q4 = q[:, :, None, :]
        def kernel():
            return K.flash_decode_partials(q, k0, v0, valid)

        def library():
            return Fn.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask, enable_gqa=True)

        cell.update(
            ms=timer(kernel, 50),
            plain_ms=timer(lambda: R.decode_partials(q, k0, v0, valid.bool()), 20),
            normalised_ms=timer(lambda: K.flash_decode(q, k0, v0, valid), 50),
            library_ms=timer(library, 50),
            device_ms=device_ms(torch, kernel), library_device_ms=device_ms(torch, library),
            live_bytes=nbytes,
            library_note="SDPA's normalised output at the same shape: no PyTorch call "
                         "returns the (m, l) partials",
            bound_ms=b_ms, bound_by=b_by,
            shape=f"B={B} H={H} K={KV} hd={hd} T_local={T} sum(valid)={live}",
        )
    return cell


def paged_slices(torch, tables, lengths, bs: int, n: int = 4):
    """The block table cut into ``n`` runs of NB / n pages of ``bs`` keys,
    each with the lengths clipped to it: [(tables, lengths)] per slice."""
    span = tables.shape[1] // n * bs
    return [(tables[:, i * span // bs:(i + 1) * span // bs].contiguous(),
             (lengths - i * span).clamp(0, span).to(torch.int32)) for i in range(n)]


def paged_partials_cell(torch, dtype, timer, time_it: bool):
    """flash_decode_paged's partials mode at the EP path's paged decode
    shapes (``paged_inputs``: every row past a request's length NaN). acc
    is held at the run's dtype limit, m and l at the fp32 limit; a request
    of length 0 must give (acc, m, l) = (0, -1e30, 0); the table cut into
    4 slices of NB/4 pages (lengths clipped per slice, so most requests
    have empty slices) must merge to the normalised paged kernel's
    output."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_decode import paged as K
    from repro_torch.kernels.flash_decode import ref as R
    from repro_torch.kernels.tolerance import PLAIN

    dt = getattr(torch, dtype)
    tol, tol32 = PLAIN[dt], PLAIN[torch.float32]
    q, pk, pv, tables, lengths, pk0, pv0 = paged_inputs(torch, dt, seed=14)
    B, H, hd = q.shape
    _, bs, KV, _ = pk.shape
    NB = tables.shape[1]
    what = f"flash_decode_paged partials {dtype}"
    acc, m, l = K.flash_decode_paged(q, pk, pv, tables, lengths, return_partials=True)
    acc_r, m_r, l_r = R.paged_decode_partials(q, pk, pv, tables, lengths)
    cell = held(torch, acc, acc_r, tol, f"{what} acc")
    cell["excess_m"] = held(torch, m, m_r, tol32, f"{what} m")["excess"]
    cell["excess_l"] = held(torch, l, l_r, tol32, f"{what} l")["excess"]
    empty = lengths.clone()
    empty[0] = 0
    acc_e, m_e, l_e = K.flash_decode_paged_partials(q, pk, pv, tables, empty)
    torch.cuda.synchronize()
    if not (bool((m_e[0] == -1e30).all()) and bool((l_e[0] == 0).all())
            and bool((acc_e[0] == 0).all())):
        raise AssertionError(f"{what}: a request of length 0 is not (acc, m, l) = "
                             f"(0, -1e30, 0)")
    held(torch, acc_e[1:], acc_r[1:], tol, f"{what} beside an empty request")
    parts = [K.flash_decode_paged_partials(q, pk, pv, tb, ln)
             for tb, ln in paged_slices(torch, tables, lengths, bs)]
    merged = R.merge_partials_local(parts).to(dt)
    cell["excess_merge_vs_normalised"] = held(
        torch, merged, K.flash_decode_paged(q, pk, pv, tables, lengths), tol,
        f"{what}: 4 slices merged vs the normalised kernel")["excess"]
    if dt == torch.bfloat16:
        # one key short; and request 0 reading on through the rest of its
        # last page and one dead page (values as drawn, no NaN)
        ext = lengths.clone()
        ext[0] = min(NB * bs, (int(lengths[0]) // bs + 2) * bs)
        faults = {
            "last live key dropped": lambda: R.paged_decode_partials(
                q, pk, pv, tables, lengths - 1),
            "a dead page read": lambda: R.paged_decode_partials(q, pk0, pv0, tables, ext),
        }
        cell["faults"] = caught(tol, {f"{k} (acc)": (lambda f=f: f()[0], acc_r)
                                      for k, f in faults.items()}, f"{what} acc")
        cell["faults"].update(caught(tol32, {f"{k} (l)": (lambda f=f: f()[2], l_r)
                                             for k, f in faults.items()}, f"{what} l"))
    if time_it:
        isz = q.element_size()
        live = int(lengths.sum())
        nbytes = (isz * (B * H * hd + 2 * live * KV * hd) + 4 * (B * NB + B)
                  + 4 * (B * H * hd + 2 * B * H))
        b_ms, b_by = bound(nbytes, 4 * live * H * hd, dtype)
        T = NB * bs
        kd = R.gather_pages(pk0, tables).transpose(1, 2).contiguous()
        vd = R.gather_pages(pv0, tables).transpose(1, 2).contiguous()
        mask = (torch.arange(T, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        def kernel():
            return K.flash_decode_paged_partials(q, pk, pv, tables, lengths)

        def library():
            return Fn.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask, enable_gqa=True)

        cell.update(
            ms=timer(kernel, 50),
            plain_ms=timer(lambda: R.paged_decode_partials(q, pk, pv, tables, lengths), 20),
            normalised_ms=timer(lambda: K.flash_decode_paged(q, pk, pv, tables, lengths), 50),
            library_ms=timer(library, 50),
            device_ms=device_ms(torch, kernel), library_device_ms=device_ms(torch, library),
            live_bytes=nbytes,
            library_note="SDPA's normalised output over the gathered pages: no PyTorch "
                         "call returns the (m, l) partials",
            bound_ms=b_ms, bound_by=b_by,
            shape=f"B={B} H={H} K={KV} hd={hd} bs={bs} NB={NB} sum(len)={live}",
        )
    return cell


# ---------------------------------------------------------------------------
# phases 2-4: serving and the op layer
# ---------------------------------------------------------------------------

def small_parity(torch):
    """A small fp32 MoE served on the card twice — CUDA kernels vs plain
    PyTorch path — must give the same greedy tokens."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = dataclasses.replace(smoke(get_config("dbrx-132b")), head_dim=32)
    prompt = torch.randint(0, cfg.vocab_size, (4, 12),
                           generator=torch.Generator().manual_seed(4))
    outs = []
    for uk in ("auto", False):
        params = T.init_params(cfg, seed=5, device="cuda")
        srv = Server(cfg, ParallelCtx(capacity_factor=8.0, use_kernels=uk), params,
                     ServeConfig(max_seq=64, batch=4, slots_per_device=3,
                                 virtual_ep=4, alpha=0.1, paged=True, page_size=32),
                     device="cuda")
        outs.append((srv.generate(prompt, 12).cpu(), srv.migrations))
    if not torch.equal(outs[0][0], outs[1][0]):
        raise AssertionError(f"kernel vs plain tokens differ:\n{outs[0][0]}\n{outs[1][0]}")
    return outs[0][1]


def small_esp_parity(torch) -> dict:
    """A small fp32 mixtral-family model (window 32 kept) served with ESP on
    the dense cache, kernels vs plain path: 12-token prompts and 24 new
    tokens wrap the ring. Returns the kernel run's launches of the two
    kernels only this path takes."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.kernels.flash_decode.flash_decode import flash_decode
    from repro_torch.kernels.gmm.ragged import gmm_fused_ffn
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = dataclasses.replace(smoke(get_config("mixtral-8x22b")), head_dim=32)
    prompt_len, n_new = 12, 24
    if prompt_len + n_new <= cfg.sliding_window:
        raise AssertionError("the small ESP run must wrap the window's ring")
    prompt = torch.randint(0, cfg.vocab_size, (4, prompt_len),
                           generator=torch.Generator().manual_seed(9))
    outs, launched = [], {}
    for uk in ("auto", False):
        for k in (gmm_fused_ffn, flash_decode):
            k.launches = 0
        params = T.init_params(cfg, seed=10, device="cuda")
        srv = Server(cfg, ParallelCtx(moe_impl="esp", capacity_factor=2.0, use_kernels=uk),
                     params, ServeConfig(max_seq=64, batch=4, paged=False), device="cuda")
        outs.append(srv.generate(prompt, n_new).cpu())
        if uk == "auto":
            launched = {k.__name__: k.launches for k in (gmm_fused_ffn, flash_decode)}
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError(f"ESP kernel vs plain tokens differ:\n{outs[0]}\n{outs[1]}")
    want = {"gmm_fused_ffn": cfg.n_layers * (1 + n_new), "flash_decode": cfg.n_layers * n_new}
    if launched != want:
        raise AssertionError(f"small ESP launches {launched} != {want}")
    return launched


def force_migration(srv) -> tuple[int, int, int]:
    """Submit one stepped replication through ``apply_plan``: the first
    expert that has no replica on some device with a free slot."""
    table = srv.table
    for e in range(table.n_experts):
        src = table.device_of(int(table.slot_of[e, 0]))
        for dst in range(srv.ep):
            if (table.slot_on_device(e, dst) is None and table.free_slot(dst) is not None
                    and srv.apply_plan([(e, src, dst)]) == 1):
                return e, src, dst
    raise AssertionError("no expert could be replicated: no free slot is left")


def timed_generate(torch, srv, prompt, n_new: int, embeds=None):
    """``srv.generate`` (with the frontend stub's ``embeds``, if any) with
    CUDA events at its start, after its prefill and at its end. Returns the
    tokens, the prefill's logits, the prefill time (TTFT) and the decode
    loop's time, in seconds."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    kept = {}
    prefill = srv.prefill

    def prefill_marked(*args, **kwargs):
        logits, cache = prefill(*args, **kwargs)
        events[1].record()
        kept["logits"] = logits
        return logits, cache

    srv.prefill = prefill_marked
    try:
        torch.cuda.synchronize()
        events[0].record()
        out = srv.generate(prompt, n_new, embeds=embeds)
        events[2].record()
        torch.cuda.synchronize()
    finally:
        del srv.prefill
    return (out, kept["logits"], events[0].elapsed_time(events[1]) / 1e3,
            events[1].elapsed_time(events[2]) / 1e3)


def expert_groups(torch, srv, prompt) -> dict:
    """Layer 0's expert groups in one prefill and one decode tick of the
    main-path server, after its timed run (committed replicas included):
    phase -> (bucket capacity, counts, a copy of the dispatched (G, C, D)
    buckets)."""
    from repro_torch.kernels import registry

    seen = []
    ffn = registry.expert_ffn
    first = {"call": True}    # copy only layer 0's buckets of each phase

    def spy(x, wg, wu, wd, group_sizes, *args):
        seen.append((x.shape[1], group_sizes.cpu().numpy(),
                     x.clone() if first["call"] else None))
        first["call"] = False
        return ffn(x, wg, wu, wd, group_sizes, *args)

    registry.expert_ffn = spy
    try:
        logits, cache = srv.prefill(prompt)
        n_prefill = len(seen)
        first["call"] = True
        srv.decode(torch.argmax(logits[:, -1:], dim=-1), cache)
    finally:
        registry.expert_ffn = ffn
    return {"decode": seen[n_prefill], "prefill": seen[0]}


def main_path(torch, card: str):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.data import request_stream
    from repro_torch.runtime.serve import ServeConfig, Server

    n_layers, batch, prompt_len, n_new = 4, 8, 256, 32
    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    scfg = ServeConfig(max_seq=1024, batch=batch, slots_per_device=5, virtual_ep=4,
                       paged=True, page_size=128)
    srv = Server(cfg, ParallelCtx(), params, scfg, device="cuda")
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompt = next(request_stream(cfg.vocab_size, batch, prompt_len, seed=0))
    # Force one stepped migration before the balancer plans its own: its
    # slices land one per decode tick and it commits at a step boundary.
    forced = force_migration(srv)
    srv.generate(prompt, 2)     # warm-up: first-call costs stay out of the timed run
    kernels = (*ep_kernels(), *op_layer_kernels())
    for k in kernels:
        k.launches = 0
    migs_before = srv.migrations
    out, logits, ttft_s, decode_s = timed_generate(torch, srv, prompt, n_new)
    committed = srv.migrations - migs_before
    launches = {k.__name__: k.launches for k in kernels}
    per_step_moe = n_layers * scfg.ep_chunks
    predicted = {
        "gmm_dual_act_ragged": per_step_moe * (1 + n_new),
        "gmm_ragged": per_step_moe * (1 + n_new),
        "flash_decode_paged": n_layers * n_new,
        "flash_attention": n_layers,
        **{k.__name__: 0 for k in op_layer_kernels()},
    }
    if launches != predicted:
        raise AssertionError(f"launch counts {launches} != predicted {predicted}")
    out_cpu = out.cpu()
    if out_cpu.shape != (batch, n_new) or int(out_cpu.min()) < 0 or \
            int(out_cpu.max()) >= cfg.vocab_size:
        raise AssertionError(f"tokens out of range: shape {tuple(out_cpu.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite prefill logits")
    if committed < 1 or srv.driver.pending:
        raise AssertionError(
            f"{committed} migrations committed in the timed run, "
            f"pending={srv.driver.pending}"
        )
    srv.table.check()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    groups = expert_groups(torch, srv, prompt)
    profile = profile_decode(torch, srv, prompt, card)
    tok_s = batch * n_new / decode_s
    log(
        f"main path: dbrx-132b width, {n_layers} layers, bf16, {batch} x "
        f"{prompt_len}-token prompts -> {n_new} decode steps (after a warm-up "
        f"run): setup {setup_s:.2f}s, TTFT (prefill) {ttft_s * 1e3:.1f} ms, decode "
        f"{decode_s * 1e3:.1f} ms = {tok_s:.1f} tok/s, peak memory {peak_gb:.2f} GB, "
        f"forced migration {forced}, migrations committed in the timed run "
        f"{committed} of {srv.migrations} (history "
        f"{[r['mig'] for r in srv.driver.history]}), launches {launches}, "
        f"layer-0 expert rows prefill {groups['prefill'][1].tolist()} decode "
        f"{groups['decode'][1].tolist()} [{card}]"
    )
    return launches, groups, {
        "ttft_ms": ttft_s * 1e3, "decode_ms": decode_s * 1e3, "decode_tok_s": tok_s,
        "peak_gb": peak_gb, "migrations": committed, **profile}


def flat_rows(torch, srv, prompt) -> dict:
    """Layer 0's flat-row layout in one prefill and one decode tick of a
    main-path server that serves its experts from flat rows (ESP, or EP's
    fused branch under a mesh): phase -> (rows R, capacity, offsets,
    counts, groups_per_weight)."""
    from repro_torch.kernels import registry

    seen = []
    ffn = registry.expert_ffn_from_rows

    def spy(x, wg, wu, wd, offsets, group_sizes, *, capacity, **kw):
        seen.append((x.shape[0], capacity, offsets.cpu().numpy(), group_sizes.cpu().numpy(),
                     kw.get("groups_per_weight", 1)))
        return ffn(x, wg, wu, wd, offsets, group_sizes, capacity=capacity, **kw)

    registry.expert_ffn_from_rows = spy
    try:
        logits, cache = srv.prefill(prompt)
        n_prefill = len(seen)
        srv.decode(torch.argmax(logits[:, -1:], dim=-1), cache)
    finally:
        registry.expert_ffn_from_rows = ffn
    return {"decode": seen[n_prefill], "prefill": seen[0]}


def esp_path(torch, card: str):
    """The second main path: mixtral-8x22b width with ESP on the dense
    cache. Returns the launches of every kernel, layer 0's row layouts and
    the run's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode.paged import flash_decode_paged
    from repro_torch.kernels.gmm import ragged as K
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.data import request_stream
    from repro_torch.runtime.serve import ServeConfig, Server

    n_layers, batch, prompt_len, n_new = 4, 8, 256, 32
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    scfg = ServeConfig(max_seq=1024, batch=batch, paged=False)
    srv = Server(cfg, ParallelCtx(moe_impl="esp"), params, scfg, device="cuda")
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompt = next(request_stream(cfg.vocab_size, batch, prompt_len, seed=0))
    srv.generate(prompt, 2)     # warm-up: first-call costs stay out of the timed run
    kernels = (K.gmm_dual_act_gather, K.gmm_scatter, K.gmm_fused_ffn, flash_decode,
               flash_attention, K.gmm_dual_act_ragged, K.gmm_ragged, flash_decode_paged,
               *op_layer_kernels())
    for k in kernels:
        k.launches = 0
    out, logits, ttft_s, decode_s = timed_generate(torch, srv, prompt, n_new)
    launches = {k.__name__: k.launches for k in kernels}
    predicted = {
        # d_model 6144 > FUSED_FFN_MAX_DOWN_DIM: the pair, as the reference
        "gmm_dual_act_gather": n_layers * (1 + n_new),
        "gmm_scatter": n_layers * (1 + n_new),
        "gmm_fused_ffn": 0,
        "flash_decode": n_layers * n_new,
        "flash_attention": n_layers,
        "gmm_dual_act_ragged": 0, "gmm_ragged": 0, "flash_decode_paged": 0,
        **{k.__name__: 0 for k in op_layer_kernels()},
    }
    if launches != predicted:
        raise AssertionError(f"ESP launch counts {launches} != predicted {predicted}")
    out_cpu = out.cpu()
    if out_cpu.shape != (batch, n_new) or int(out_cpu.min()) < 0 or \
            int(out_cpu.max()) >= cfg.vocab_size:
        raise AssertionError(f"ESP tokens out of range: shape {tuple(out_cpu.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite ESP prefill logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = flat_rows(torch, srv, prompt)
    profile = profile_decode(torch, srv, prompt, card)
    tok_s = batch * n_new / decode_s
    log(
        f"ESP path: mixtral-8x22b width, {n_layers} layers, bf16, dense cache (max_seq "
        f"{scfg.max_seq}), {batch} x {prompt_len}-token prompts -> {n_new} decode steps "
        f"(after a warm-up run): setup {setup_s:.2f}s, TTFT (prefill) {ttft_s * 1e3:.1f} ms, "
        f"decode {decode_s * 1e3:.1f} ms = {tok_s:.1f} tok/s, peak memory {peak_gb:.2f} GB, "
        f"launches {launches}, layer-0 expert rows prefill {rows['prefill'][3].tolist()} "
        f"(R={rows['prefill'][0]}, cap={rows['prefill'][1]}) decode "
        f"{rows['decode'][3].tolist()} (R={rows['decode'][0]}, cap={rows['decode'][1]}) [{card}]"
    )
    return launches, rows, {
        "ttft_ms": ttft_s * 1e3, "decode_ms": decode_s * 1e3, "decode_tok_s": tok_s,
        "peak_gb": peak_gb, **profile}


def small_mesh_parity(torch, mesh) -> dict:
    """A small fp32 dbrx-family model served on the 1 x 1 NCCL mesh (EP
    through ``ep_moe_shardmap``, the dense cache through the partials
    kernel and the LSE merge, the balancer live on virtual EP), capacity
    factor 8.0 so no copy is dropped: greedy tokens with the kernels must
    equal the plain path's and the no-mesh EP Server's (at ep = 1 both
    size their buckets alike). Returns the kernel run's partials
    launches and the migrations."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.kernels.flash_decode.flash_decode import flash_decode_partials
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = dataclasses.replace(smoke(get_config("dbrx-132b")), head_dim=32)
    n_new = 12
    prompt = torch.randint(0, cfg.vocab_size, (4, 12),
                           generator=torch.Generator().manual_seed(11))
    scfg = ServeConfig(max_seq=64, batch=4, slots_per_device=3, virtual_ep=4, alpha=0.1)
    runs = {}
    for name, ctx in (
        ("mesh kernels", ParallelCtx(mesh=mesh, capacity_factor=8.0)),
        ("mesh plain", ParallelCtx(mesh=mesh, capacity_factor=8.0, use_kernels=False)),
        ("no-mesh ep", ParallelCtx(moe_impl="ep", capacity_factor=8.0)),
    ):
        flash_decode_partials.launches = 0
        params = T.init_params(cfg, seed=12, device="cuda")
        srv = Server(cfg, ctx, params, scfg, device="cuda")
        runs[name] = (srv.generate(prompt, n_new).cpu(), srv.migrations,
                      flash_decode_partials.launches)
    want = runs["mesh kernels"]
    for name, got in runs.items():
        if not torch.equal(got[0], want[0]) or got[1] != want[1]:
            raise AssertionError(f"small mesh model: {name} tokens/migrations differ from "
                                 f"the kernel run's:\n{got[0]} ({got[1]})\n{want[0]} ({want[1]})")
    if want[2] != cfg.n_layers * n_new or runs["mesh plain"][2] or runs["no-mesh ep"][2]:
        raise AssertionError(f"small mesh model partials launches "
                             f"{ {k: r[2] for k, r in runs.items()} }")
    return {"flash_decode_partials": want[2], "migrations": want[1]}


def small_mesh_snapshot(torch, mesh) -> dict:
    """Phase 2's small mesh model (fp32, the kernels) through the
    scheduler on the 1 x 1 NCCL mesh (paged, page 8, chunked admission of
    8, the balancer live on virtual EP 4 x 3 slots), crashed at tick 3:
    the world checks the snapshot, rank 0 writes the file, the crashed
    scheduler is dropped and one restored from the file on the mesh
    serves on. Every request finishes, and every stream equals the same
    model's no-mesh EP run, uninterrupted."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config, smoke
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime import faults as F
    from repro_torch.runtime import snapshot as S
    from repro_torch.runtime.scheduler import FINISHED, RequestScheduler
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = dataclasses.replace(smoke(get_config("dbrx-132b")), head_dim=32)
    prompts = scheduled_prompts(cfg.vocab_size, 6, 8, 32)
    scfg = ServeConfig(max_seq=64, batch=4, slots_per_device=3, virtual_ep=4, alpha=0.1,
                       paged=True, page_size=8, prefill_chunk=8)
    mctx = ParallelCtx(mesh=mesh, capacity_factor=8.0)

    def params():
        return T.init_params(cfg, seed=12, device="cuda")

    def sched(ctx, plan=None):
        s = RequestScheduler(Server(cfg, ctx, params(), scfg, device="cuda"), faults=plan)
        for i, p in enumerate(prompts):
            s.submit(p, 8, arrival=i)
        return s

    want = sched(ParallelCtx(moe_impl="ep", capacity_factor=8.0)).run()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "snap.npz")
        plan = F.FaultPlan([F.Fault(step=3, kind=F.CRASH_RESTART, path=path)])
        try:
            sched(mctx, plan).run()
            raise AssertionError("small mesh snapshot: the crash never fired")
        except F.SimulatedCrash as exc:
            tick = exc.step
        gc.collect()
        restored = S.restore_scheduler(path, cfg, mctx, params(), faults=plan, device="cuda")
        got = restored.run()
    bad = [rid for rid in want if not np.array_equal(got.get(rid), want[rid])]
    if got.keys() != want.keys() or bad:
        raise AssertionError(f"small mesh snapshot: streams {bad} restored on the mesh differ "
                             f"from the no-mesh run's")
    left = [r.rid for r in restored.requests if r.state != FINISHED]
    if left:
        raise AssertionError(f"small mesh snapshot: requests {left} did not finish")
    return {"crash_tick": tick, "requests": len(want),
            "migrations_after_restore": restored.server.migrations}


def mesh_path(torch, mesh, card: str):
    """The third main path: dbrx-132b width on the 1 x 1 NCCL mesh, the
    dense cache of max_seq 1024 sliced over the model axis (all of it on
    one rank), decode through the partials kernel and the all-reduce LSE
    merge, EP through ``ep_moe_shardmap``'s all-to-all legs, the balancer
    live with one forced stepped migration. Returns the launches of every
    kernel, layer 0's row layouts (rank-compacted, as the fused branch
    receives them) and the run's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode as FD
    from repro_torch.kernels.flash_decode.paged import flash_decode_paged
    from repro_torch.kernels.gmm import ragged as K
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.data import request_stream
    from repro_torch.runtime.serve import ServeConfig, Server

    n_layers, batch, prompt_len, n_new = 4, 8, 256, 32
    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    scfg = ServeConfig(max_seq=1024, batch=batch, slots_per_device=5, virtual_ep=4,
                       paged=False)
    srv = Server(cfg, ParallelCtx(mesh=mesh), params, scfg, device="cuda")
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompt = next(request_stream(cfg.vocab_size, batch, prompt_len, seed=0))
    forced = force_migration(srv)
    srv.generate(prompt, 2)     # warm-up: first-call costs stay out of the timed run
    kernels = (FD.flash_decode_partials, FD.flash_decode, flash_attention,
               K.gmm_dual_act_gather, K.gmm_scatter, K.gmm_fused_ffn,
               K.gmm_dual_act_ragged, K.gmm_ragged, flash_decode_paged,
               *op_layer_kernels())
    for k in kernels:
        k.launches = 0
    migs_before = srv.migrations
    out, logits, ttft_s, decode_s = timed_generate(torch, srv, prompt, n_new)
    committed = srv.migrations - migs_before
    launches = {k.__name__: k.launches for k in kernels}
    per_step_moe = n_layers * scfg.ep_chunks
    predicted = {
        "flash_decode_partials": n_layers * n_new,
        "flash_decode": 0,
        "flash_attention": n_layers,
        # the fused branch at d_model 6144 > FUSED_FFN_MAX_DOWN_DIM: the pair
        "gmm_dual_act_gather": per_step_moe * (1 + n_new),
        "gmm_scatter": per_step_moe * (1 + n_new),
        "gmm_fused_ffn": 0, "gmm_dual_act_ragged": 0, "gmm_ragged": 0,
        "flash_decode_paged": 0,
        **{k.__name__: 0 for k in op_layer_kernels()},
    }
    if launches != predicted:
        raise AssertionError(f"mesh launch counts {launches} != predicted {predicted}")
    out_cpu = out.cpu()
    if out_cpu.shape != (batch, n_new) or int(out_cpu.min()) < 0 or \
            int(out_cpu.max()) >= cfg.vocab_size:
        raise AssertionError(f"mesh tokens out of range: shape {tuple(out_cpu.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite mesh prefill logits")
    if committed < 1 or srv.driver.pending:
        raise AssertionError(f"{committed} migrations committed in the timed mesh run, "
                             f"pending={srv.driver.pending}")
    srv.table.check()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = flat_rows(torch, srv, prompt)
    profile = profile_decode(torch, srv, prompt, card)
    tok_s = batch * n_new / decode_s
    log(
        f"mesh path: dbrx-132b width, {n_layers} layers, bf16, 1 x 1 NCCL mesh, dense cache "
        f"(max_seq {scfg.max_seq}), {batch} x {prompt_len}-token prompts -> {n_new} decode "
        f"steps (after a warm-up run): setup {setup_s:.2f}s, TTFT (prefill) "
        f"{ttft_s * 1e3:.1f} ms, decode {decode_s * 1e3:.1f} ms = {tok_s:.1f} tok/s, peak "
        f"memory {peak_gb:.2f} GB, forced migration {forced}, migrations committed in the "
        f"timed run {committed} of {srv.migrations}, launches {launches}, layer-0 expert "
        f"rows prefill {rows['prefill'][3].tolist()} (R={rows['prefill'][0]}, "
        f"cap={rows['prefill'][1]}) decode {rows['decode'][3].tolist()} "
        f"(R={rows['decode'][0]}, cap={rows['decode'][1]}) [{card}]"
    )
    return launches, rows, {
        "ttft_ms": ttft_s * 1e3, "decode_ms": decode_s * 1e3, "decode_tok_s": tok_s,
        "peak_gb": peak_gb, "migrations": committed, **profile}


def op_layer_kernels():
    """The four kernels only the op layer reaches (as in the reference):
    each served path must launch them no time."""
    from repro_torch.kernels.flash_decode.paged import flash_decode_paged_partials
    from repro_torch.kernels.gmm.gmm import gmm, gmm_dual_act
    from repro_torch.kernels.gmm.ragged import gmm_gather

    return (gmm_dual_act, gmm, gmm_gather, flash_decode_paged_partials)


def op_layer_path(torch, groups, rows, card: str):
    """The fourth path: the kernel op layer, driven through its entry
    points at the served shapes in bf16, after the servers are freed.
    ``ops.expert_ffn`` (padded: gmm_dual_act + gmm over every row) on the
    EP path's dispatched layer-0 buckets of one prefill and one decode
    tick, with 20 random expert weights at dbrx's widths;
    ``ops.gmm_gather_op`` at the mesh path's rank-compacted layer-0
    layouts (NaN gap rows); the paged decode at the EP path's shapes cut
    into 4 slices of NB/4 pages through ``flash_decode_paged``'s partials
    mode, LSE-merged. Every kernel's count is set to 0 just before and read
    just after. Then: the padded FFN's live rows equal
    ``registry.expert_ffn``'s (ragged) on the same buckets within the bf16
    limit and its dead rows are exact zeros (the buckets' dead rows are);
    gmm_gather equals its plain version; the merge equals the normalised
    paged kernel's output."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode as FD
    from repro_torch.kernels.flash_decode import ref as FR
    from repro_torch.kernels.flash_decode.paged import flash_decode_paged
    from repro_torch.kernels.gmm import ops
    from repro_torch.kernels.gmm import ragged as K
    from repro_torch.kernels.gmm import ref as R
    from repro_torch.kernels.tolerance import PLAIN

    dt, tol = torch.bfloat16, PLAIN[torch.bfloat16]
    G, D, F = 20, 6144, 10752
    gen = torch.Generator(device="cuda").manual_seed(15)
    wg, wu, wd = _weights(torch, gen, G, D, F, dt)
    flat = {}
    for phase, (n_rows, cap, offsets, counts, gpw) in rows.items():
        off = torch.as_tensor(offsets, dtype=torch.int32, device="cuda")
        gs = torch.as_tensor(counts, dtype=torch.int32, device="cuda")
        x = torch.randn((n_rows, D), generator=gen, device="cuda").to(dt)
        x[~_flat_live(torch, off, gs, n_rows)] = float("nan")
        flat[phase] = (x, off, gs, cap, gpw)
    q, pk, pv, tables, lengths, _, _ = paged_inputs(torch, dt, seed=16)
    slices = paged_slices(torch, tables, lengths, pk.shape[1])
    served = (K.gmm_dual_act_ragged, K.gmm_ragged, K.gmm_dual_act_gather, K.gmm_scatter,
              K.gmm_fused_ffn, flash_decode_paged, FD.flash_decode,
              FD.flash_decode_partials, flash_attention)
    kernels = (*op_layer_kernels(), *served)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    ffn = {phase: ops.expert_ffn(xb, wg, wu, wd) for phase, (_, _, xb) in groups.items()}
    gathered = {phase: ops.gmm_gather_op(x, wg[: G // gpw], off, gs, cap, gpw)
                for phase, (x, off, gs, cap, gpw) in flat.items()}
    parts = [flash_decode_paged(q, pk, pv, tb, ln, return_partials=True) for tb, ln in slices]
    merged = FR.merge_partials_local(parts).to(dt)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k.__name__: k.launches for k in kernels}
    predicted = {"gmm_dual_act": len(groups), "gmm": len(groups), "gmm_gather": len(rows),
                 "flash_decode_paged_partials": len(slices),
                 **{k.__name__: 0 for k in served}}
    if launches != predicted:
        raise AssertionError(f"op-layer launch counts {launches} != predicted {predicted}")
    excess = {}
    for phase, (C, counts, xb) in groups.items():
        gs = torch.as_tensor(counts, dtype=torch.int32, device="cuda")
        live = torch.arange(C, device="cuda")[None, :] < gs[:, None]
        ragged = registry.expert_ffn(xb, wg, wu, wd, gs)
        excess[f"expert_ffn {phase} vs registry.expert_ffn"] = held(
            torch, ffn[phase][live], ragged[live], tol,
            f"op layer: padded expert_ffn {phase} vs the ragged registry FFN")["excess"]
        if not bool((ffn[phase][~live] == 0).all()):
            raise AssertionError(f"op layer: padded expert_ffn {phase}: a dead row is not 0")
    for phase, (x, off, gs, cap, gpw) in flat.items():
        excess[f"gmm_gather_op {phase} vs plain"] = held(
            torch, gathered[phase], R.gmm_gather(x, wg[: G // gpw], off, gs, cap, gpw), tol,
            f"op layer: gmm_gather_op {phase}")["excess"]
    excess["paged partials, 4 slices merged vs normalised"] = held(
        torch, merged, flash_decode_paged(q, pk, pv, tables, lengths), tol,
        "op layer: paged partials merged")["excess"]
    log(f"op-layer path (bf16, after the servers are freed): padded expert_ffn on the EP "
        f"path's layer-0 buckets {[tuple(g[2].shape) for g in groups.values()]}, "
        f"gmm_gather_op at the mesh path's layouts "
        f"{[(r[0], r[1]) for r in rows.values()]} (R, cap), paged decode in "
        f"{len(slices)} slices merged: {wall_ms:.1f} ms wall, launches {launches}; error "
        f"over the bf16 limit {tol}: "
        + "; ".join(f"{k} {v:.3g}" for k, v in excess.items()) + f" [{card}]")
    del wg, wu, wd, flat, ffn, gathered, parts, merged
    torch.cuda.empty_cache()
    return launches, excess


def profiled_ms(torch, prof) -> tuple[dict, dict]:
    """Device ms by kernel and host self ms by op of a finished profile."""
    by_name, host = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host[e.key] = host.get(e.key, 0.0) + e.self_cpu_time_total / 1e3
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    return by_name, host


def profile_decode(torch, srv, prompt, card: str, steps: int = 8, embeds=None) -> dict:
    """Device busy share and time by kernel over ``steps`` decode steps of
    the main-path server (a separate window from the timed run)."""
    from torch.profiler import ProfilerActivity, profile

    logits, cache = srv.prefill(prompt, embeds=embeds)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    for _ in range(2):
        logits, cache = srv.decode(tok, cache)
        tok = torch.argmax(logits[:, -1:], dim=-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = srv.decode(tok, cache)
            tok = torch.argmax(logits[:, -1:], dim=-1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, host = profiled_ms(torch, prof)
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    # host side: the ops with the most self CPU time, and the collectives'
    comm_ms = sum(ms for key, ms in host.items()
                  if re.search(r"c10d|nccl|gloo|all_to_all|allreduce|all_reduce", key))
    host_top = sorted(host.items(), key=lambda kv: -kv[1])[:5]
    log(f"profile: {steps} decode steps in {wall_ms:.1f} ms wall, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%); by kernel: "
        + "; ".join(f"{name[:48]} {ms:.2f} ms" for name, ms in top) + "; host self time: "
        f"collectives {comm_ms:.2f} ms, top ops "
        + "; ".join(f"{name[:40]} {ms:.2f} ms" for name, ms in host_top) + f" [{card}]")
    return {"profile_step_ms": wall_ms / steps, "device_busy_share": busy_ms / wall_ms,
            "host_collectives_ms": comm_ms}


# ---------------------------------------------------------------------------
# phase 3d: serving under faults through the RequestScheduler
# ---------------------------------------------------------------------------

# The chaos plan's seed: under it all five fault kinds fire within the run
# and at least one request is preempted, on the full-width path and on the
# small fp32 model (asserted below, never assumed).
CHAOS_SEED = 5
FAULT_KINDS = {"device_death", "device_revival", "straggler", "pool_pressure",
               "nan_logits"}


def chaos_plan(seed: int = CHAOS_SEED):
    """One death of a device in 1-3 and its revival with blank rows, a
    straggler report, 6 pool pages stolen and returned, one NaN step on
    batch slot 0; every fault drawn within 24 ticks."""
    from repro_torch.runtime.faults import FaultPlan

    return FaultPlan.chaos(seed, n_steps=24, n_devices=4, pressure_pages=6,
                           nan_slots=(0,), revive=True)


def scheduled_prompts(vocab: int, n: int, lo: int, hi: int, seed: int = 0) -> list:
    """``n`` prompts of lengths drawn in ``[lo, hi]`` from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(k)).astype(np.int32)
            for k in rng.integers(lo, hi + 1, size=n)]


def run_scheduler(torch, srv, prompts, n_new: int, plan=None, eos=None, kernels=(),
                  warm=(), crash_after=None, crash_path="", predict=None,
                  profile_ticks=None) -> dict:
    """Serve ``prompts`` through a ``RequestScheduler`` over ``srv`` under
    ``plan``: request i arrives at tick i // 2, request 0 stops at ``eos``.
    ``warm`` prompts are served first (2 tokens each, no plan) so first-call
    costs stay out of the timed run. Kernel launch counts are set to 0 just
    before the timed run. With ``crash_after``, a ``crash_restart`` fault
    (snapshot to ``crash_path``) joins the plan at the first tick from
    ``crash_after`` on that starts with a request mid-prefill, and the run
    ends there (see ``drive``). ``predict`` and ``profile_ticks``: see
    ``drive``."""
    from repro_torch.runtime.scheduler import RequestScheduler

    if warm:
        w = RequestScheduler(srv)
        for p in warm:
            w.submit(p, 2)
        w.run()
    sched = RequestScheduler(srv, faults=plan)
    for i, p in enumerate(prompts):
        sched.submit(p, n_new, eos_id=eos if i == 0 else None, arrival=i // 2)
    for k in kernels:
        k.launches = 0
    return drive(torch, sched, kernels, crash_after, crash_path, predict, profile_ticks)


def drive(torch, sched, kernels=(), crash_after=None, crash_path="", predict=None,
          profile_ticks=None) -> dict:
    """Run ``sched`` to its end, or to a crash. Records each tick's wall
    time (each tick ends in a host read of the logits; a synchronise closes
    it), the decode ticks, the ticks that carried a chunk, whether the
    revived device is in each decode tick's committed routing view, and the
    host time of the death and revival calls; reads the launch counts just
    after, and holds every tick's launches to what the tick's kind predicts
    (``path_launches`` of its splice admissions, decode step and chunk).
    With ``crash_after`` (see ``run_scheduler``) the crash raises
    ``SimulatedCrash``; the returned run then holds the crash's tick and
    snapshot and the host time of the snapshot write, and no reference to
    the scheduler or its server, so both can be freed. ``predict(n_layers,
    tick)`` gives a tick's launches (default ``path_launches``, the no-mesh
    EP path). With ``profile_ticks = (lo, hi)`` the ticks lo .. hi - 1 run
    under ``torch.profiler``, and the run holds their device busy share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T
    from repro_torch.runtime import faults as F
    from repro_torch.runtime import snapshot as S

    srv = sched.server
    sync = torch.cuda.synchronize
    dev = next((f.device for f in sched.faults if f.kind == F.DEVICE_REVIVAL), None)
    routed, marks, fault_ms, tick_ms, chunk_ticks = [], {}, {}, [], [0]
    chunked, kinds, wrong, tick_kind = bool(srv.scfg.prefill_chunk), {}, [], []
    predict = predict or path_launches
    prof, busy, prof_s = None, {}, [0.0]

    def launches():
        return {k.__name__: k.launches for k in kernels}
    decode_step, save_snapshot, step = T.decode_step, S.save_snapshot, sched.step

    def spy_step(*args, **kw):
        routed.append((srv.t, dev in srv.table.committed_devices()))
        chunk_ticks[0] += kw.get("chunk") is not None and kw["chunk"]["length"] > 0
        return decode_step(*args, **kw)

    def timed(name, fn):
        def call(*args):
            marks[name] = srv.t
            sync()
            t0 = time.perf_counter()
            out = fn(*args)
            sync()
            fault_ms[name] = (time.perf_counter() - t0) * 1e3
            return out
        return call

    def timed_step():
        pf = sched._prefilling
        if (crash_after is not None and sched.step_no >= crash_after and pf is not None
                and pf.prefill_pos > 0 and "crash" not in marks):
            marks["crash"] = sched.step_no
            sched.faults = F.FaultPlan([*sched.faults, F.Fault(
                step=sched.step_no, kind=F.CRASH_RESTART, path=crash_path)])
        nonlocal prof
        n_tick = len(tick_ms)
        if profile_ticks and n_tick == profile_ticks[0]:
            tp = time.perf_counter()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            prof_s[0] += time.perf_counter() - tp
        before, t_b, c_b, e_b = launches(), srv.t, chunk_ticks[0], len(sched.events)
        t0 = time.perf_counter()
        out = step()
        sync()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        if prof is not None and n_tick + 1 == profile_ticks[1]:
            # the profiler's start, stop and reading stay out of the run's
            # wall time (its ticks keep its cost while it traces)
            tp = time.perf_counter()
            prof.stop()
            by_name, _ = profiled_ms(torch, prof)
            wall = sum(tick_ms[profile_ticks[0]:])
            busy.update(ticks=list(profile_ticks), wall_ms=wall,
                        busy_ms=sum(by_name.values()),
                        share=sum(by_name.values()) / wall)
            prof = None
            prof_s[0] += time.perf_counter() - tp
        tick = {"chunked": chunked, "decode_ticks": srv.t - t_b, "chunk_ticks": chunk_ticks[0] - c_b,
                "admits": sum(k == "admit" for _, k, _ in sched.events[e_b:])}
        kind = (tick["decode_ticks"], tick["chunk_ticks"], 0 if chunked else tick["admits"])
        kinds[kind] = kinds.get(kind, 0) + 1
        tick_kind.append(kind)
        if kernels:
            got = {k: v - before[k] for k, v in launches().items()}
            want = predict(srv.cfg.n_layers, tick)
            if srv.ctx.use_kernels is False:
                want = dict.fromkeys(want, 0)
            if got != want:
                wrong.append((sched.step_no - 1, got, want))
        return out

    t_before, migs_before, step_before = srv.t, srv.migrations, sched.step_no
    T.decode_step, S.save_snapshot = spy_step, timed("snapshot", save_snapshot)
    srv.mark_dead, srv.revive = timed("death", srv.mark_dead), timed("revival", srv.revive)
    sched.step = timed_step
    crash = None
    try:
        sync()
        t0 = time.perf_counter()
        try:
            results = sched.run()
        except F.SimulatedCrash as exc:
            if crash_after is None:
                raise
            crash = {"step": exc.step, "snapshot": exc.snapshot, "path": exc.path}
            results = sched.results()
        sync()
        wall_s = time.perf_counter() - t0 - prof_s[0]
    finally:
        T.decode_step, S.save_snapshot = decode_step, save_snapshot
        del srv.mark_dead, srv.revive, sched.step
    if crash_after is not None and crash is None:
        raise AssertionError(f"no tick from {crash_after} on started with a request "
                             f"mid-prefill: the crash never fired")
    if wrong:
        raise AssertionError(f"launches off the prediction on ticks (tick, got, want) {wrong[:4]}")
    run = {"results": results, "wall_s": wall_s, "ticks": sched.step_no - step_before,
           "tick_ms": tick_ms, "tick_kind": tick_kind, "decode_ticks": srv.t - t_before,
           "chunk_ticks": chunk_ticks[0], "chunked": bool(srv.scfg.prefill_chunk),
           "migrations": srv.migrations - migs_before,
           "admits": sum(k == "admit" for _, k, _ in sched.events),
           "tokens": sum(len(v) for v in results.values()),
           "launches": launches(), "tick_kinds": {
               f"decode {d}, chunk {c}, splice admissions {a}": n for (d, c, a), n in kinds.items()},
           "revived_device": dev, "routed": routed, "marks": marks, "fault_ms": fault_ms,
           "events": list(sched.events), "stats": sched.stats(), "busy": busy}
    if profile_ticks and not busy:
        raise AssertionError(f"the run ended before its profiled ticks {profile_ticks}")
    if crash is None:
        run["sched"] = sched
    else:
        run["crash"] = crash
        run["states_at_crash"] = {r.rid: r.state for r in sched.requests}
    return run


def path_launches(n_layers: int, run: dict) -> dict:
    """The four path kernels' launches a scheduler run must make: one
    batch-1 prefill per splice admission (recomputes included), one decode
    step per decode tick and one chunk-lane pass per tick that carried a
    chunk, each layer once. Chunked admission runs no ``flash_attention``:
    its chunk attends as plain math, as the reference's does."""
    splice = 0 if run["chunked"] else run["admits"]
    steps = splice + run["decode_ticks"] + run["chunk_ticks"]
    return {"gmm_dual_act_ragged": n_layers * steps, "gmm_ragged": n_layers * steps,
            "flash_decode_paged": n_layers * run["decode_ticks"],
            "flash_attention": n_layers * splice}


def check_chaos(run: dict, free: dict | None, what: str, recomputed_equal: bool,
                need_preemption: bool = True) -> dict:
    """Hold a chaos run to its fault-free oracle (``free``: rid -> stream,
    request 0 cut at its eos; None holds no stream): every fault kind
    fired, a request was preempted (unless not ``need_preemption``), every
    request finished, every
    never-preempted stream (with ``recomputed_equal`` every stream) equals
    the oracle's; no decode tick
    between the death and the revived device's first re-committed replica
    routed to the device; the table is consistent; a migration committed.
    Returns what the run logs."""
    import numpy as np

    sched = run["sched"]
    srv = sched.server
    fired = {d[0] for _, k, d in sched.events if k == "fault"}
    if not FAULT_KINDS <= fired:
        raise AssertionError(f"{what}: fault kinds {sorted(FAULT_KINDS - fired)} never fired")
    if need_preemption and sched.n_preempted < 1:
        raise AssertionError(f"{what}: the chaos preempted no request")
    prefix = {}
    for r in sched.requests:
        if r.state != "FINISHED":
            raise AssertionError(f"{what}: request {r.rid} {r.state} ({r.error})")
        if free is None:
            continue
        got, want = np.asarray(r.tokens_out), free[r.rid]
        if r.preemptions and not recomputed_equal:
            n = min(len(got), len(want))
            diff = np.flatnonzero(got[:n] != want[:n])
            prefix[r.rid] = int(diff[0]) if diff.size else n
        elif not np.array_equal(got, want):
            raise AssertionError(f"{what}: request {r.rid} (preempted {r.preemptions}x) "
                                 f"stream {got.tolist()} != fault-free {want.tolist()}")
    dev, marks = run["revived_device"], run["marks"]
    commits = [h["committed"] for h in srv.driver.history
               if h["mig"][2] == dev and h["committed"] > marks["revival"]]
    if not commits:
        raise AssertionError(f"{what}: no replica re-committed on revived device {dev}")
    first = min(commits)
    blackout = [t for t, present in run["routed"] if marks["death"] <= t < first and present]
    if blackout:
        raise AssertionError(f"{what}: device {dev} routed at ticks {blackout} between its "
                             f"death (tick {marks['death']}) and its first re-commit ({first})")
    srv.table.check()
    if run["migrations"] < 1:
        raise AssertionError(f"{what}: no migration committed")
    plans = {k: d[1] for _, k, d in sched.events if k in ("evacuated", "revived")}
    return {"preempted": {r.rid: r.preemptions for r in sched.requests if r.preemptions},
            "recomputed_shared_prefix": prefix, "evacuation_plan": plans["evacuated"],
            "revival_plan": plans["revived"], "revival_to_first_commit_ticks":
            first - marks["revival"], "fault_ms": run["fault_ms"]}


def eos_cut(results: dict):
    """Request 0's eos (its own third fault-free token) and the fault-free
    streams with request 0 cut there."""
    import numpy as np

    eos = int(results[0][2])
    free = {rid: np.asarray(v) for rid, v in results.items()}
    free[0] = free[0][: int(np.argmax(free[0] == eos)) + 1]
    return eos, free


def ep_kernels():
    """The four kernels of the paged EP path (3a and 3d)."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode.paged import flash_decode_paged
    from repro_torch.kernels.gmm.ragged import gmm_dual_act_ragged, gmm_ragged

    return (gmm_dual_act_ragged, gmm_ragged, flash_decode_paged, flash_attention)


def small_chaos_parity(torch, seed: int = CHAOS_SEED) -> dict:
    """A small fp32 MoE (4 experts top-2, virtual EP 4 x 3 slots, paged)
    serving 12 requests through the scheduler under the chaos plan, with the
    kernels and on the plain path: every stream, recomputed ones included,
    equals the fault-free run's (same batch, an ample pool, no plan), the
    two runs agree event for event, and the kernel run's launches equal the
    prediction."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = dataclasses.replace(smoke(get_config("dbrx-132b")), head_dim=32)
    prompts = scheduled_prompts(cfg.vocab_size, 12, 8, 32)
    kernels = ep_kernels()

    def server(use_kernels, pool_pages):
        params = T.init_params(cfg, seed=5, device="cuda")
        return Server(cfg, ParallelCtx(capacity_factor=8.0, use_kernels=use_kernels), params,
                      ServeConfig(max_seq=64, batch=8, slots_per_device=3, virtual_ep=4,
                                  alpha=0.1, paged=True, page_size=8, pool_pages=pool_pages),
                      device="cuda")

    eos, free = eos_cut(run_scheduler(torch, server("auto", None), prompts, 16)["results"])
    runs, held = {}, {}
    for uk in ("auto", False):
        runs[uk] = run_scheduler(torch, server(uk, 24), prompts, 16, chaos_plan(seed), eos,
                                 kernels)
        held[uk] = check_chaos(runs[uk], free, f"small fp32 chaos (use_kernels={uk})", True)
    ev = {uk: [(s, k) for s, k, _ in run["sched"].events] for uk, run in runs.items()}
    if ev["auto"] != ev[False]:
        raise AssertionError("small fp32 chaos: kernel and plain runs' events differ")
    want = path_launches(cfg.n_layers, runs["auto"])
    if runs["auto"]["launches"] != want or any(runs[False]["launches"].values()):
        raise AssertionError(f"small fp32 chaos launches {runs['auto']['launches']} != {want} "
                             f"(plain run {runs[False]['launches']})")
    return {"launches": runs["auto"]["launches"], "ticks": runs["auto"]["ticks"],
            "n_preempted": runs["auto"]["sched"].n_preempted, **held["auto"]}


def scheduler_path(torch, card: str) -> dict:
    """Phase 3d: dbrx-132b width (4 layers, bf16), virtual EP 4 x 8 slots,
    paged (page 128, max_seq 1024), batch 8, capacity factor 5.0, alpha
    0.1; 12 requests (prompts of 64-256 tokens, 32 new tokens, request i at
    tick i // 2, request 0 stopping at its own third fault-free token) over
    a 24-page pool under the chaos plan, held to the fault-free run of the
    same batch on a fully backed pool (64 pages)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.serve import ServeConfig, Server

    n_layers, n_new, spd = 4, 32, 8
    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=n_layers)
    prompts = scheduled_prompts(cfg.vocab_size, 12, 64, 256)
    # one warm-up prompt per prefill bucket a run admits (a recompute's
    # context of up to 288 tokens takes the bucket of 512)
    warm = [np.resize(prompts[0], n) for n in (64, 128, 256, 400)]
    kernels = ep_kernels()
    peak_gb = {}

    def server(pool_pages):
        """A fresh server, and the peak memory of its setup (the slot
        expansion holds the expanded tensors beside the last unexpanded
        one); the peak of the run that follows is read apart."""
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
        srv = Server(cfg, ParallelCtx(capacity_factor=5.0), params,
                     ServeConfig(max_seq=1024, batch=8, slots_per_device=spd, virtual_ep=4,
                                 alpha=0.1, paged=True, page_size=128, pool_pages=pool_pages),
                     device="cuda")
        torch.cuda.synchronize()
        peak_gb["setup"] = max(peak_gb.get("setup", 0.0), torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()
        return srv, time.perf_counter() - t0

    srv, setup_s = server(None)
    runs = {"fault-free": run_scheduler(torch, srv, prompts, n_new, kernels=kernels, warm=warm)}
    peak_gb["fault-free"] = torch.cuda.max_memory_allocated() / 1e9
    splice = runs["fault-free"].pop("sched")
    splice = {"results": runs["fault-free"]["results"], "requests": splice.requests}
    eos, free = eos_cut(runs["fault-free"]["results"])
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    srv, _ = server(24)
    runs["chaos"] = run_scheduler(torch, srv, prompts, n_new, chaos_plan(), eos, kernels, warm)
    peak_gb["chaos"] = torch.cuda.max_memory_allocated() / 1e9
    del srv
    held = check_chaos(runs["chaos"], free, "phase 3d", recomputed_equal=False)
    for name, run in runs.items():
        want = path_launches(n_layers, run)
        if run["launches"] != want:
            raise AssertionError(f"phase 3d {name}: launches {run['launches']} != {want}")
    out = {"setup_s": setup_s, "peak_gb": peak_gb, **held}
    for name, run in runs.items():
        out[name] = tick_summary(run)
        log(f"phase 3d {name}: {tick_line(run, out[name])}, launches {run['launches']} as "
            f"predicted [{card}]")
    sched = runs["chaos"]["sched"]
    log(f"phase 3d chaos (seed {CHAOS_SEED}): faults "
        + ", ".join(f"{f.kind}@{f.step}" for f in sched.faults)
        + f"; preempted {sched.n_preempted} ({held['preempted']}; recomputed streams' prefix "
        f"shared with the fault-free run {held['recomputed_shared_prefix']}); evacuation plan "
        f"{held['evacuation_plan']}, revival plan {held['revival_plan']} migrations, "
        f"{held['revival_to_first_commit_ticks']} ticks from revival to the first re-commit; "
        f"mark_dead {held['fault_ms'].get('death', 0):.2f} ms, revive "
        f"{held['fault_ms'].get('revival', 0):.2f} ms (host, synchronised); peak memory "
        + ", ".join(f"{k} {v:.2f} GB" for k, v in peak_gb.items())
        + f"; setup {setup_s:.2f} s a server [{card}]")
    return out, splice


def tick_summary(run: dict) -> dict:
    """A scheduler run's ticks, ms a tick (mean over the run's wall time,
    median and max of the ticks), tok/s and launches."""
    import numpy as np

    out = {k: run[k] for k in ("ticks", "decode_ticks", "chunk_ticks", "admits", "tokens",
                               "wall_s", "migrations", "launches", "tick_kinds")}
    out.update(ms_per_tick=run["wall_s"] * 1e3 / run["ticks"],
               ms_tick_median=float(np.median(run["tick_ms"])),
               ms_tick_max=float(max(run["tick_ms"])), tok_s=run["tokens"] / run["wall_s"])
    # median ms of each tick kind: a decode tick alone, one with a chunk,
    # one with n splice admissions (the tick with the crash is not timed)
    by_kind = {}
    for (d, c, a), ms in zip(run["tick_kind"], run["tick_ms"]):
        name = "idle" if not d else "decode" + " + chunk" * c + f" + {a} splice" * bool(a)
        by_kind.setdefault(name, []).append(ms)
    out["ms_tick_median_by_kind"] = {k: float(np.median(v)) for k, v in by_kind.items()}
    return out


def tick_line(run: dict, t: dict) -> str:
    return (f"{t['ticks']} ticks ({t['decode_ticks']} decode, {t['chunk_ticks']} with a chunk), "
            f"{t['admits']} admissions, {t['tokens']} tokens in {t['wall_s']:.3f} s = "
            f"{t['ms_per_tick']:.2f} ms a tick (median {t['ms_tick_median']:.2f}, max "
            f"{t['ms_tick_max']:.2f}), {t['tok_s']:.1f} tok/s, {t['migrations']} migrations "
            f"committed; median ms by tick kind "
            + ", ".join(f"{k} {v:.2f}" for k, v in t["ms_tick_median_by_kind"].items())
            + f"; every tick's launches as its kind predicts ({t['tick_kinds']})")


# ---------------------------------------------------------------------------
# phase 3e: chunked admission and crash-safe snapshots with restore
# ---------------------------------------------------------------------------

# the chunk size at full width: one page
CHUNK = 128


def held_streams(got: dict, want: dict, skip=()) -> dict:
    """Hold every stream of ``got`` (rid -> tokens) but those in ``skip`` to
    ``want`` bit for bit; return the prefix each skipped stream shares."""
    import numpy as np

    prefix = {}
    for rid, tokens in got.items():
        a, b = np.asarray(tokens), np.asarray(want[rid])
        if rid in skip:
            n = min(len(a), len(b))
            diff = np.flatnonzero(a[:n] != b[:n])
            prefix[rid] = int(diff[0]) if diff.size else n
        elif not np.array_equal(a, b):
            raise AssertionError(f"request {rid}: stream {a.tolist()} != {b.tolist()}")
    return prefix


def restore_run(torch, path: str, cfg, ctx, make_params, plan, kernels) -> tuple:
    """Rebuild a scheduler from the snapshot file on the card (logical
    params from ``make_params``) and serve on. Returns the restored run and
    the restore's host ms (server rebuild and slot expansion)."""
    from repro_torch.runtime import snapshot as S

    params = make_params()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched = S.restore_scheduler(path, cfg, ctx, params, faults=plan, device="cuda")
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    del params
    return sched, restore_ms


def combined_launches(n_layers: int, *runs) -> dict:
    want = {}
    for run in runs:
        for k, v in path_launches(n_layers, run).items():
            want[k] = want.get(k, 0) + v
    return want


def small_chunk_parity(torch) -> dict:
    """A small fp32 MoE (3d's small model: 4 experts top-2, virtual EP 4 x
    3 slots, page 8) serving 12 requests through the scheduler, with the
    kernels and on the plain path: chunked admission (chunks of 8) gives
    every stream of splice admission, and launches as predicted (no
    ``flash_attention``); then a crash at the first tick that starts with a
    request mid-prefill, the server freed, restored from the snapshot file:
    every stream equals the uninterrupted chunked run's."""
    import tempfile

    from repro_torch.configs import get_config, smoke
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = dataclasses.replace(smoke(get_config("dbrx-132b")), head_dim=32)
    prompts = scheduled_prompts(cfg.vocab_size, 12, 8, 32)
    kernels = ep_kernels()
    out = {}

    def scfg(chunk):
        return ServeConfig(max_seq=64, batch=8, slots_per_device=3, virtual_ep=4, alpha=0.1,
                           paged=True, page_size=8, prefill_chunk=chunk)

    for uk in ("auto", False):
        ctx = ParallelCtx(capacity_factor=8.0, use_kernels=uk)

        def server(chunk):
            return Server(cfg, ctx, T.init_params(cfg, seed=5, device="cuda"), scfg(chunk),
                          device="cuda")

        splice = run_scheduler(torch, server(None), prompts, 16)
        chunked = run_scheduler(torch, server(8), prompts, 16, kernels=kernels)
        held_streams(chunked["results"], splice["results"])
        if chunked["sched"].stats()["max_stall_ticks"]:
            raise AssertionError(f"small chunked run (use_kernels={uk}): a live request stalled")
        want = path_launches(cfg.n_layers, chunked) if uk else dict.fromkeys(want, 0)
        if chunked["launches"] != want:
            raise AssertionError(f"small chunked run (use_kernels={uk}) launches "
                                 f"{chunked['launches']} != {want}")
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/snap.npz"
            pre = run_scheduler(torch, server(8), prompts, 16, kernels=kernels, crash_after=1,
                                crash_path=path)
            gc.collect()
            post, _ = restore_run(torch, path, cfg, ctx,
                                  lambda: T.init_params(cfg, seed=5, device="cuda"), None, kernels)
            post = drive(torch, post, kernels)
        held_streams(post["results"], chunked["results"])
        if post["launches"] != (combined_launches(cfg.n_layers, pre, post) if uk else want):
            raise AssertionError(f"small crash run (use_kernels={uk}) launches {post['launches']}")
        mid = pre["crash"]["snapshot"].requests
        out.setdefault("crash_tick", pre["crash"]["step"])
        out.setdefault("mid_prefill", [r["rid"] for r in mid if r["state"] == "PREFILLING"])
        if uk:
            out["launches"] = chunked["launches"]
    return out


def kv_recompute_probe(torch, srv, prompt, n_steps: int = 16) -> dict:
    """Where a recomputed bf16 context leaves the KV that decode wrote: one
    request of ``len(prompt)`` tokens prefilled into slot 0 of a batch of 8
    and decoded ``n_steps`` steps (8 rows a step, the other 7 inert), then
    the prompt plus the emitted tokens recomputed by a batch-1 prefill into
    slot 1 (unpadded: M = P + n rows). Per layer, the max |diff| of the K
    and V rows of positions P..P+n-1 (decode-written against
    recompute-written) and of positions 0..P-1 (both prefill-written, at M =
    P and M = P + n rows); and layer 0's K projection of those n tokens at M
    = 8 rows (each decode step's batch) against M = P + n rows (the
    recompute), before RoPE."""
    import numpy as np

    from repro_torch.models import layers as Ly

    cache = srv.empty_cache()
    logits, cache = srv.prefill_into_slot(0, prompt, cache)
    p = len(prompt)
    emitted, batches = [], []
    tok = np.zeros((srv.scfg.batch, 1), np.int64)
    tok[0, 0] = int(logits[0, -1].float().argmax())
    for _ in range(n_steps):
        emitted.append(int(tok[0, 0]))
        batches.append(tok.copy())
        logits, cache = srv.decode(tok, cache)
        tok[0, 0] = int(logits[0, -1].float().argmax())
    context = np.concatenate([prompt, np.asarray(emitted)])
    _, cache = srv.prefill_into_slot(1, context, cache)
    torch.cuda.synchronize()

    def rows(slot, lo, hi):
        pages = srv._pages[slot]
        pos = np.arange(lo, hi)
        idx = torch.as_tensor([pages[q // srv.page_size] for q in pos], device="cuda")
        r = torch.as_tensor(pos % srv.page_size, device="cuda")
        lay = cache["layers"]
        return {n: lay[n][:, idx, r].float() for n in ("pool_k", "pool_v")}

    dec, rec = rows(0, p, p + n_steps), rows(1, p, p + n_steps)
    pre0, pre1 = rows(0, 0, p), rows(1, 0, p)
    per_layer = {n: (dec[n] - rec[n]).abs().flatten(1).amax(1).tolist() for n in dec}
    prefill_layer = {n: (pre0[n] - pre1[n]).abs().flatten(1).amax(1).tolist() for n in pre0}
    first = next((l for l in range(srv.cfg.n_layers)
                  if per_layer["pool_k"][l] or per_layer["pool_v"][l]), None)
    # layer 0's K projection: its input is the normed embedding, the same
    # for a token whichever pass computes it
    lp = srv.params["layers"]
    ln1, wk = lp["ln1"][0], lp["attn"]["wk"][0]

    def z_of(tokens):
        return Ly.rms_norm(srv.params["embed"][torch.as_tensor(tokens, device="cuda")], ln1,
                           srv.cfg.norm_eps)

    big = z_of(context) @ wk                                        # M = P + n
    small = torch.stack([(z_of(b[:, 0]) @ wk)[0] for b in batches])  # M = 8 each
    proj = (small.float() - big[p:].float()).abs()
    srv.release(0, cache)
    srv.release(1, cache)
    return {"first_layer": first, "kv_max_abs_diff": per_layer,
            "prefill_rows_max_abs_diff": prefill_layer,
            "k_proj_max_abs_diff": float(proj.max()),
            "k_proj_rows_differing": int((proj.amax(1) > 0).sum()), "n_rows": n_steps}


def chunk_path(torch, card: str, splice: dict, setup_peak_gb: float) -> dict:
    """Phase 3e at dbrx-132b width: 3d's model, slots, capacity factor,
    batch and 12 requests with ``prefill_chunk=128``. First the KV
    recompute probe (finding of ROADMAP Queue 3 item 1). (i) Chunked,
    fault-free, 64 pages, held beside 3d's fault-free splice run (``splice``:
    its streams and requests): no live request stalls, each first token
    within ceil(len/128) + 1 ticks of admission, launches as predicted (no
    ``flash_attention``), every chunk-lane copy kept; each stream's prefix
    shared with the splice run logged (bf16). (ii) Chunked under seed 5's
    chaos plan on 24 pages plus a crash at the first tick from the death on
    that starts with a request mid-prefill: the snapshot goes to a
    temporary directory, the crashed server is freed, ``restore_scheduler``
    rebuilds it from the file and serves on; every request finishes; the
    streams neither preempted nor live at the crash equal run (i)'s bit for
    bit, the others log their shared prefix; every fault kind fired; the
    restore's peak memory stays within the setup peak plus the restored
    cache."""
    import math
    import os
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.parallel import collectives as Co
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.serve import ServeConfig, Server

    n_layers, n_new = 4, 32
    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=n_layers)
    prompts = scheduled_prompts(cfg.vocab_size, 12, 64, 256)
    warm = [np.resize(prompts[0], n) for n in (64, 200)]
    kernels = ep_kernels()
    ctx = ParallelCtx(capacity_factor=5.0)

    def params():
        return T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")

    def server(pool_pages):
        return Server(cfg, ctx, params(),
                      ServeConfig(max_seq=1024, batch=8, slots_per_device=8, virtual_ep=4,
                                  alpha=0.1, paged=True, page_size=128, pool_pages=pool_pages,
                                  prefill_chunk=CHUNK), device="cuda")

    srv = server(None)
    probe = kv_recompute_probe(torch, srv, np.resize(prompts[0], 256))
    log(f"phase 3e KV recompute probe (bf16, P 256, 16 decode steps): first layer whose "
        f"decode-written K/V rows differ from the recompute's: {probe['first_layer']}; max "
        "|diff| per layer K " + ", ".join(f"{x:.3g}" for x in probe["kv_max_abs_diff"]["pool_k"])
        + ", V " + ", ".join(f"{x:.3g}" for x in probe["kv_max_abs_diff"]["pool_v"])
        + "; prompt rows (prefill at M 256 vs M 272) K "
        + ", ".join(f"{x:.3g}" for x in probe["prefill_rows_max_abs_diff"]["pool_k"])
        + f"; layer 0 K projection at M 8 vs M 272: {probe['k_proj_rows_differing']} of "
        f"{probe['n_rows']} rows differ, max |diff| {probe['k_proj_max_abs_diff']:.3g} [{card}]")

    # (i) chunked, fault-free, every chunk-lane copy kept
    dispatch, chunk_copies = Co.bucket_dispatch, []

    def spy_dispatch(x, bucket_ids, n_buckets, capacity):
        out = dispatch(x, bucket_ids, n_buckets, capacity)
        if x.shape[0] == CHUNK:
            chunk_copies.append(torch.stack([(bucket_ids < n_buckets).sum(), out[2].sum()]))
        return out

    Co.bucket_dispatch = spy_dispatch
    try:
        run = run_scheduler(torch, srv, prompts, n_new, kernels=kernels, warm=warm)
    finally:
        Co.bucket_dispatch = dispatch
    sched = run.pop("sched")
    routed = torch.stack(chunk_copies).sum(0).tolist() if chunk_copies else [0, 0]
    if routed[0] != routed[1] or not chunk_copies:
        raise AssertionError(f"phase 3e (i): the chunk lane kept {routed[1]} of {routed[0]} "
                             f"routed copies over {len(chunk_copies)} calls")
    if run["launches"] != path_launches(n_layers, run):
        raise AssertionError(f"phase 3e (i) launches {run['launches']} != "
                             f"{path_launches(n_layers, run)}")
    stats = sched.stats()
    if stats["max_stall_ticks"]:
        raise AssertionError(f"phase 3e (i): a live request stalled {stats['max_stall_ticks']}")
    for r in sched.requests:
        if r.state != "FINISHED":
            raise AssertionError(f"phase 3e (i): request {r.rid} {r.state} ({r.error})")
        bound = math.ceil(len(r.prompt) / CHUNK) + 1
        if r.first_token_step - r.admitted_step + 1 > bound:
            raise AssertionError(f"phase 3e (i): request {r.rid}'s first token "
                                 f"{r.first_token_step - r.admitted_step + 1} ticks after its "
                                 f"admission > {bound}")
    shared = held_streams(run["results"], splice["results"], skip=set(run["results"]))
    free = run["results"]
    admit_to_first = {r.rid: r.first_token_step - r.admitted_step + 1 for r in sched.requests}
    out = {"probe": probe, "fault-free": tick_summary(run), "chunk_copies": routed,
           "prefix_shared_with_splice": shared, "admit_to_first_token_ticks": admit_to_first}
    log(f"phase 3e (i) chunked fault-free: {tick_line(run, out['fault-free'])}; max stall "
        f"{stats['max_stall_ticks']} ticks; admission to first token {admit_to_first} ticks; "
        f"chunk lane kept {routed[1]} of {routed[0]} copies; launches {run['launches']} as "
        f"predicted; prefix shared with the splice run {shared} [{card}]")
    del sched, srv, run
    gc.collect()
    torch.cuda.empty_cache()

    # (ii) chunked, seed 5's chaos plan on 24 pages, plus a crash mid-prefill
    eos = int(free[0][2])
    cut = {rid: np.asarray(v) for rid, v in free.items()}
    cut[0] = cut[0][: int(np.argmax(cut[0] == eos)) + 1]
    plan = chaos_plan()
    death = next(f.step for f in plan if f.kind == "device_death")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "snap.npz")
        pre = run_scheduler(torch, server(24), prompts, n_new, plan, eos, kernels, warm,
                            crash_after=death, crash_path=path)
        gc.collect()
        torch.cuda.empty_cache()
        freed_gb = torch.cuda.memory_allocated() / 1e9
        if freed_gb > 1.0:
            raise AssertionError(f"phase 3e (ii): {freed_gb:.2f} GB still allocated after the "
                                 "crash: the crashed server was not freed")
        snap_bytes = os.path.getsize(path) + os.path.getsize(path + ".meta")
        torch.cuda.reset_peak_memory_stats()
        restored, restore_ms = restore_run(torch, path, cfg, ctx, params, plan, kernels)
    restore_peak = torch.cuda.max_memory_allocated() / 1e9
    lay = restored.cache["layers"]
    cache_gb = sum(t.numel() * t.element_size() for t in lay.values()) / 1e9
    if restore_peak > setup_peak_gb + cache_gb:
        raise AssertionError(f"phase 3e (ii): restore peak {restore_peak:.2f} GB > setup peak "
                             f"{setup_peak_gb:.2f} GB + the cache {cache_gb:.3f} GB")
    crash_state = {r["rid"]: (r["state"], r["prefill_pos"]) for r in pre["crash"]["snapshot"].requests}
    live_at_crash = {rid for rid in pre["crash"]["snapshot"].live_rids if rid is not None}
    post = drive(torch, restored, kernels)
    sched = post.pop("sched")
    # the crash itself fires before the tick's faults are logged; run (ii)'s
    # "crash" record is its proof
    fired = {d[0] for run in (pre, post) for _, k, d in run["events"] if k == "fault"}
    if not FAULT_KINDS <= fired:
        raise AssertionError(f"phase 3e (ii): fault kinds {sorted(FAULT_KINDS - fired)} never fired")
    for r in sched.requests:
        if r.state != "FINISHED":
            raise AssertionError(f"phase 3e (ii): request {r.rid} {r.state} ({r.error})")
    recomputed = live_at_crash | {r.rid for r in sched.requests if r.preemptions}
    shared = held_streams(post["results"], cut, skip=recomputed)
    sched.server.table.check()
    want = combined_launches(n_layers, pre, post)
    if post["launches"] != want:
        raise AssertionError(f"phase 3e (ii) launches {post['launches']} != {want}")
    both = {**pre, "ticks": pre["ticks"] + post["ticks"], "tick_ms": pre["tick_ms"] + post["tick_ms"],
            "tick_kind": pre["tick_kind"] + post["tick_kind"],
            "wall_s": pre["wall_s"] + post["wall_s"],
            **{k: pre[k] + post[k] for k in ("decode_ticks", "chunk_ticks", "admits",
                                             "migrations")},
            "tokens": post["tokens"], "launches": post["launches"],
            "tick_kinds": {k: pre["tick_kinds"].get(k, 0) + post["tick_kinds"].get(k, 0)
                           for k in {**pre["tick_kinds"], **post["tick_kinds"]}}}
    out["chaos+crash"] = tick_summary(both)
    out["eos"] = eos
    out["crash"] = {"tick": pre["crash"]["step"], "requests_at_crash": crash_state,
                    "snapshot_write_ms": pre["fault_ms"]["snapshot"],
                    "snapshot_bytes": snap_bytes, "restore_ms": restore_ms,
                    "restore_peak_gb": restore_peak, "restored_cache_gb": cache_gb,
                    "setup_peak_gb": setup_peak_gb, "held_bit_for_bit":
                        sorted(set(post["results"]) - recomputed),
                    "recomputed_shared_prefix": shared,
                    "preempted": {r.rid: r.preemptions for r in sched.requests if r.preemptions}}
    c = out["crash"]
    log(f"phase 3e (ii) chunked, chaos (seed {CHAOS_SEED}) + crash at tick {c['tick']} "
        f"(requests mid-prefill: "
        f"{[rid for rid, (st, _) in crash_state.items() if st == 'PREFILLING']}): "
        f"{tick_line(both, out['chaos+crash'])}; faults fired {sorted(fired)}; snapshot "
        f"{c['snapshot_write_ms']:.2f} ms, {snap_bytes} bytes; restore {restore_ms:.1f} ms "
        f"(server rebuild and slot expansion), peak {restore_peak:.2f} GB through it (setup "
        f"peak {setup_peak_gb:.2f} GB + cache {cache_gb:.3f} GB); streams held bit for bit "
        f"{c['held_bit_for_bit']}, recomputed streams' prefix shared with run (i) {shared} "
        f"(preempted {c['preempted']}, live at the crash {sorted(live_at_crash)}); launches "
        f"{post['launches']} as predicted [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 3f: the paged, chunked, fault-tolerant EP path and ESP under the mesh
# ---------------------------------------------------------------------------

def mesh_ep_kernels():
    """The paged EP path's kernels and the flat-row FFN kernels that
    ``ep_moe_shardmap`` runs instead of the ragged pair."""
    from repro_torch.kernels.gmm import ragged as K

    return (*ep_kernels(), K.gmm_dual_act_gather, K.gmm_scatter, K.gmm_fused_ffn)


def mesh_ep_launches(n_layers: int, run: dict, fused: bool = False) -> dict:
    """The launches a scheduler run over the meshed EP Server must make:
    ``ep_moe_shardmap``'s flat-row FFN (the gather/scatter pair at d_model
    6144, ``gmm_fused_ffn`` with ``fused`` on a small model) once a layer
    for each splice prefill, decode step and chunk-lane pass;
    ``flash_decode_paged`` once a layer a decode tick; ``flash_attention``
    once a layer a splice prefill; the ragged pair never."""
    splice = 0 if run["chunked"] else run["admits"]
    steps = n_layers * (splice + run["decode_ticks"] + run["chunk_ticks"])
    return {"gmm_dual_act_ragged": 0, "gmm_ragged": 0,
            "flash_decode_paged": n_layers * run["decode_ticks"],
            "flash_attention": n_layers * splice,
            "gmm_dual_act_gather": 0 if fused else steps, "gmm_scatter": 0 if fused else steps,
            "gmm_fused_ffn": steps if fused else 0}


def small_mesh_serving_parity(torch, mesh) -> dict:
    """Small fp32 models (TF32 off) on the 1 x 1 NCCL mesh against the same
    models with no mesh. (i) 3d's small MoE (4 experts top-2, virtual EP 4
    x 3 slots, page 8, 24 pages) with chunked admission (chunks of 8)
    through the scheduler under the chaos plan: with the kernels and on the
    plain path every stream and every event equals the no-mesh run's, and
    every stream the no-mesh fault-free run's; the mesh kernel run's
    launches as predicted (``gmm_fused_ffn`` inside ``ep_moe_shardmap``).
    (ii) 2b's small ESP model (window 32 wrapped, dense cache): greedy
    tokens with the kernels and on the plain path equal the no-mesh ESP
    Server's; the mesh kernel run launches the ragged pair (through
    ``esp_expert_ffn``) and the partials kernel, and no ``gmm_fused_ffn``."""
    import functools

    from repro_torch.configs import get_config, smoke
    from repro_torch.kernels.flash_decode.flash_decode import flash_decode, flash_decode_partials
    from repro_torch.kernels.gmm import ragged as K
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = dataclasses.replace(smoke(get_config("dbrx-132b")), head_dim=32)
    prompts = scheduled_prompts(cfg.vocab_size, 12, 8, 32)

    def server(ctx, pool_pages):
        params = T.init_params(cfg, seed=5, device="cuda")
        return Server(cfg, ctx, params,
                      ServeConfig(max_seq=64, batch=8, slots_per_device=3, virtual_ep=4,
                                  alpha=0.1, paged=True, page_size=8, pool_pages=pool_pages,
                                  prefill_chunk=8), device="cuda")

    eos, free = eos_cut(run_scheduler(torch, server(ParallelCtx(capacity_factor=8.0), None),
                                      prompts, 16)["results"])
    fused = functools.partial(mesh_ep_launches, fused=True)
    runs = {}
    for name, ctx, kernels, predict in (
        ("no-mesh", ParallelCtx(capacity_factor=8.0), ep_kernels(), path_launches),
        ("mesh kernels", ParallelCtx(mesh=mesh, capacity_factor=8.0), mesh_ep_kernels(), fused),
        ("mesh plain", ParallelCtx(mesh=mesh, capacity_factor=8.0, use_kernels=False),
         mesh_ep_kernels(), fused),
    ):
        runs[name] = run_scheduler(torch, server(ctx, 24), prompts, 16, chaos_plan(), eos,
                                   kernels, predict=predict)
        check_chaos(runs[name], free, f"phase 3f small chunked chaos ({name})", True,
                    need_preemption=False)
    ev = {name: [(st, k) for st, k, _ in run["sched"].events] for name, run in runs.items()}
    for name, run in runs.items():
        if ev[name] != ev["no-mesh"] or run["results"].keys() != free.keys():
            raise AssertionError(f"phase 3f small chunked chaos: {name}'s events differ from "
                                 "the no-mesh run's")
    want = fused(cfg.n_layers, runs["mesh kernels"])
    if runs["mesh kernels"]["launches"] != want or any(runs["mesh plain"]["launches"].values()):
        raise AssertionError(f"phase 3f small chunked chaos launches "
                             f"{runs['mesh kernels']['launches']} != {want} (plain run "
                             f"{runs['mesh plain']['launches']})")
    out = {"chunk_chaos": {"launches": runs["mesh kernels"]["launches"],
                           "ticks": runs["mesh kernels"]["ticks"],
                           "n_preempted": runs["mesh kernels"]["sched"].n_preempted,
                           "chunk_ticks": runs["mesh kernels"]["chunk_ticks"]}}
    del runs

    ecfg = dataclasses.replace(smoke(get_config("mixtral-8x22b")), head_dim=32)
    n_new = 24
    prompt = torch.randint(0, ecfg.vocab_size, (4, 12),
                           generator=torch.Generator().manual_seed(9))
    kernels = (K.gmm_dual_act_ragged, K.gmm_ragged, K.gmm_fused_ffn, K.gmm_dual_act_gather,
               K.gmm_scatter, flash_decode, flash_decode_partials)
    toks, launched = {}, {}
    for name, ctx in (
        ("no-mesh", ParallelCtx(moe_impl="esp", capacity_factor=2.0)),
        ("mesh kernels", ParallelCtx(mesh=mesh, moe_impl="esp", capacity_factor=2.0)),
        ("mesh plain", ParallelCtx(mesh=mesh, moe_impl="esp", capacity_factor=2.0,
                                   use_kernels=False)),
    ):
        for k in kernels:
            k.launches = 0
        srv = Server(ecfg, ctx, T.init_params(ecfg, seed=10, device="cuda"),
                     ServeConfig(max_seq=64, batch=4, paged=False), device="cuda")
        toks[name] = srv.generate(prompt, n_new).cpu()
        launched[name] = {k.__name__: k.launches for k in kernels}
    for name, t in toks.items():
        if not torch.equal(t, toks["no-mesh"]):
            raise AssertionError(f"phase 3f small ESP: {name} tokens differ from the no-mesh "
                                 f"Server's:\n{t}\n{toks['no-mesh']}")
    steps = ecfg.n_layers * (1 + n_new)
    want = {"gmm_dual_act_ragged": steps, "gmm_ragged": steps, "gmm_fused_ffn": 0,
            "gmm_dual_act_gather": 0, "gmm_scatter": 0, "flash_decode": 0,
            "flash_decode_partials": ecfg.n_layers * n_new}
    if launched["mesh kernels"] != want or any(launched["mesh plain"].values()):
        raise AssertionError(f"phase 3f small ESP launches {launched['mesh kernels']} != {want} "
                             f"(plain run {launched['mesh plain']})")
    out["esp"] = {"launches": launched["mesh kernels"]}
    return out


def mesh_chunk_path(torch, mesh, card: str, eos: int) -> dict:
    """Phase 3f at dbrx-132b width: 3e (ii)'s chunked run under 3d's chaos
    plan on 24 pages, without the crash (virtual EP 4 x 8 slots, capacity
    factor 5.0, alpha 0.1, page 128, batch 8, the same 12 requests and
    ``eos``, ``prefill_chunk=128``), with no mesh and then over the 1 x 1
    NCCL mesh, each server freed before the next is built. Each run: every
    request finishes, every fault kind fires, a request is preempted, no
    decode tick routes to the dead device before its first re-committed
    replica, the table is consistent, a migration commits, and every tick's
    launches are as its kind predicts (under the mesh: the gather/scatter
    pair 4 x (decode + chunk ticks), ``flash_decode_paged`` 4 x decode
    ticks, no ``flash_attention``, no ragged pair). Ticks 16-31 run under
    the profiler for the device busy share. The mesh run's streams log the
    prefix they share with the no-mesh run (bf16 is held bit for bit only
    in fp32)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.serve import ServeConfig, Server

    n_layers, n_new = 4, 32
    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=n_layers)
    prompts = scheduled_prompts(cfg.vocab_size, 12, 64, 256)
    warm = [np.resize(prompts[0], n) for n in (64, 200)]
    runs, out = {}, {}
    for name, ctx, kernels, predict in (
        ("no-mesh", ParallelCtx(capacity_factor=5.0), ep_kernels(), path_launches),
        ("mesh", ParallelCtx(mesh=mesh, capacity_factor=5.0), mesh_ep_kernels(),
         mesh_ep_launches),
    ):
        torch.cuda.reset_peak_memory_stats()
        params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
        srv = Server(cfg, ctx, params,
                     ServeConfig(max_seq=1024, batch=8, slots_per_device=8, virtual_ep=4,
                                 alpha=0.1, paged=True, page_size=128, pool_pages=24,
                                 prefill_chunk=CHUNK), device="cuda")
        del params
        run = run_scheduler(torch, srv, prompts, n_new, chaos_plan(), eos, kernels, warm,
                            predict=predict, profile_ticks=(16, 32))
        held = check_chaos(run, None, f"phase 3f {name}", recomputed_equal=False,
                           need_preemption=False)
        if run["launches"] != predict(n_layers, run):
            raise AssertionError(f"phase 3f {name}: launches {run['launches']} != "
                                 f"{predict(n_layers, run)}")
        run.pop("sched")
        runs[name] = run
        out[name] = {**tick_summary(run), "busy": run["busy"],
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "preempted": held["preempted"], "evacuation_plan": held["evacuation_plan"],
                     "revival_plan": held["revival_plan"],
                     "revival_to_first_commit_ticks": held["revival_to_first_commit_ticks"],
                     "fault_ms": held["fault_ms"]}
        del srv
        gc.collect()
        torch.cuda.empty_cache()
    out["mesh_prefix_shared_with_no_mesh"] = held_streams(
        runs["mesh"]["results"], runs["no-mesh"]["results"], skip=set(runs["mesh"]["results"]))
    for name in runs:
        o = out[name]
        log(f"phase 3f chunked chaos (seed {CHAOS_SEED}), {name}: {tick_line(runs[name], o)}; "
            f"device busy {o['busy']['share']:.1%} over ticks {o['busy']['ticks'][0]}-"
            f"{o['busy']['ticks'][1] - 1} ({o['busy']['busy_ms']:.1f} of "
            f"{o['busy']['wall_ms']:.1f} ms, under the profiler); preempted {o['preempted']}, "
            f"evacuation plan {o['evacuation_plan']}, revival plan {o['revival_plan']}, "
            f"{o['revival_to_first_commit_ticks']} ticks from revival to the first re-commit; "
            f"mark_dead {o['fault_ms'].get('death', 0):.2f} ms, revive "
            f"{o['fault_ms'].get('revival', 0):.2f} ms; peak {o['peak_gb']:.2f} GB; launches "
            f"{runs[name]['launches']} as predicted [{card}]")
    log(f"phase 3f: each mesh stream's bf16 prefix shared with the no-mesh run "
        f"{out['mesh_prefix_shared_with_no_mesh']} (of "
        f"{ {rid: len(v) for rid, v in runs['no-mesh']['results'].items()} } tokens) [{card}]")
    out["crash"] = mesh_crash_run(torch, mesh, card, cfg, prompts, warm, eos,
                                  runs["mesh"]["results"])
    return out


def mesh_crash_run(torch, mesh, card: str, cfg, prompts, warm, eos: int, free: dict) -> dict:
    """Phase 3f's crash on the 1 x 1 NCCL mesh: the mesh run again, with a
    ``crash_restart`` at the first tick from the death on that starts with
    a request mid-prefill. The ranks' snapshots are checked equal and
    rank 0 writes the file; the crashed server is freed and the run
    restored on the mesh from the file. Every request finishes; every
    stream neither preempted nor live at the crash equals the
    uninterrupted mesh run's (``free``) bit for bit, the others log the
    prefix they share (the determinism contract's bf16 scope); the
    restore's peak stays within the server's setup peak plus the restored
    cache (3e's bound); every tick's launches as ``mesh_ep_launches``
    predicts. A world of one splits nothing: the tensor-parallel layouts
    and a restore onto another layout are proved on gloo ranks
    (``tests/test_torch_mesh_tp.py``, ``tests/test_torch_mesh_snapshot.py``)."""
    import os
    import tempfile

    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.serve import ServeConfig, Server

    n_layers, n_new = cfg.n_layers, 32
    ctx = ParallelCtx(mesh=mesh, capacity_factor=5.0)
    kernels = mesh_ep_kernels()
    plan = chaos_plan()
    death = next(f.step for f in plan if f.kind == "device_death")

    def params():
        return T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    srv = Server(cfg, ctx, params(),
                 ServeConfig(max_seq=1024, batch=8, slots_per_device=8, virtual_ep=4,
                             alpha=0.1, paged=True, page_size=128, pool_pages=24,
                             prefill_chunk=CHUNK), device="cuda")
    setup_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "snap.npz")
        pre = run_scheduler(torch, srv, prompts, n_new, plan, eos, kernels, warm,
                            crash_after=death, crash_path=path, predict=mesh_ep_launches)
        del srv
        gc.collect()
        torch.cuda.empty_cache()
        freed_gb = torch.cuda.memory_allocated() / 1e9
        if freed_gb > 1.0:
            raise AssertionError(f"phase 3f crash: {freed_gb:.2f} GB still allocated after the "
                                 "crash: the crashed server was not freed")
        snap_bytes = os.path.getsize(path) + os.path.getsize(path + ".meta")
        torch.cuda.reset_peak_memory_stats()
        restored, restore_ms = restore_run(torch, path, cfg, ctx, params, plan, kernels)
    restore_peak = torch.cuda.max_memory_allocated() / 1e9
    cache_gb = sum(t.numel() * t.element_size() for t in restored.cache["layers"].values()) / 1e9
    if restore_peak > setup_peak_gb + cache_gb:
        raise AssertionError(f"phase 3f crash: restore peak {restore_peak:.2f} GB > setup peak "
                             f"{setup_peak_gb:.2f} GB + the cache {cache_gb:.3f} GB")
    snap = pre["crash"]["snapshot"]
    live_at_crash = {rid for rid in snap.live_rids if rid is not None}
    post = drive(torch, restored, kernels, predict=mesh_ep_launches)
    sched = post.pop("sched")
    left = [(r.rid, r.state, r.error) for r in sched.requests if r.state != "FINISHED"]
    if left:
        raise AssertionError(f"phase 3f crash: requests {left} did not finish")
    recomputed = live_at_crash | {r.rid for r in sched.requests if r.preemptions}
    shared = held_streams(post["results"], free, skip=recomputed)
    sched.server.table.check()
    want = {k: v + mesh_ep_launches(n_layers, post)[k]
            for k, v in mesh_ep_launches(n_layers, pre).items()}
    if post["launches"] != want:
        raise AssertionError(f"phase 3f crash launches {post['launches']} != {want}")
    out = {"tick": pre["crash"]["step"], "snapshot_write_ms": pre["fault_ms"]["snapshot"],
           "snapshot_bytes": snap_bytes, "restore_ms": restore_ms,
           "restore_peak_gb": restore_peak, "restored_cache_gb": cache_gb,
           "setup_peak_gb": setup_peak_gb,
           "held_bit_for_bit": sorted(set(post["results"]) - recomputed),
           "recomputed_shared_prefix": shared, "launches": post["launches"],
           "ticks": pre["ticks"] + post["ticks"]}
    log(f"phase 3f crash on the 1 x 1 NCCL mesh at tick {out['tick']} (live "
        f"{sorted(live_at_crash)}): snapshot {out['snapshot_write_ms']:.2f} ms, {snap_bytes} "
        f"bytes; restore {restore_ms:.1f} ms (server rebuild and slot rows), peak "
        f"{restore_peak:.2f} GB through it (setup peak {setup_peak_gb:.2f} GB + cache "
        f"{cache_gb:.3f} GB); streams held bit for bit {out['held_bit_for_bit']}, recomputed "
        f"streams' prefix shared with the uninterrupted mesh run {shared}; launches "
        f"{post['launches']} as predicted [{card}]")
    del sched, restored
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_esp_path(torch, mesh, card: str, esp_run: dict):
    """Phase 3f at mixtral-8x22b width: 3b's traffic (8 x 256-token prompts,
    32 new tokens, capacity factor 2.0, dense cache of max_seq 1024) with
    ESP on the 1 x 1 NCCL mesh: the experts' buckets through
    ``esp_expert_ffn`` (the ragged pair on the rank's hidden shard, the
    reduce-scatter onto d), decode through the partials kernel and the LSE
    merge. Launches as predicted (the ragged pair 4 x 33, no gather/scatter
    pair, no ``gmm_fused_ffn``); TTFT, tok/s, busy share and peak memory
    logged beside 3b's no-mesh ESP run (``esp_run``). Returns the
    launches, layer 0's buckets (phase 5) and the run's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode as FD
    from repro_torch.kernels.flash_decode.paged import flash_decode_paged
    from repro_torch.kernels.gmm import ragged as K
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.data import request_stream
    from repro_torch.runtime.serve import ServeConfig, Server

    n_layers, batch, prompt_len, n_new = 4, 8, 256, 32
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    srv = Server(cfg, ParallelCtx(mesh=mesh, moe_impl="esp"), params,
                 ServeConfig(max_seq=1024, batch=batch, paged=False), device="cuda")
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompt = next(request_stream(cfg.vocab_size, batch, prompt_len, seed=0))
    srv.generate(prompt, 2)     # warm-up: first-call costs stay out of the timed run
    kernels = (K.gmm_dual_act_ragged, K.gmm_ragged, K.gmm_dual_act_gather, K.gmm_scatter,
               K.gmm_fused_ffn, FD.flash_decode_partials, FD.flash_decode, flash_attention,
               flash_decode_paged, *op_layer_kernels())
    for k in kernels:
        k.launches = 0
    out, logits, ttft_s, decode_s = timed_generate(torch, srv, prompt, n_new)
    launches = {k.__name__: k.launches for k in kernels}
    predicted = {
        "gmm_dual_act_ragged": n_layers * (1 + n_new), "gmm_ragged": n_layers * (1 + n_new),
        "gmm_dual_act_gather": 0, "gmm_scatter": 0, "gmm_fused_ffn": 0,
        "flash_decode_partials": n_layers * n_new, "flash_decode": 0,
        "flash_attention": n_layers, "flash_decode_paged": 0,
        **{k.__name__: 0 for k in op_layer_kernels()},
    }
    if launches != predicted:
        raise AssertionError(f"phase 3f ESP launch counts {launches} != predicted {predicted}")
    out_cpu = out.cpu()
    if out_cpu.shape != (batch, n_new) or int(out_cpu.min()) < 0 or \
            int(out_cpu.max()) >= cfg.vocab_size:
        raise AssertionError(f"phase 3f ESP tokens out of range: shape {tuple(out_cpu.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("phase 3f: non-finite ESP prefill logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    groups = expert_groups(torch, srv, prompt)
    profile = profile_decode(torch, srv, prompt, card)
    tok_s = batch * n_new / decode_s
    log(
        f"phase 3f ESP under the 1 x 1 NCCL mesh: mixtral-8x22b width, {n_layers} layers, bf16, "
        f"dense cache, {batch} x {prompt_len}-token prompts -> {n_new} decode steps (after a "
        f"warm-up run): setup {setup_s:.2f}s, TTFT (prefill) {ttft_s * 1e3:.1f} ms (3b with no "
        f"mesh: {esp_run['ttft_ms']:.1f}), decode {decode_s * 1e3:.1f} ms = {tok_s:.1f} tok/s "
        f"(3b: {esp_run['decode_tok_s']:.1f}), device busy "
        f"{100 * profile['device_busy_share']:.1f}% (3b: "
        f"{100 * esp_run['device_busy_share']:.1f}%), peak memory {peak_gb:.2f} GB (3b: "
        f"{esp_run['peak_gb']:.2f}), launches {launches}, layer-0 expert rows prefill "
        f"{groups['prefill'][1].tolist()} (cap={groups['prefill'][0]}) decode "
        f"{groups['decode'][1].tolist()} (cap={groups['decode'][0]}) [{card}]"
    )
    return launches, groups, {
        "ttft_ms": ttft_s * 1e3, "decode_ms": decode_s * 1e3, "decode_tok_s": tok_s,
        "peak_gb": peak_gb, **profile}


# ---------------------------------------------------------------------------
# phases 2 and 3g: the other model families
# ---------------------------------------------------------------------------

FAMILIES = ("qwen2-72b", "tinyllama-1.1b", "deepseek-7b", "zamba2-1.2b", "xlstm-350m",
            "seamless-m4t-medium", "internvl2-76b")
# phase 3g: arch -> (layers the run keeps, None = the full depth; paged cache)
FAMILY_RUNS = {"qwen2-72b": (4, False), "internvl2-76b": (4, True),
               "seamless-m4t-medium": (None, False), "zamba2-1.2b": (None, False),
               "xlstm-350m": (None, False)}


def all_kernels():
    """Every kernel wrapper of the port (thirteen, each partials mode apart)."""
    from repro_torch.benchmarks.bench_kernels import kernel_wrappers

    return kernel_wrappers()


def family_launches(cfg, paged: bool, n_new: int) -> dict:
    """The launches of one ``generate`` of ``n_new`` tokens (one prefill,
    ``n_new`` decode steps) on a dense-FFN model: ``flash_attention`` once
    a self-attention layer in the prefill (an encoder's layers too,
    non-causal), the dense or the paged decode kernel once a
    self-attention layer and step, and no other kernel (the MLPs,
    cross-attention and the recurrences are plain, as in the reference)."""
    from repro_torch.models.transformer import zamba_layout

    pat = cfg.block_pattern
    attn = (zamba_layout(cfg)[0] if pat == "zamba" else 0 if pat == "xlstm"
            else cfg.n_layers)
    want = {k.__name__: 0 for k in all_kernels()}
    want["flash_attention"] = attn + (cfg.n_encoder_layers if pat == "encdec" else 0)
    want["flash_decode_paged" if paged else "flash_decode"] = attn * n_new
    return want


def small_family_parity(torch, arch: str) -> dict:
    """``arch``'s smoke() model at head dim 32 (the kernels' gate takes 32,
    64 and 128), fp32, served on the card with the kernels and on the plain
    path: the greedy tokens must agree, and the kernel run's launches equal
    ``family_launches``. internvl2 and seamless get the CLI's stub embeds,
    internvl2 on the paged cache. Returns the kernel run's launches."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.launch.serve import stub_embeds
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = dataclasses.replace(smoke(get_config(arch)), head_dim=32)
    paged, n_new = arch == "internvl2-76b", 12
    prompt = torch.randint(0, cfg.vocab_size, (4, 12),
                           generator=torch.Generator().manual_seed(31))
    embeds = stub_embeds(cfg, 4, 0, torch.float32, "cuda")
    outs, launched = [], {}
    for uk in ("auto", False):
        for k in all_kernels():
            k.launches = 0
        params = T.init_params(cfg, seed=32, device="cuda")
        srv = Server(cfg, ParallelCtx(use_kernels=uk), params,
                     ServeConfig(max_seq=64, batch=4, paged=paged, page_size=16),
                     device="cuda")
        outs.append(srv.generate(prompt, n_new, embeds=embeds).cpu())
        if uk == "auto":
            launched = {k.__name__: k.launches for k in all_kernels()}
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError(f"{arch} small model: kernel vs plain tokens differ:\n"
                             f"{outs[0]}\n{outs[1]}")
    want = family_launches(cfg, paged, n_new)
    if launched != want:
        raise AssertionError(f"{arch} small model launches {launched} != {want}")
    return {k: v for k, v in launched.items() if v}


def recurrence_profile(torch, srv, prompt, embeds, steps: int = 8) -> dict:
    """Host and device time inside the plain recurrences over ``steps``
    decode steps under ``torch.profiler``: each call of a Mamba2, mLSTM or
    sLSTM block runs in a ``record_function`` range (a window apart from
    the busy-share profile, so the ranges do not enter its sums)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import ssm

    names = ("mamba_apply", "mlstm_apply", "slstm_apply")
    orig = {n: getattr(ssm, n) for n in names}

    def ranged(fn):
        def call(*args, **kwargs):
            with record_function("plain recurrence"):
                return fn(*args, **kwargs)
        return call

    logits, cache = srv.prefill(prompt, embeds=embeds)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    logits, cache = srv.decode(tok, cache)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    torch.cuda.synchronize()
    for n in names:
        setattr(ssm, n, ranged(orig[n]))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = srv.decode(tok, cache)
                tok = torch.argmax(logits[:, -1:], dim=-1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for n in names:
            setattr(ssm, n, orig[n])
    host_ms = dev_ms = kernels_ms = 0.0
    for e in prof.key_averages():
        if e.key == "plain recurrence":
            if e.device_type != torch.autograd.DeviceType.CUDA:
                host_ms += e.cpu_time_total / 1e3
                dev_ms += (e.device_time_total if hasattr(e, "device_time_total")
                           else e.cuda_time_total) / 1e3
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            kernels_ms += (e.self_device_time_total if hasattr(e, "self_device_time_total")
                           else e.self_cuda_time_total) / 1e3
    if dev_ms <= 0.0:
        raise AssertionError("the profile gave the recurrence ranges no device time")
    return {"steps": steps, "wall_ms": wall_ms, "host_ms": host_ms, "host_share": host_ms / wall_ms,
            "device_ms": dev_ms, "device_kernels_ms": kernels_ms,
            "device_share": dev_ms / kernels_ms}


def family_path(torch, arch: str, card: str) -> dict:
    """Phase 3g for one family at its full width: bf16, 8 x 256-token
    prompts, 32 new tokens, max_seq 1024, after a warm-up run. Launches as
    ``family_launches`` predicts (every other kernel 0); TTFT, decode tok/s,
    the busy share over 8 profiled decode steps, peak memory and the
    phase's wall time; for zamba2 and xlstm the recurrences' share of the
    decode step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import stub_embeds
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.data import request_stream
    from repro_torch.runtime.serve import ServeConfig, Server

    n_layers, paged = FAMILY_RUNS[arch]
    batch, prompt_len, n_new = 8, 256, 32
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    srv = Server(cfg, ParallelCtx(), params,
                 ServeConfig(max_seq=1024, batch=batch, paged=paged, page_size=128),
                 device="cuda")
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_phase
    prompt = next(request_stream(cfg.vocab_size, batch, prompt_len, seed=0))
    # the stub's embeds in the model's dtype on purpose: seamless's encoder
    # and flash_attention then run in bf16 (fp32 embeds, as the reference's
    # CLI draws them, would run the encoder in fp32)
    embeds = stub_embeds(cfg, batch, 0, torch.bfloat16, "cuda")
    srv.generate(prompt, 2, embeds=embeds)    # warm-up
    for k in all_kernels():
        k.launches = 0
    out, logits, ttft_s, decode_s = timed_generate(torch, srv, prompt, n_new, embeds)
    launches = {k.__name__: k.launches for k in all_kernels()}
    predicted = family_launches(cfg, paged, n_new)
    if launches != predicted:
        raise AssertionError(f"phase 3g {arch}: launches {launches} != predicted {predicted}")
    out_cpu = out.cpu()
    if out_cpu.shape != (batch, n_new) or int(out_cpu.min()) < 0 or \
            int(out_cpu.max()) >= cfg.vocab_size:
        raise AssertionError(f"phase 3g {arch}: tokens out of range: {tuple(out_cpu.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"phase 3g {arch}: non-finite prefill logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = profile_decode(torch, srv, prompt, card, embeds=embeds)
    run = {"ttft_ms": ttft_s * 1e3, "decode_ms": decode_s * 1e3,
           "decode_tok_s": batch * n_new / decode_s, "peak_gb": peak_gb,
           "layers": cfg.n_layers, "paged": paged, **profile}
    rec = ""
    if cfg.block_pattern in ("zamba", "xlstm"):
        run["recurrence"] = r = recurrence_profile(torch, srv, prompt, embeds)
        rec = (f"; the plain recurrences over {r['steps']} profiled decode steps: host "
               f"{r['host_ms']:.1f} of {r['wall_ms']:.1f} ms wall ({r['host_share']:.1%}), "
               f"device {r['device_ms']:.2f} of {r['device_kernels_ms']:.2f} ms of kernels "
               f"({r['device_share']:.1%})")
    del srv
    torch.cuda.synchronize()
    run["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 3g {arch}: {cfg.n_layers} layers, bf16, {'paged' if paged else 'dense'} "
        f"cache, {batch} x {prompt_len}-token prompts"
        + (f" + {cfg.frontend_tokens} stub embeds (bf16)" if cfg.frontend_stub else "")
        + f" -> {n_new} decode steps (after a warm-up run): setup {setup_s:.2f}s, TTFT "
        f"(prefill) {run['ttft_ms']:.1f} ms, decode {run['decode_ms']:.1f} ms = "
        f"{run['decode_tok_s']:.1f} tok/s, device busy {run['device_busy_share']:.1%}, peak "
        f"memory {peak_gb:.2f} GB, phase {run['phase_s']:.1f}s, launches "
        f"{ {k: v for k, v in launches.items() if v} } as predicted{rec} [{card}]")
    return {"launches": {k: v for k, v in launches.items() if v}, **run}, out_cpu


# phase 3g (m): the families that serve under a mesh since item 6
FAMILY_MESH = ("zamba2-1.2b", "xlstm-350m", "seamless-m4t-medium")


def family_mesh_launches(cfg, n_new: int) -> dict:
    """The launches of one ``generate`` of ``n_new`` tokens on the 1 x 1
    mesh: ``flash_attention`` as without it (``family_launches``), and the
    dense-cache decode through ``flash_decode``'s partials mode and the
    LSE merge (the ``attn`` mesh path's ``seq_parallel_decode_attend``),
    once a self-attention layer and step; the normalised ``flash_decode``
    none, cross-attention and the recurrences plain."""
    want = family_launches(cfg, False, n_new)
    want["flash_decode_partials"] = want.pop("flash_decode")
    want["flash_decode"] = 0
    return want


def small_family_mesh_parity(torch, mesh, arch: str) -> dict:
    """Phase 3g (m): ``arch``'s smoke() model at head dim 32, fp32, served
    with the kernels on the 1 x 1 NCCL mesh and without it: greedy tokens
    equal, the prefill's and each decode step's logits within the fp32
    limit, the mesh run's launches as ``family_mesh_launches`` predicts.
    Returns the mesh run's launches and the logits' excess."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.kernels.tolerance import PLAIN
    from repro_torch.launch.serve import stub_embeds
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = dataclasses.replace(smoke(get_config(arch)), head_dim=32)
    n_new = 12
    prompt = torch.randint(0, cfg.vocab_size, (4, 12),
                           generator=torch.Generator().manual_seed(33))
    embeds = stub_embeds(cfg, 4, 0, torch.float32, "cuda")
    runs = {}
    for name, ctx in (("mesh", ParallelCtx(mesh=mesh)), ("no mesh", ParallelCtx())):
        zero_launches()
        srv = Server(cfg, ctx, T.init_params(cfg, seed=34, device="cuda"),
                     ServeConfig(max_seq=64, batch=4), device="cuda")
        logits, cache = srv.prefill(prompt, embeds=embeds)
        steps, toks = [logits], []
        tok = torch.argmax(logits[:, -1:], dim=-1)
        for _ in range(n_new):
            toks.append(tok)
            logits, cache = srv.decode(tok, cache)
            steps.append(logits)
            tok = torch.argmax(logits[:, -1:], dim=-1)
        torch.cuda.synchronize()
        runs[name] = (torch.cat(toks, 1).cpu(), steps, read_launches())
    (tm, lm, launched), (tn, ln, _) = runs["mesh"], runs["no mesh"]
    if not torch.equal(tm, tn):
        raise AssertionError(f"phase 3g (m) small {arch}: mesh tokens differ from the "
                             f"no-mesh run's:\n{tm}\n{tn}")
    ex = max(held(torch, a, b, PLAIN[torch.float32],
                  f"phase 3g (m) small {arch} logits, step {i}")["excess"]
             for i, (a, b) in enumerate(zip(lm, ln, strict=True)))
    want = family_mesh_launches(cfg, n_new)
    if launched != want:
        raise AssertionError(f"phase 3g (m) small {arch}: launches {launched} != {want}")
    return {"launches": {k: v for k, v in launched.items() if v}, "excess": ex}


def family_mesh_path(torch, arch: str, mesh, card: str, no_mesh_tokens) -> dict:
    """Phase 3g (m) for one family at its full width and depth on the 1 x 1
    NCCL mesh, after its no-mesh run of 3g (whose kernels and cuBLAS
    shapes are warm): bf16, 3g's prompts, embeds and 32 new tokens after a
    short warm-up on the mesh; launches as ``family_mesh_launches``
    predicts; TTFT, decode tok/s, the busy share over 4 profiled decode
    steps, peak memory; each request's bf16 token prefix shared with the
    no-mesh run (logged: the mesh's partials decode and LSE merge round
    apart from the normalised kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import stub_embeds
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.data import request_stream
    from repro_torch.runtime.serve import ServeConfig, Server

    batch, prompt_len, n_new = 8, 256, 32
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    srv = Server(cfg, ParallelCtx(mesh=mesh),
                 T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda"),
                 ServeConfig(max_seq=1024, batch=batch), device="cuda")
    prompt = next(request_stream(cfg.vocab_size, batch, prompt_len, seed=0))
    embeds = stub_embeds(cfg, batch, 0, torch.bfloat16, "cuda")
    srv.generate(prompt[:, :16], 2, embeds=embeds)    # warm-up on the mesh
    zero_launches()
    out, logits, ttft_s, decode_s = timed_generate(torch, srv, prompt, n_new, embeds)
    launches = read_launches()
    predicted = family_mesh_launches(cfg, n_new)
    if launches != predicted:
        raise AssertionError(f"phase 3g (m) {arch}: launches {launches} != {predicted}")
    out_cpu = out.cpu()
    if out_cpu.shape != (batch, n_new) or int(out_cpu.min()) < 0 or \
            int(out_cpu.max()) >= cfg.vocab_size:
        raise AssertionError(f"phase 3g (m) {arch}: tokens out of range")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"phase 3g (m) {arch}: non-finite prefill logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # 4 profiled steps, where 3g takes 8: the profiler's own start-up and
    # processing are most of a zamba2 window's seconds
    profile = profile_decode(torch, srv, prompt, card, steps=4, embeds=embeds)
    same = (out_cpu == no_mesh_tokens).int().cumprod(dim=1).sum(dim=1).tolist()
    del srv
    torch.cuda.synchronize()
    run = {"ttft_ms": ttft_s * 1e3, "decode_ms": decode_s * 1e3,
           "decode_tok_s": batch * n_new / decode_s, "peak_gb": peak_gb,
           "prefix_shared_with_no_mesh": same, "phase_s": time.perf_counter() - t_phase,
           **profile}
    log(f"phase 3g (m) {arch} on the 1 x 1 NCCL mesh: {cfg.n_layers} layers, bf16, dense "
        f"cache, {batch} x {prompt_len}-token prompts -> {n_new} decode steps: TTFT (prefill) "
        f"{run['ttft_ms']:.1f} ms, decode {run['decode_ms']:.1f} ms = "
        f"{run['decode_tok_s']:.1f} tok/s, device busy {run['device_busy_share']:.1%}, peak "
        f"memory {peak_gb:.2f} GB, phase {run['phase_s']:.1f}s, launches "
        f"{ {k: v for k, v in launches.items() if v} } as predicted; bf16 tokens shared with "
        f"the no-mesh run from the start: {same} of {n_new} [{card}]")
    return {"launches": {k: v for k, v in launches.items() if v}, **run}


# ---------------------------------------------------------------------------
# phase 3h: training on one process (and (d) on the 1 x 1 NCCL mesh)
# ---------------------------------------------------------------------------
# phase 3i: the kernel bench, the dry run and the roofline
# ---------------------------------------------------------------------------

# the bench's FFN paths and the kernels each must launch (the einsum path
# is plain); fp32 at the bench's widths takes gmm_fused_ffn's FMA body
BENCH_FFN_KERNELS = {
    "einsum_padded_dispatch": set(),
    "gmm_padded_dispatch": {"gmm_dual_act", "gmm"},
    "gmm_ragged_padded_dispatch": {"gmm_dual_act_ragged", "gmm_ragged"},
    "gmm_gather_fused_dispatch": {"gmm_dual_act_gather", "gmm_ragged"},
    "gmm_compact_fused_combine": {"gmm_dual_act_gather", "gmm_scatter"},
    "gmm_fused_ffn_combine": {"gmm_fused_ffn"},
}
# (name, arch, layers kept (None: all), shape, mesh) of the dry-run cells
DRYRUN_CELLS = (("llama3.2-1b 2 layers, 2 x 4 test mesh", "llama3.2-1b", 2, "decode_32k",
                 "test"),
                ("dbrx-132b, ER 16 x 16", "dbrx-132b", None, "decode_32k", "single"),
                ("zamba2-1.2b, ER 16 x 16", "zamba2-1.2b", None, "decode_32k", "single"),
                ("seamless-m4t-medium, ER 16 x 16", "seamless-m4t-medium", None, "decode_32k",
                 "single"))


def bench_families(iters: int, smoke: bool) -> dict:
    """The kernel bench's five families on the card; every parity check
    of the bench raises on a failure."""
    from repro_torch.benchmarks import bench_kernels as B

    out = {}
    for fam, fn, kw in (("ffn", B.run, {"smoke": smoke}),
                        ("decode", B.run_decode, {"smoke": smoke}),
                        ("migration", B.run_migration, {"smoke": smoke}),
                        ("prefill", B.run_prefill, {"smoke_mode": smoke}),
                        ("ep_chunk", B.run_ep_chunk, {"smoke": smoke})):
        t0 = time.perf_counter()
        out[fam] = {"rows": fn(iters=iters, device="cuda", **kw),
                    "seconds": time.perf_counter() - t0}
    return out


def bench_timings(fam: str, rows: list) -> list[str]:
    """One entry a timed path of a family's rows: wall and CUDA-event ms
    and the kernels it launched."""
    out = []
    for r in rows:
        if fam in ("ffn", "decode"):
            for p, c in r["paths"].items():
                out.append(f"{r['shape']}/{p} {c['wall_ms']:.3f}/{c['event_ms']:.4f} ms "
                           f"{c['launches']}")
        elif fam == "migration":
            out.append(f"{r['shape']} step {r['step_wall_ms']:.3f}/{r['step_event_ms']:.4f} "
                       f"ms, step + slice {r['step_plus_slice_wall_ms']:.3f}/"
                       f"{r['step_plus_slice_event_ms']:.4f} ms {r['launches']}")
        elif fam == "prefill":
            out.append(f"{r['shape']} decode {r['decode_wall_ms']:.3f}/"
                       f"{r['decode_event_ms']:.4f} ms, + chunk "
                       f"{r['decode_plus_chunk_wall_ms']:.3f}/"
                       f"{r['decode_plus_chunk_event_ms']:.4f} ms {r['launches']}")
        else:
            for kk, c in r["chunks"].items():
                out.append(f"{r['shape']}/K={kk} {c['wall_ms']:.3f}/{c['event_ms']:.4f} ms "
                           f"{c['launches']}")
    return out


def check_bench_launches(runs: dict, what: str) -> None:
    """Every kernel path of the FFN, decode, migration and prefill families
    launched its kernels (and the plain einsum path none); the EP-chunk
    family's are logged."""
    for r in runs["ffn"]["rows"]:
        for p, c in r["paths"].items():
            if set(c["launches"]) != BENCH_FFN_KERNELS[p]:
                raise AssertionError(f"{what} {r['shape']}/{p}: launched {c['launches']}, "
                                     f"want {sorted(BENCH_FFN_KERNELS[p])}")
    for r in runs["decode"]["rows"]:
        for p, want in (("flash_decode_dense_masked", "flash_decode"),
                        ("flash_decode_paged", "flash_decode_paged")):
            if r["paths"][p]["launches"] != {want: 1}:
                raise AssertionError(f"{what} {r['shape']}/{p}: launched "
                                     f"{r['paths'][p]['launches']}")
    for r in runs["migration"]["rows"]:
        if r["launches"] != {"gmm_dual_act_ragged": r["L"], "gmm_ragged": r["L"]}:
            raise AssertionError(f"{what} {r['shape']}: launched {r['launches']}")
    for r in runs["prefill"]["rows"]:   # the decode lane's paged attention, a layer
        if r["launches"] != {"flash_decode_paged": r["L"]}:
            raise AssertionError(f"{what} {r['shape']}: launched {r['launches']}")


def bench_launch_totals(runs: dict) -> dict:
    """kernel -> {family/path: launches of one call}, over every path."""
    totals: dict = {}

    def add(where, launches):
        for k, n in launches.items():
            totals.setdefault(k, {})[where] = totals.get(k, {}).get(where, 0) + n

    for fam, run in runs.items():
        for r in run["rows"]:
            if "paths" in r:
                for p, c in r["paths"].items():
                    add(f"{fam}/{p}", c["launches"])
            elif "chunks" in r:
                for kk, c in r["chunks"].items():
                    add(f"{fam}/K={kk}", c["launches"])
            else:
                add(fam, r["launches"])
    return totals


def dryrun_cells(out_dir: str) -> None:
    """The dry-run cells of phase 3i (d), one record file each; run in a
    process of its own (``python3 -c``)."""
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_test_mesh

    Path(out_dir).mkdir(parents=True, exist_ok=True)
    for i, (name, arch, layers, shape, mesh_kind) in enumerate(DRYRUN_CELLS):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        if mesh_kind == "test":
            D.fake_world(8)
            rec = {"arch": arch, "shape": shape, "mesh": "2x4", "mapping": "none",
                   **D.trace_cell(cfg, SHAPES[shape], make_test_mesh(2, 4)), "status": "OK"}
        else:
            rec = D.run_cell(arch, shape, mesh_kind, "er", cfg=cfg)
        rec["cell"] = name
        rec["t_total_s"] = time.perf_counter() - t0
        (Path(out_dir) / f"{i}.json").write_text(json.dumps(rec))


def tp_prediction(cfg, shape, data: int, model: int) -> dict:
    """Rank 0's parameter and argument bytes and collective calls and
    bytes in a ``decode_*`` dry-run cell under tensor parallelism, of the
    ``attn``, ``zamba`` and ``encdec`` patterns, predicted from the layout
    (``parallel.sharding.tp_layout`` and ``mamba_layout``); bf16, the
    router and the Mamba2 ``a_log``, ``dt_bias`` and ``d_skip`` fp32.

    A rank holds every attention's query heads (H / M) and their rows of
    ``wo`` and its KV heads (K / M, or a copy of one where M is a multiple
    of K) where the heads split, every dense MLP's hidden block where
    ``d_ff`` splits, E / M experts (EP), the vocab rows of ``embed`` and
    columns of ``lm_head`` where the vocab splits, zamba's Mamba2 heads (64
    channels each) with the 2N B/C columns whole, and the norms whole. The
    other arguments: the dense K/V cache (a self-attention layer, zamba's
    ``shared_kv`` a unit, ``cross_kv`` a decoder layer) split over the
    model axis by slots with every KV head, the Mamba2 states of the rank's
    heads (fp32), one int32 token a row and the rank's rows of the
    frontend embeds (bf16).

    Calls: an attention LSE-merges with three all-reduces (the max and the
    weights fp32, the weighted values), all-reduces after a split ``wo``,
    and all-gathers ``q``'s split heads and, where the rank projects fewer
    than all KV heads, the new K/V rows (the cross-attention's were cached
    at prefill); one all-reduce after a split ``w_down`` or EP's decode
    ownership sum, and EP's three all-to-alls; two all-reduces a split
    Mamba2 layer (the gated norm's fp32 sum of squares, the out
    projection); a split vocab one all-reduce for the embedding and one
    all-gather for the logits. Bytes are the operands' (an all-reduce
    counts twice); EP's all-to-all bytes are left out (``tests/
    test_torch_dryrun.py`` holds them to the static buffers)."""
    d, hd, m, n_kv = cfg.d_model, cfg.head_dim_, model, cfg.n_kv_heads
    assert shape.kind == "decode" and shape.seq_len % m == 0
    split_heads = cfg.n_heads % m == 0 and (n_kv % m == 0 or m % n_kv == 0)
    h = cfg.n_heads // m if split_heads else cfg.n_heads
    k = (n_kv // m or 1) if split_heads else n_kv
    split_ff, split_vocab = cfg.d_ff % m == 0, cfg.vocab_size % m == 0
    f = cfg.d_ff // m if split_ff else cfg.d_ff
    v = cfg.vocab_size // m if split_vocab else cfg.vocab_size
    rows = shape.global_batch // data
    act = rows * d * 2                                  # one token's activations
    kv = 2 * rows * (shape.seq_len // m) * n_kv * hd * 2   # one layer's cache shard
    calls, moved = {}, {}

    def add(kind, n, nbytes=0):
        calls[kind] = calls.get(kind, 0) + n
        moved[kind] = moved.get(kind, 0) + nbytes

    def attention(n, cross=False):
        """One attention block's parameter bytes; its collectives n times."""
        add("all-reduce", n * (3 + split_heads),
            n * 2 * (rows * cfg.n_heads * (4 + 2 * hd + 4) + split_heads * act))
        add("all-gather", n * split_heads, n * split_heads * rows * h * hd * 2)
        if split_heads and k < n_kv and not cross:
            add("all-gather", n, n * 2 * rows * k * hd * 2)
        return 2 * (2 * d * h * hd + 2 * d * k * hd)

    def mlp(n):
        add("all-reduce", n * split_ff, n * split_ff * 2 * act)
        return 2 * 3 * d * f

    def experts(n):
        add("all-reduce", n, n * 2 * act)
        add("all-to-all", 3 * n)
        return 2 * cfg.n_experts // m * 3 * d * cfg.moe_d_ff_ + 4 * d * cfg.n_experts

    add("all-reduce", split_vocab, split_vocab * 2 * act)
    add("all-gather", split_vocab, split_vocab * rows * v * 2)
    params = 2 * (v * d * (1 if cfg.tie_embeddings else 2) + d)
    inputs = rows * 4
    L = cfg.n_layers
    if cfg.block_pattern == "attn":
        params += L * (4 * d + attention(L) + (experts(L) if cfg.is_moe else mlp(L)))
        cache = L * kv
    elif cfg.block_pattern == "zamba":
        units = cfg.n_layers // cfg.attn_every
        n, nh = cfg.ssm_state, 2 * d // 64
        split_mamba = nh % m == 0
        hm = nh // m if split_mamba else nh
        c, bc = hm * 64, hm * 64 + 2 * n
        add("all-reduce", 2 * L * split_mamba, L * split_mamba * 2 * (rows * 4 + act))
        params += L * (2 * (d + d * c + d * bc + d * nh + 4 * bc + bc + c * d + c) + 4 * 3 * nh)
        params += 4 * d + attention(units) + mlp(units)        # the shared block, once
        cache = L * 4 * rows * (3 * bc + hm * 64 * n) + units * kv
    else:
        assert cfg.block_pattern == "encdec" and cfg.frontend_tokens % m == 0
        params += 2 * d + cfg.n_encoder_layers * (4 * d + attention(0) + mlp(0)) \
            + L * (6 * d + attention(L) + attention(L, cross=True) + mlp(L))
        cache = L * (kv + 2 * rows * (cfg.frontend_tokens // m) * n_kv * hd * 2)
        inputs += rows * cfg.frontend_tokens * d * 2
    return {"param_bytes": params, "argument_size_in_bytes": params + cache + inputs,
            "collective_calls": {kind: c for kind, c in calls.items() if c},
            "collectives": {kind: b for kind, b in moved.items()
                            if calls[kind] and kind != "all-to-all"}}


def kernel_bench_path(torch, card: str) -> dict:
    """Phase 3i: (a) the bench's smoke cells, (b) its full shape lists,
    (c) its ``--check``, (d) the dry run in a subprocess, (e) the
    roofline over the dry run's records."""
    import os

    from repro_torch.benchmarks import bench_kernels as B
    from repro_torch.figures import roofline

    t_phase = time.perf_counter()
    smoke_runs = bench_families(2, smoke=True)
    check_bench_launches(smoke_runs, "phase 3i (a) smoke")
    log("phase 3i (a) kernel bench smoke cells on the card, parity held in all five families: "
        + "; ".join(f"{fam} {r['seconds']:.1f} s" for fam, r in smoke_runs.items())
        + f" [{card}]")
    full = bench_families(20, smoke=False)
    check_bench_launches(full, "phase 3i (b)")
    for fam, run in full.items():
        log(f"phase 3i (b) kernel bench {fam} (best of 20, wall/CUDA-event ms, launches of "
            f"one call; reference shapes, fp32, launch-bound): "
            + "; ".join(bench_timings(fam, run["rows"])) + f" [{card}]")
    failures = B.check_baseline(str(ROOT / "BENCH_kernels.json"))
    if failures:
        raise AssertionError(f"phase 3i (c): {len(failures)} mismatches against "
                             f"BENCH_kernels.json: {failures[:5]}")
    log("phase 3i (c) check_baseline(BENCH_kernels.json): 0 mismatches")
    out_dir = ROOT / "results" / "torch" / "chip_smoke_dryrun"
    for f in out_dir.glob("*.json"):
        f.unlink()
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.dryrun_cells({str(out_dir)!r})"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise AssertionError(f"phase 3i (d): the dry run exited {res.returncode}: "
                             f"{res.stderr[-3000:]}")
    records = [json.loads(f.read_text()) for f in sorted(out_dir.glob("*.json"))]
    for rec in records:
        if rec["status"] != "OK" or not rec["collectives"]["total"] > 0:
            raise AssertionError(f"phase 3i (d) {rec.get('cell')}: {rec['status']} "
                                 f"{rec.get('error', '')[-1500:]}")
        # tensor parallelism: the rank's slices and their collectives, as
        # the layout predicts
        from repro_torch.configs import SHAPES, get_config

        _, arch, layers, shape, kind = next(c for c in DRYRUN_CELLS if c[0] == rec["cell"])
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        data, model = (2, 4) if kind == "test" else (16, 16)
        want = tp_prediction(cfg, SHAPES[shape], data, model)
        got = {k: rec[k] for k in ("param_bytes", "argument_size_in_bytes", "collective_calls")}
        got["collectives"] = {k: rec["collectives"].get(k) for k in want["collectives"]}
        if got != want:
            raise AssertionError(f"phase 3i (d) {rec['cell']}: {got} != the layout's "
                                 f"prediction {want}")
        log(f"phase 3i (d) tensor parallelism {rec['cell']} {rec['shape']}: rank 0's "
            f"parameters {rec['param_bytes']} B, arguments "
            f"{rec['argument_size_in_bytes']} B, collective calls "
            f"{rec['collective_calls']}, bytes {got['collectives']}, as the layout predicts")
        log(f"phase 3i (d) dry run {rec['cell']} {rec['shape']}: {rec['status']}, "
            f"{rec['flops']:.4g} FLOP, arguments {rec['argument_size_in_bytes'] / 1e9:.3f} GB, "
            f"temp {rec['temp_size_in_bytes'] / 1e9:.3f} GB, collectives "
            f"{rec['collectives']['total'] / 1e9:.4f} GB "
            f"({', '.join(f'{k} {v}' for k, v in rec['collective_calls'].items())} calls), "
            f"{rec['t_total_s']:.1f} s (rank 0 of {rec['n_devices']}, fake tensors on the host)")
    rows = [roofline.analyze_record(rec) for rec in records]
    for rec, r in zip(records, rows):
        log(f"phase 3i (e) roofline {rec['cell']} (model output at H100 datasheet constants, "
            f"not measured): compute {r['t_compute_s'] * 1e3:.3f} ms, memory "
            f"{r['t_memory_s'] * 1e3:.3f} ms, collective {r['t_collective_s'] * 1e3:.3f} ms, "
            f"dominant {r['dominant']}, useful FLOP ratio {r['useful_ratio']:.3f}, roofline "
            f"fraction {r['roofline_fraction']:.3f}, HBM/dev {r['hbm_per_device_gb']:.2f} GB"
            + (" (the model FLOPs count the full 16 layers)" if "2 layers" in rec["cell"]
               else ""))
    seconds = time.perf_counter() - t_phase
    log(f"phase 3i: {seconds:.1f} s (dry run subprocess {time.perf_counter() - t0:.1f} s)")
    return {"smoke": smoke_runs, "full": full, "launch_totals": bench_launch_totals(full),
            "check_baseline_mismatches": 0, "dryrun": records, "roofline": rows,
            "seconds": seconds}


# ---------------------------------------------------------------------------

# (a) arch, moe_impl of the small fp32 models trained with the kernels and
# on the plain path
TRAIN_SMALL = (("mixtral-8x22b", "ep"), ("mixtral-8x22b", "esp"), ("mixtral-8x22b", "dense"),
               ("llama3.2-1b", "auto"), ("zamba2-1.2b", "auto"), ("xlstm-350m", "auto"),
               ("seamless-m4t-medium", "auto"), ("internvl2-76b", "auto"))
# A gradient element on which two runs part by more than this share of its
# value can part AdamW's step there by as much: m / (sqrt(v) + eps) is near
# +-1 whatever the gradient's size, so a near-zero gradient rounded apart
# moves its parameter by a different part of lr. Such elements are held at
# 2 * sum(lr), the most two runs can part; every other one at the limit.
TRAIN_APART = 1e-3


def zero_launches():
    for k in all_kernels():
        k.launches = 0


def read_launches() -> dict:
    return {k.__name__: k.launches for k in all_kernels()}


def train_launches(cfg, impl: str, dtype, steps: int, mesh: bool = False) -> dict:
    """The launches of ``steps`` train steps: the forward's only, one a
    kernel call (the registry's backward is plain): ``flash_attention``
    once a self-attention layer (an encoder's too), and on an ``attn`` MoE
    model its expert FFN once a layer: the ragged pair under ``ep``; under
    ``esp`` ``gmm_fused_ffn`` where ``can_gmm_fused`` admits the shapes,
    else the gather/scatter pair; nothing under ``dense``. On a mesh
    (``mesh``) the two swap: EP's fused branch takes the flat-row FFN,
    ESP's hidden-dim shard the ragged pair."""
    from repro_torch.kernels.registry import can_gmm_fused
    from repro_torch.models.transformer import zamba_layout

    pat = cfg.block_pattern
    attn = (zamba_layout(cfg)[0] if pat == "zamba" else 0 if pat == "xlstm"
            else cfg.n_layers + cfg.n_encoder_layers)
    want = {k.__name__: 0 for k in all_kernels()}
    want["flash_attention"] = attn * steps
    if cfg.is_moe and impl in ("ep", "esp"):
        if (impl == "ep") != mesh:
            names = ("gmm_dual_act_ragged", "gmm_ragged")
        elif can_gmm_fused(0, cfg.d_model, cfg.moe_d_ff_, dtype):
            names = ("gmm_fused_ffn",)
        else:
            names = ("gmm_dual_act_gather", "gmm_scatter")
        for n in names:
            want[n] = cfg.n_layers * steps
    return want


def train_batches(torch, cfg, batch: int, seq: int, steps, seed: int) -> list:
    """``SyntheticLM`` batches on the card, a frontend-stub model's with the
    CLI's stub embeds of the same step in the model's dtype."""
    from repro_torch.launch.serve import stub_embeds
    from repro_torch.runtime.data import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(cfg.vocab_size, batch, seq, seed=seed), device="cuda")
    out = []
    for s in steps:
        b = data.batch_at(s)
        e = stub_embeds(cfg, batch, s, torch.float32, "cuda")
        if e is not None:
            b["embeds"] = e
        out.append(b)
    return out


def leaf_excess(torch, got, want, tol, keep=None) -> float:
    """``max |got - want| / (rtol |want| + atol rms(want))`` with the rms of
    the whole leaf (a gradient's or a parameter's own scale), over the
    elements ``keep`` selects (all by default)."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    rms = w.square().mean().sqrt()
    ratio = (g - w).abs() / (tol[0] * w.abs() + tol[1] * rms)
    ratio = torch.nan_to_num(ratio, nan=0.0, posinf=float("inf"))
    if keep is not None:
        ratio = ratio[keep]
    return float(ratio.max()) if ratio.numel() else 0.0


def hold_trained(torch, got: dict, want: dict, grads_got, grads_want, lrs, what: str) -> dict:
    """Hold a trained state and its per-step gradients against another run's
    at the fp32 limit (leaf rms): every gradient; ``mu``; ``nu`` through
    its square root (the gradients' scale); the params, except elements
    whose gradients parted by more than ``TRAIN_APART`` at some step, held
    at ``2 * sum(lrs)``. Raises on a miss."""
    from repro_torch.kernels.tolerance import PLAIN
    from repro_torch.runtime.optimizer import leaves

    tol = PLAIN[torch.float32]
    loose = [torch.zeros_like(p, dtype=torch.bool) for p in leaves(got["params"])]
    ex = {"grads": 0.0, "params": 0.0, "mu": 0.0, "sqrt_nu": 0.0}
    for gg, gw in zip(grads_got, grads_want, strict=True):
        for i, (a, b) in enumerate(zip(leaves(gg), leaves(gw), strict=True)):
            ex["grads"] = max(ex["grads"], leaf_excess(torch, a, b, tol))
            loose[i] |= (a - b).abs() > TRAIN_APART * b.abs()
    bound_lr = 2 * sum(lrs)
    worst_loose = 0.0
    for i, (a, b) in enumerate(zip(leaves(got["params"]), leaves(want["params"]),
                                   strict=True)):
        ex["params"] = max(ex["params"], leaf_excess(torch, a, b, tol, ~loose[i]))
        if bool(loose[i].any()):
            worst_loose = max(worst_loose, float((a - b)[loose[i]].abs().max()))
    for key, fn in (("mu", lambda t: t), ("sqrt_nu", torch.sqrt)):
        src = "mu" if key == "mu" else "nu"
        for a, b in zip(leaves(got["opt"][src]), leaves(want["opt"][src]), strict=True):
            ex[key] = max(ex[key], leaf_excess(torch, fn(a), fn(b), tol))
    if int(got["opt"]["step"]) != int(want["opt"]["step"]):
        raise AssertionError(f"{what}: optimizer steps {int(got['opt']['step'])} != "
                             f"{int(want['opt']['step'])}")
    bad = {k: v for k, v in ex.items() if v > 1.0}
    if bad or worst_loose > bound_lr:
        raise AssertionError(f"{what}: over the fp32 limit {tol}: {bad}; elements near a "
                             f"parted gradient moved {worst_loose:.3g} apart (bound "
                             f"{bound_lr:.3g})")
    n = sum(m.numel() for m in loose)
    return {**{f"excess_{k}": v for k, v in ex.items()},
            "loose_elements": int(sum(int(m.sum()) for m in loose)), "elements": n,
            "loose_max_abs": worst_loose, "loose_bound": bound_lr,
            "bitwise": all(torch.equal(a, b) for a, b in zip(
                leaves(got["params"]), leaves(want["params"])))}


def run_train(torch, cfg, ctx, opt, batches, state, count: bool):
    """``make_train_step`` over ``batches`` from ``state``: (state, each
    step's metrics as floats, each step's gradients, launches). The
    gradients come from ``grads_of`` on the state before each step, outside
    the launch count; every count is set to 0 just before each step and
    read just after."""
    from repro_torch.runtime.train import grads_of, make_train_step

    step = make_train_step(cfg, ctx, opt)
    mets, grads = [], []
    launches = {k.__name__: 0 for k in all_kernels()}
    for b in batches:
        grads.append(grads_of(state["params"], b, cfg, ctx)[0])
        zero_launches()
        state, met = step(state, b)
        torch.cuda.synchronize()
        if count:
            for k, v in read_launches().items():
                launches[k] += v
        mets.append({k: float(v) for k, v in met.items()})
    return state, mets, grads, launches


def hold_metrics(got: list, want: list, what: str) -> None:
    """Each step's loss, ce, aux, grad norm and lr at rtol 1e-4 (atol 1e-6:
    a dense model's aux is 0)."""
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        for k in b:
            if abs(a[k] - b[k]) > 1e-4 * abs(b[k]) + 1e-6:
                raise AssertionError(f"{what} step {i} {k}: {a[k]!r} != {b[k]!r}")
            if k in ("loss", "ce", "grad_norm") and not math.isfinite(a[k]):
                raise AssertionError(f"{what} step {i}: {k} is {a[k]}")


def small_train_parity(torch, arch: str, impl: str, steps: int = 3) -> dict:
    """``arch``'s smoke() model at head dim 32, fp32, ``steps`` train steps
    from one state with the kernels and on the plain path: every step's
    metrics and gradients, and the state after the steps, within the fp32
    limit (``hold_trained``); the kernel run's launches as
    ``train_launches`` predicts."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.optimizer import AdamWConfig
    from repro_torch.runtime.train import init_state

    cfg = dataclasses.replace(smoke(get_config(arch)), head_dim=32)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    batches = train_batches(torch, cfg, 2, 32, range(steps), seed=41)
    runs = {}
    for uk in ("auto", False):
        ctx = ParallelCtx(moe_impl=impl, use_kernels=uk)
        runs[uk] = run_train(torch, cfg, ctx, opt, batches,
                             init_state(cfg, seed=42, device="cuda"), uk == "auto")
    (sk, mk, gk, launched), (sp, mp, gp, _) = runs["auto"], runs[False]
    what = f"phase 3h (a) {arch} {impl}"
    hold_metrics(mk, mp, what)
    out = hold_trained(torch, sk, sp, gk, gp, [m["lr"] for m in mp], what)
    want = train_launches(cfg, impl, torch.float32, steps)
    if launched != want:
        raise AssertionError(f"{what}: launches {launched} != {want}")
    return {"launches": {k: v for k, v in launched.items() if v},
            "losses": [m["loss"] for m in mk], **out}


def small_train_restore(torch) -> dict:
    """The small MoE model (mixtral-8x22b smoke, ``ep``, the kernels): 2
    steps, a ``CheckpointManager`` save, a fresh state restored from it and
    2 more steps, against 4 uninterrupted steps, within the fp32 limit
    (``hold_trained`` over steps 3 and 4)."""
    import tempfile

    from repro_torch.configs import get_config, smoke
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.runtime.optimizer import AdamWConfig, tree_map
    from repro_torch.runtime.train import init_state

    cfg = dataclasses.replace(smoke(get_config("mixtral-8x22b")), head_dim=32)
    ctx = ParallelCtx(moe_impl="ep")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    batches = train_batches(torch, cfg, 2, 32, range(4), seed=45)
    whole, mw, gw, _ = run_train(torch, cfg, ctx, opt, batches,
                                 init_state(cfg, seed=46, device="cuda"), False)
    part, _, _, _ = run_train(torch, cfg, ctx, opt, batches[:2],
                              init_state(cfg, seed=46, device="cuda"), False)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        mgr.save(2, part, extra={"data_step": 2})
        del part
        fresh = init_state(cfg, seed=47, device="cuda")
        restored, meta = mgr.restore(fresh)
    restored = tree_map(lambda t: t.to("cuda"), restored)
    if meta["data_step"] != 2 or int(restored["opt"]["step"]) != 2:
        raise AssertionError(f"phase 3h (a) restore: meta {meta}, step "
                             f"{int(restored['opt']['step'])}")
    resumed, mr, gr, _ = run_train(torch, cfg, ctx, opt, batches[2:], restored, False)
    hold_metrics(mr, mw[2:], "phase 3h (a) restore")
    return hold_trained(torch, resumed, whole, gr, gw[2:], [m["lr"] for m in mw],
                        "phase 3h (a) restored vs uninterrupted")


def grad_distance(torch, g, ref) -> float:
    """Relative L2 distance of one gradient leaf from a reference leaf."""
    d = (g.float() - ref).norm()
    n = ref.norm()
    return float(d / n) if float(n) > 0 else float(d)


def full_width_train(torch, impl: str, card: str, steps: int = 5, mesh=None) -> dict:
    """mixtral-8x22b at full width, cut to 1 layer (56 -> 1), bf16, under
    ``impl``: ``SyntheticLM`` batches of 8 x 256, capacity factor 2.0.
    With ``mesh`` (the 1 x 1 NCCL mesh) also phase 3h (d) (ii):
    :func:`mesh_width_train` on the same state, after the no-mesh steps.

    * Step 0's gradients with the kernels (one launch a kernel form and
      ``flash_attention``), on the plain path, and in fp32 on the plain
      path from the same bf16 weights upcast: each leaf's relative L2
      distance from the fp32 gradients with the kernels must be at most
      twice the plain path's plus 2^-5. Two correct bf16 runs of one model
      part far at init (its gradients are small residues of cancelling
      terms, and a token near a routing tie takes other experts), so the
      elementwise excess of the kernels' gradients over the plain path's
      at the bf16 limit (leaf rms) is logged, not held.
    * The same step under ``remat=True``: twice the forward launches, and
      every gradient within the bf16 limit (leaf rms) of the step without
      remat; logs whether they are bitwise.
    * ``steps`` steps of ``make_train_step`` after a warm-up step, each
      timed with CUDA events, the losses finite, launches once a kernel
      form a step; then ``adamw_update`` alone on fresh gradients, timed;
      the peak memory from the weights' init on."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.tolerance import PLAIN
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.optimizer import AdamWConfig, adamw_init, adamw_update, leaves
    from repro_torch.runtime.optimizer import tree_map
    from repro_torch.runtime.train import grads_of, make_train_step

    cfg = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=1)
    batch, seq = 8, 256
    ctx = ParallelCtx(moe_impl=impl, capacity_factor=2.0)
    plain = dataclasses.replace(ctx, use_kernels=False)
    # the mesh steps take batches of their own, unseen by the no-mesh steps
    n_batches = steps + 2 if mesh is None else 2 * steps + 3
    batches = train_batches(torch, cfg, batch, seq, range(n_batches), seed=43)
    what = f"phase 3h (b) {impl}"
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, seed=44, dtype=torch.bfloat16, device="cuda")
    n_params = sum(p.numel() for p in leaves(params))
    one = train_launches(cfg, impl, torch.bfloat16, 1)

    zero_launches()
    gk, mk = grads_of(params, batches[0], cfg, ctx)
    torch.cuda.synchronize()
    if read_launches() != one:
        raise AssertionError(f"{what}: step 0 launches {read_launches()} != {one}")
    zero_launches()
    gr, _ = grads_of(params, batches[0], cfg, dataclasses.replace(ctx, remat=True))
    torch.cuda.synchronize()
    twice = {k: 2 * v for k, v in one.items()}
    if read_launches() != twice:
        raise AssertionError(f"{what}: remat launches {read_launches()} != {twice}")
    tol = PLAIN[torch.bfloat16]
    remat_ex = max(leaf_excess(torch, a, b, tol) for a, b in zip(leaves(gr), leaves(gk)))
    remat_bitwise = all(torch.equal(a, b) for a, b in zip(leaves(gr), leaves(gk)))
    if remat_ex > 1.0:
        raise AssertionError(f"{what}: remat gradients {remat_ex:.3f} x the bf16 limit")
    del gr
    gp, mp = grads_of(params, batches[0], cfg, plain)
    vs_plain = {}
    for (name, a), b in zip(named_leaves(gk), leaves(gp)):
        vs_plain[name] = leaf_excess(torch, a, b, tol)
    p32 = tree_map(lambda t: t.float(), params)
    g32, m32 = grads_of(p32, batches[0], cfg, plain)
    del p32
    dist = {}
    for (name, a), b, r in zip(named_leaves(gk), leaves(gp), leaves(g32)):
        dk, dp = grad_distance(torch, a, r), grad_distance(torch, b, r)
        dist[name] = (dk, dp)
        if dk > 2 * dp + 2.0**-5:
            raise AssertionError(f"{what}: {name}'s gradient with the kernels is {dk:.4f} "
                                 f"from fp32 against the plain path's {dp:.4f}")
    losses0 = {"kernels": float(mk["loss"]), "plain": float(mp["loss"]),
               "fp32": float(m32["loss"])}
    on_mesh = None
    if mesh is not None:
        on_mesh = mesh_width_step0(torch, cfg, dataclasses.replace(ctx, mesh=mesh), params,
                                   batches[0], gk, gp, g32, float(mk["loss"]), impl)
    del gk, gp, g32
    gc.collect()
    torch.cuda.empty_cache()

    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100)
    state = {"params": params, "opt": adamw_init(params)}
    del params
    step = make_train_step(cfg, ctx, opt)
    state, met = step(state, batches[0])          # warm-up: allocations, first calls
    torch.cuda.synchronize()
    zero_launches()
    ms, losses = [], [float(met["loss"])]
    for b in batches[1 : steps + 1]:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, met = step(state, b)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        losses.append(float(met["loss"]))
    launched = read_launches()
    want = train_launches(cfg, impl, torch.bfloat16, steps)
    if launched != want:
        raise AssertionError(f"{what}: launches {launched} != {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: losses {losses}")
    g, _ = grads_of(state["params"], batches[steps + 1], cfg, ctx)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    adamw_update(g, state["opt"], state["params"], opt)
    e1.record()
    torch.cuda.synchronize()
    adamw_ms = e0.elapsed_time(e1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del g
    if mesh is not None:
        on_mesh.update(mesh_width_steps(torch, cfg, dataclasses.replace(ctx, mesh=mesh), opt,
                                        state, batches[steps + 2 :], steps, impl))
    del state
    mean_ms = sum(ms) / len(ms)
    out = {"params": n_params, "ms_per_step": ms, "mean_ms": mean_ms,
           "tokens_per_s": batch * seq / (mean_ms / 1e3), "adamw_ms": adamw_ms,
           "adamw_share": adamw_ms / mean_ms, "peak_gb": peak_gb, "losses": losses,
           "step0_losses": losses0, "launches": {k: v for k, v in launched.items() if v},
           "remat_excess": remat_ex, "remat_bitwise": remat_bitwise,
           "vs_plain_excess": vs_plain,
           "distance_from_fp32": {k: {"kernels": a, "plain": b} for k, (a, b) in dist.items()},
           "mesh": on_mesh, "phase_s": time.perf_counter() - t0}
    worst = max(dist, key=lambda k: dist[k][0] / max(dist[k][1], 1e-30))
    log(f"{what}: mixtral-8x22b width, 1 layer, {n_params / 1e9:.2f}B params, bf16, "
        f"{batch} x {seq} tokens: {mean_ms:.1f} ms a step ({', '.join(f'{x:.1f}' for x in ms)})"
        f" = {out['tokens_per_s']:.0f} tokens/s, adamw_update alone {adamw_ms:.1f} ms "
        f"({out['adamw_share']:.1%} of a step), peak {peak_gb:.2f} GB, losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; launches {out['launches']}; step 0 loss "
        f"kernels {losses0['kernels']:.5f} plain {losses0['plain']:.5f} fp32 "
        f"{losses0['fp32']:.5f}; gradients' distance from fp32 (kernels / plain): "
        + ", ".join(f"{k} {a:.4f}/{b:.4f}" for k, (a, b) in dist.items())
        + f" (worst ratio {worst}); elementwise vs plain at the bf16 limit (logged): "
        f"max {max(vs_plain.values()):.3g}; remat: 2x launches, {remat_ex:.3g} x the bf16 "
        f"limit, bitwise {remat_bitwise} [{card}]")
    return out


# phase 3h (d): training on the 1 x 1 NCCL mesh

def mesh_width_step0(torch, cfg, ctx, params, batch, gk, gp, g32, loss_k: float,
                     impl: str) -> dict:
    """Phase 3h (d) (ii), step 0: the gradients on the mesh (the EP or ESP
    collectives under autograd, on one rank copies), with the kernels,
    held to 3h (b)'s bf16 bound (each leaf's relative L2 distance from
    the fp32 gradients at most twice the plain path's plus 2^-5) and
    their distance from the no-mesh kernels' logged; launches once a
    kernel form."""
    from repro_torch.runtime.train import grads_of

    what = f"phase 3h (d) (ii) {impl}"
    one = train_launches(cfg, impl, torch.bfloat16, 1, mesh=True)
    zero_launches()
    gm, mm = grads_of(params, batch, cfg, ctx)
    torch.cuda.synchronize()
    if read_launches() != one:
        raise AssertionError(f"{what}: step 0 launches {read_launches()} != {one}")
    dist = {}
    for (name, a), k, p, r in zip(named_leaves(gm), leaves_of(gk), leaves_of(gp),
                                  leaves_of(g32)):
        dm, dp = grad_distance(torch, a, r), grad_distance(torch, p, r)
        dist[name] = {"mesh": dm, "plain": dp, "mesh_vs_no_mesh": grad_distance(
            torch, a, k.float())}
        if dm > 2 * dp + 2.0**-5:
            raise AssertionError(f"{what}: {name}'s gradient on the mesh is {dm:.4f} from "
                                 f"fp32 against the plain path's {dp:.4f}")
    return {"step0_loss": float(mm["loss"]), "step0_loss_no_mesh": loss_k,
            "distance": dist,
            "bitwise_no_mesh": all(torch.equal(a, b) for a, b in zip(leaves_of(gm),
                                                                     leaves_of(gk)))}


def mesh_width_steps(torch, cfg, ctx, opt, state, batches, steps: int, impl: str) -> dict:
    """Phase 3h (d) (ii): ``steps`` train steps on the mesh after a warm-up
    step (``batches``: ``steps + 1`` the no-mesh steps did not see), each
    timed with CUDA events, the losses finite, launches once a kernel form
    a step; the peak memory from the warm-up on."""
    from repro_torch.runtime.train import make_train_step

    what = f"phase 3h (d) (ii) {impl}"
    step = make_train_step(cfg, ctx, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, met = step(state, batches[0])
    torch.cuda.synchronize()
    zero_launches()
    ms, losses = [], [float(met["loss"])]
    for b in batches[1 : steps + 1]:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, met = step(state, b)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        losses.append(float(met["loss"]))
    launched = read_launches()
    want = train_launches(cfg, impl, torch.bfloat16, steps, mesh=True)
    if launched != want:
        raise AssertionError(f"{what}: launches {launched} != {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: losses {losses}")
    return {"ms_per_step": ms, "mean_ms": sum(ms) / len(ms), "losses": losses,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {k: v for k, v in launched.items() if v}}


def small_mesh_train_parity(torch, mesh, arch: str, impl: str, steps: int = 3) -> dict:
    """Phase 3h (d) (i): ``arch``'s smoke() model at head dim 32, fp32,
    ``steps`` train steps on the 1 x 1 NCCL mesh and without it, both with
    the kernels, from one state: every step's metrics and gradients and
    the state after, within the fp32 limit (``hold_trained``); the mesh
    run's launches as ``train_launches`` predicts on a mesh."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.optimizer import AdamWConfig
    from repro_torch.runtime.train import init_state

    cfg = dataclasses.replace(smoke(get_config(arch)), head_dim=32)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    batches = train_batches(torch, cfg, 2, 32, range(steps), seed=48)
    runs = {}
    for name, ctx in (("mesh", ParallelCtx(mesh=mesh, moe_impl=impl)),
                      ("no mesh", ParallelCtx(moe_impl=impl))):
        state = init_state(cfg, seed=49, device="cuda", ctx=ctx)
        runs[name] = run_train(torch, cfg, ctx, opt, batches, state, name == "mesh")
    (sm, mm, gm, launched), (sn, mn, gn, _) = runs["mesh"], runs["no mesh"]
    what = f"phase 3h (d) (i) {arch} {impl}"
    hold_metrics(mm, mn, what)
    out = hold_trained(torch, sm, sn, gm, gn, [m["lr"] for m in mn], what)
    want = train_launches(cfg, impl, torch.float32, steps, mesh=True)
    if launched != want:
        raise AssertionError(f"{what}: launches {launched} != {want}")
    return {"launches": {k: v for k, v in launched.items() if v},
            "losses": [m["loss"] for m in mm], **out}


def mesh_train_cli(torch, card: str, one_process: list, steps: int = 3) -> dict:
    """Phase 3h (d) (iii): ``launch.train.main --mesh 1x1`` (it joins this
    process's NCCL world of one) at llama3.2-1b, fp32, 16 layers, batch 8 x
    512, ``steps`` steps: ``flash_attention`` 16 launches a step and no
    other kernel, and each step's loss that of the one-process CLI's run
    of phase 3h (c) (``one_process``, the same init and batches) within
    1e-6 relative; whether they are bitwise is logged."""
    import contextlib
    import io

    from repro_torch.launch import train as cli

    args = ["--arch", "llama3.2-1b", "--batch", "8", "--seq", "512", "--log-every", "1",
            "--mesh", "1x1", "--steps", str(steps)]
    zero_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        state, hist = cli.main(args)
    launched = read_launches()
    del state
    gc.collect()
    torch.cuda.empty_cache()
    want = {k.__name__: 0 for k in all_kernels()}
    want["flash_attention"] = 16 * steps
    if launched != want:
        raise AssertionError(f"phase 3h (d) (iii): launches {launched} != {want}")
    losses = [r["loss"] for r in hist]
    for i, (a, b) in enumerate(zip(losses, one_process, strict=False)):
        if not abs(a - b) <= 1e-6 * abs(b):
            raise AssertionError(f"phase 3h (d) (iii): step {i}'s loss {a!r} on the mesh, "
                                 f"{b!r} in one process")
    secs = [r["seconds"] for r in hist]
    return {"losses": losses, "one_process_losses": one_process[:steps],
            "bitwise": losses == list(one_process[:steps]), "seconds": secs,
            "launches_flash_attention": launched["flash_attention"]}


def mesh_training_path(torch, mesh, card: str, cli_losses: list) -> dict:
    """Phase 3h (d) (i) and (iii); (ii) runs inside 3h (b)."""
    t0 = time.perf_counter()
    small = {}
    for arch, impl, steps in (("dbrx-132b", "ep", 3), ("mixtral-8x22b", "esp", 3),
                              *((a, "auto", 1) for a in FAMILY_MESH)):
        r = small_mesh_train_parity(torch, mesh, arch, impl, steps)
        small[f"{arch} {impl}"] = r
        log(f"phase 3h (d) (i) small fp32 {arch} ({impl}) on the 1 x 1 NCCL mesh: {steps} train "
            f"steps equal the no-mesh steps' within the fp32 limit (gradients "
            f"{r['excess_grads']:.3g}, params {r['excess_params']:.3g}, mu "
            f"{r['excess_mu']:.3g}, sqrt(nu) {r['excess_sqrt_nu']:.3g} x the limit; "
            f"{r['loose_elements']} of {r['elements']} elements near a parted gradient; "
            f"bitwise {r['bitwise']}), losses {', '.join(f'{x:.4f}' for x in r['losses'])}, "
            f"launches {r['launches']} as predicted")
    gc.collect()
    torch.cuda.empty_cache()
    cli_run = mesh_train_cli(torch, card, cli_losses)
    log(f"phase 3h (d) (iii) train CLI --mesh 1x1: llama3.2-1b, fp32, 16 layers, 8 x 512 "
        f"tokens, 3 steps: losses {', '.join(f'{x:.6f}' for x in cli_run['losses'])} against "
        f"the one-process CLI's {', '.join(f'{x:.6f}' for x in cli_run['one_process_losses'])}"
        f" (bitwise {cli_run['bitwise']}), step seconds "
        f"{', '.join(f'{x:.3f}' for x in cli_run['seconds'])}, flash_attention "
        f"{cli_run['launches_flash_attention']} launches [{card}]")
    return {"small": small, "cli": cli_run, "phase_s": time.perf_counter() - t0}


def leaves_of(tree):
    return (t for _, t in named_leaves(tree))


def named_leaves(tree, prefix=""):
    """(path, tensor) in the order of ``optimizer.leaves``."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def train_cli_path(torch, card: str, steps: int = 20, plain_steps: int = 3) -> dict:
    """``launch.train.main`` at full size: llama3.2-1b, fp32, all 16 layers,
    batch 8 x 512, ``steps`` steps logged every step, with the reference
    CLI's defaults (lr 3e-3, 20 warm-up steps): every loss finite,
    ``flash_attention`` 16 launches a step and no other kernel; ms a step
    (the CLI's own synchronised step timer), tokens/s, peak memory. Then
    ``--steps plain_steps --use-kernels off`` from the same init: its step
    0 loss equals the kernel run's within 1e-5 relative and its later ones
    within 1e-4. The losses are logged, not held to fall: at this size 20
    steps of this schedule do not lower the loss (PERF.md, phase 3h)."""
    import contextlib
    import io

    from repro_torch.launch import train as cli

    args = ["--arch", "llama3.2-1b", "--batch", "8", "--seq", "512", "--log-every", "1"]
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        state, hist = cli.main([*args, "--steps", str(steps)])
    wall_s = time.perf_counter() - t0
    launched = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del state
    gc.collect()
    torch.cuda.empty_cache()
    for line in buf.getvalue().splitlines():
        log(f"  train CLI: {line}")
    losses = [r["loss"] for r in hist]
    want = {k.__name__: 0 for k in all_kernels()}
    want["flash_attention"] = 16 * steps
    if launched != want:
        raise AssertionError(f"phase 3h (c): launches {launched} != {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 3h (c): losses {losses}")
    with contextlib.redirect_stdout(io.StringIO()):
        _, off = cli.main([*args, "--steps", str(plain_steps), "--use-kernels", "off"])
    gc.collect()
    torch.cuda.empty_cache()
    plain = [r["loss"] for r in off]
    for i, x in enumerate(plain):
        if abs(x - losses[i]) > (1e-5 if i == 0 else 1e-4) * abs(losses[i]):
            raise AssertionError(f"phase 3h (c): step {i}'s loss {losses[i]!r} with the "
                                 f"kernels, {x!r} on the plain path")
    secs = [r["seconds"] for r in hist]
    steady = secs[1:]
    mean_s = sum(steady) / len(steady)
    out = {"losses": losses, "grad_norms": [r["grad_norm"] for r in hist], "seconds": secs,
           "mean_ms": mean_s * 1e3, "tokens_per_s": 8 * 512 / mean_s, "peak_gb": peak_gb,
           "wall_s": wall_s, "launches_flash_attention": launched["flash_attention"],
           "plain_losses": plain}
    log(f"phase 3h (c) train CLI: llama3.2-1b, fp32, 16 layers, 8 x 512 tokens, {steps} "
        f"steps: first step {secs[0] * 1e3:.1f} ms, then {mean_s * 1e3:.1f} ms a step = "
        f"{out['tokens_per_s']:.0f} tokens/s, peak {peak_gb:.2f} GB, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (min {min(losses):.4f}), grad norm {hist[0]['grad_norm']:.3f} -> "
        f"{hist[-1]['grad_norm']:.3f}, flash_attention {launched['flash_attention']} "
        f"launches; --use-kernels off losses {', '.join(f'{x:.6f}' for x in plain)} against "
        f"{', '.join(f'{x:.6f}' for x in losses[:plain_steps])} [{card}]")
    return out


def training_path(torch, card: str, mesh) -> dict:
    """Phase 3h: (a) the small fp32 models and the train/restore check,
    (b) mixtral-8x22b width under ``ep`` and ``esp`` (and (d) (ii) on
    ``mesh``), (c) the train CLI, (d) training on the 1 x 1 NCCL mesh."""
    t0 = time.perf_counter()
    small = {}
    for arch, impl in TRAIN_SMALL:
        r = small_train_parity(torch, arch, impl)
        small[f"{arch} {impl}"] = r
        log(f"phase 3h (a) small fp32 {arch} ({impl}): 3 train steps with the kernels equal "
            f"the plain path's within the fp32 limit (gradients {r['excess_grads']:.3g}, "
            f"params {r['excess_params']:.3g}, mu {r['excess_mu']:.3g}, sqrt(nu) "
            f"{r['excess_sqrt_nu']:.3g} x the limit; {r['loose_elements']} of "
            f"{r['elements']} elements near a parted gradient, {r['loose_max_abs']:.3g} "
            f"apart, bound {r['loose_bound']:.3g}; bitwise {r['bitwise']}), losses "
            f"{', '.join(f'{x:.4f}' for x in r['losses'])}, launches {r['launches']} as "
            f"predicted")
    restore = small_train_restore(torch)
    log(f"phase 3h (a) small MoE model: 2 steps, save, restore into a fresh state, 2 steps "
        f"= 4 uninterrupted steps within the fp32 limit (params "
        f"{restore['excess_params']:.3g} x; {restore['loose_elements']} elements near a "
        f"parted gradient), bitwise {restore['bitwise']}")
    gc.collect()
    torch.cuda.empty_cache()
    full = {}
    for impl in ("ep", "esp"):
        full[impl] = full_width_train(torch, impl, card, mesh=mesh)
        r, m = full[impl], full[impl]["mesh"]
        worst = max(m["distance"], key=lambda k: m["distance"][k]["mesh"]
                    / max(m["distance"][k]["plain"], 1e-30))
        log(f"phase 3h (d) (ii) {impl} on the 1 x 1 NCCL mesh: mixtral-8x22b width, 1 layer, "
            f"bf16, 8 x 256 tokens: {m['mean_ms']:.1f} ms a step "
            f"({', '.join(f'{x:.1f}' for x in m['ms_per_step'])}) beside {r['mean_ms']:.1f} "
            f"without the mesh in this run, peak {m['peak_gb']:.2f} GB (from its warm-up "
            f"step), losses {', '.join(f'{x:.4f}' for x in m['losses'])}; launches "
            f"{m['launches']}; step 0 loss {m['step0_loss']:.5f} (no mesh "
            f"{m['step0_loss_no_mesh']:.5f}), gradients' distance from fp32 (mesh / plain): "
            + ", ".join(f"{k} {v['mesh']:.4f}/{v['plain']:.4f}" for k, v in m["distance"].items())
            + f" (worst ratio {worst}), from the no-mesh kernels' at most "
            f"{max(v['mesh_vs_no_mesh'] for v in m['distance'].values()):.3g}, bitwise "
            f"{m['bitwise_no_mesh']} [{card}]")
        gc.collect()
        torch.cuda.empty_cache()
    cli_run = train_cli_path(torch, card)
    on_mesh = mesh_training_path(torch, mesh, card, cli_run["losses"])
    return {"small": small, "restore": restore, "full_width": full, "cli": cli_run,
            "mesh": on_mesh, "phase_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------

FAST_FIGURES = ("fig06_comm_imbalance", "fig13a_token_count", "fig13b_models",
                "fig13c_scale_parallelism", "fig13d_her", "fig14a_esp", "fig14b_allgather")


def analytic_figures() -> dict:
    """Phase 1's analytic model: the fast paper figures' rows (fig15-17,
    about 40 s of host time over load traces, are held by the CPU tests).
    Every figure must return rows, each with a finite, positive
    ``us_per_call``; nothing is caught."""
    import importlib

    t0 = time.perf_counter()
    figures = {}
    for name in FAST_FIGURES:
        rows = importlib.import_module(f"repro_torch.figures.{name}").run()
        if not rows:
            raise AssertionError(f"analytic figure {name} returned no rows")
        for r in rows:
            us = r["us_per_call"]
            if not (isinstance(us, float) and math.isfinite(us) and us > 0):
                raise AssertionError(f"analytic figure {name}: {r}")
        figures[name] = rows
    return {"seconds": time.perf_counter() - t0, "figures": figures}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 compared as fp32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build
    from repro_torch.kernels.tolerance import PLAIN, ROUNDING

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    report = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f}s for {len(report)} libraries "
        f"({', '.join(f'{k} {v['seconds']:.1f}s' for k, v in report.items())})")
    for name, r in report.items():
        entry = ""
        for line in r["ptxas"].splitlines():
            if "Compiling entry function" in line:
                # drop the mangled anonymous namespace (its length comes
                # first), so that the template arguments (e.g. IfLb0E:
                # float, PARTIALS = false) stay inside the cut
                entry = line.split("'")[1] if "'" in line else ""
                ns = re.match(r"_ZN(\d+)_GLOBAL__N_", entry)
                if ns:
                    entry = entry[ns.end(1) + int(ns.group(1)):]
                entry = entry[:72]
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name} {entry}: {line.split(':', 1)[-1].strip()}")
                # the wgmma and decode bodies hold their accumulators in
                # registers: a spill would put them in local memory
                held_in_regs = any(k in entry for k in (
                    "wgmma", "gmm_decode_kernel", "fused_decode_kernel", "fused_cluster_kernel"))
                if held_in_regs and "spill" in line and not re.search(
                        r"\b0 bytes spill stores, 0 bytes spill loads", line):
                    raise AssertionError(f"ptxas: {entry} spills: {line.strip()}")
    # ptxas counts static shared memory only; the wgmma bodies take theirs
    # at launch, and each library reports how much
    gmm_smem = build.load("gmm_ragged").gmm_wgmma_smem_bytes
    fa_smem = build.load("flash_attention").flash_attention_wgmma_smem_bytes
    gmm_smem.restype = fa_smem.restype = ctypes.c_longlong
    fa_smem.argtypes = [ctypes.c_int]
    log(f"  dynamic shared memory per block at launch: gmm_wgmma_kernel {gmm_smem()} B; "
        "flash_attention_wgmma_kernel "
        + ", ".join(f"{fa_smem(hd)} B (hd {hd})" for hd in (32, 64, 128)))
    # the fused bodies' plan counts the shared memory they take
    from repro_torch.kernels.gmm.ragged import fused_decode_slice, fused_smem_bytes

    fused = build.load("gmm_fused_ffn")
    fused.gmm_fused_ffn_smem_bytes.restype = ctypes.c_longlong
    fused.gmm_fused_ffn_smem_bytes.argtypes = [ctypes.c_int]
    for code, body in enumerate(("decode", "cluster")):
        if fused.gmm_fused_ffn_smem_bytes(code) != fused_smem_bytes(body):
            raise AssertionError(f"gmm_fused_ffn: the plan counts {fused_smem_bytes(body)} B of "
                                 f"shared memory for the {body} body, the kernel takes "
                                 f"{fused.gmm_fused_ffn_smem_bytes(code)} B")
    log(f"  gmm_fused_ffn bf16 bodies: decode {fused_smem_bytes('decode')} B a block, cluster "
        f"{fused_smem_bytes('cluster')} B a CTA of dynamic shared memory, as the plan counts; "
        f"{fused.gmm_fused_ffn_max_clusters()} clusters of 16 CTAs fit the card at once")
    log("  split-KV decode kernels (registers, spill bytes stored/loaded): "
        + "; ".join(split_kernel_ptxas(report)))
    # the decode gates count the split block's shared memory as the kernel does
    from repro_torch.kernels.flash_decode.paged import smem_bytes as decode_smem

    for name in ("flash_decode", "flash_decode_paged"):
        fn = getattr(build.load(name), f"{name}_smem_bytes")
        fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 3
        for g, hd in ((6, 128), (16, 256), (1, 32)):
            for dt, code in ((torch.bfloat16, 1), (torch.float32, 0)):
                if fn(g, hd, code) != decode_smem(g, hd, dt):
                    raise AssertionError(f"{name}: the gate counts {decode_smem(g, hd, dt)} B "
                                         f"of shared memory at G {g} hd {hd} {dt}, the "
                                         f"kernel takes {fn(g, hd, code)} B")
    log(f"  split-KV decode block at the served shape (G 6, hd 128): "
        f"{decode_smem(6, 128, torch.bfloat16)} B (bf16), "
        f"{decode_smem(6, 128, torch.float32)} B (fp32) of dynamic shared memory, "
        "as the gates count it")

    analytic = analytic_figures()
    log(f"analytic model: {sum(len(r) for r in analytic['figures'].values())} rows of "
        f"{len(analytic['figures'])} figures (fig06-fig14b) in {analytic['seconds']:.3f} s, "
        f"every us_per_call finite and positive")
    migs = small_parity(torch)
    log(f"small fp32 model on the card: kernel and plain greedy tokens agree "
        f"(migrations {migs})")
    small_esp = small_esp_parity(torch)
    log(f"small fp32 ESP model, dense cache, ring wrapped: kernel and plain greedy "
        f"tokens agree (kernel run launches {small_esp})")
    # a world of one on NCCL: no fallback to gloo if it does not initialise
    from repro_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(torch.device("cuda", 0), world_size=1, rank=0)
    mesh = make_mesh(1, 1)
    small_mesh = small_mesh_parity(torch, mesh)
    log(f"small fp32 model on the 1 x 1 NCCL mesh: greedy tokens with the kernels equal "
        f"the plain path's and the no-mesh EP Server's (partials launches "
        f"{small_mesh['flash_decode_partials']}, migrations {small_mesh['migrations']})")
    small_mesh["snapshot"] = snap = small_mesh_snapshot(torch, mesh)
    log(f"small fp32 model on the 1 x 1 NCCL mesh through the scheduler: crashed at tick "
        f"{snap['crash_tick']}, restored on the mesh from the snapshot file, every one of "
        f"{snap['requests']} streams equal to the no-mesh EP run's")
    small_families = {}
    for arch in FAMILIES:
        small_families[arch] = small_family_parity(torch, arch)
        log(f"small fp32 {arch} model (smoke, head dim 32): kernel and plain greedy tokens "
            f"agree, kernel run launches {small_families[arch]} as predicted")
    torch.cuda.empty_cache()

    launches, groups, run = main_path(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    esp_launches, rows, esp_run = esp_path(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_launches, mesh_rows, mesh_run = mesh_path(torch, mesh, card)
    gc.collect()
    torch.cuda.empty_cache()
    small_chaos = small_chaos_parity(torch)
    log(f"small fp32 model under the chaos plan (seed {CHAOS_SEED}): with the kernels and on "
        f"the plain path every stream equals the fault-free run's, recomputed ones included "
        f"(preempted {small_chaos['preempted']}, {small_chaos['ticks']} ticks, evacuation "
        f"plan {small_chaos['evacuation_plan']}, revival plan {small_chaos['revival_plan']}, "
        f"first re-commit {small_chaos['revival_to_first_commit_ticks']} ticks after the "
        f"revival; kernel run launches {small_chaos['launches']} as predicted)")
    sched_run, splice = scheduler_path(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    small_chunk = small_chunk_parity(torch)
    log(f"small fp32 model, chunked admission: with the kernels and on the plain path every "
        f"stream equals splice admission's; a crash at tick {small_chunk['crash_tick']} with "
        f"request {small_chunk['mid_prefill']} mid-prefill, restored from the file, serves "
        f"every stream of the uninterrupted run; kernel run launches "
        f"{small_chunk['launches']} as predicted (flash_attention 0)")
    chunk_run = chunk_path(torch, card, splice, sched_run["peak_gb"]["setup"])
    del splice
    gc.collect()
    torch.cuda.empty_cache()
    small_served = small_mesh_serving_parity(torch, mesh)
    log(f"phase 3f small fp32 models on the 1 x 1 NCCL mesh: the paged EP Server with chunked "
        f"admission under the chaos plan (seed {CHAOS_SEED}) gives every stream and event of "
        f"the no-mesh run with the kernels and on the plain path ("
        f"{small_served['chunk_chaos']['ticks']} ticks, "
        f"{small_served['chunk_chaos']['chunk_ticks']} with a chunk, preempted "
        f"{small_served['chunk_chaos']['n_preempted']}; kernel run launches "
        f"{small_served['chunk_chaos']['launches']} as predicted); ESP greedy tokens equal the "
        f"no-mesh ESP Server's (kernel run launches {small_served['esp']['launches']})")
    gc.collect()
    torch.cuda.empty_cache()
    mesh_chunk_run = mesh_chunk_path(torch, mesh, card, chunk_run["eos"])
    esp_mesh_launches, esp_mesh_groups, esp_mesh_run = mesh_esp_path(torch, mesh, card, esp_run)
    gc.collect()
    torch.cuda.empty_cache()
    family_runs, family_tokens = {}, {}
    for arch in FAMILY_RUNS:
        family_runs[arch], family_tokens[arch] = family_path(torch, arch, card)
        gc.collect()
        torch.cuda.empty_cache()
    t_mesh = time.perf_counter()
    small_family_mesh, family_mesh_runs = {}, {}
    for arch in FAMILY_MESH:
        small_family_mesh[arch] = r = small_family_mesh_parity(torch, mesh, arch)
        log(f"phase 3g (m) small fp32 {arch} model (smoke, head dim 32) on the 1 x 1 NCCL "
            f"mesh: greedy tokens equal the no-mesh run's, logits within the fp32 limit "
            f"({r['excess']:.3g} x), launches {r['launches']} as predicted")
        family_mesh_runs[arch] = family_mesh_path(torch, arch, mesh, card, family_tokens[arch])
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 3g (m): {time.perf_counter() - t_mesh:.1f} s")
    del family_tokens
    training = training_path(torch, card, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    bench = kernel_bench_path(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    op_launches, op_excess = op_layer_path(torch, groups, mesh_rows, card)

    timer = Timer(torch)
    cells = {}
    for dtype in ("bfloat16", "float32"):
        time_it = dtype == "bfloat16"
        g = gmm_cells(torch, groups, dtype, timer, time_it)
        ge = gmm_cells(torch, esp_mesh_groups, dtype, timer, time_it, G=8, D=6144, F=16384)
        d = decode_cell(torch, dtype, timer, time_it)
        a = attention_cell(torch, dtype, timer, time_it)
        eg = pair_cells(torch, rows, 6144, 16384, dtype, timer, time_it)
        mg = pair_cells(torch, mesh_rows, 6144, 10752, dtype, timer, time_it, gather=True)
        fu = fused_cells(torch, rows, dtype, timer, time_it)
        dd = dense_decode_cell(torch, dtype, timer, time_it)
        pa = partials_cell(torch, dtype, timer, time_it)
        pg = padded_cells(torch, groups, dtype, timer, time_it)
        pp = paged_partials_cell(torch, dtype, timer, time_it)
        # phase 3g's new attention shapes: seamless's encoder (non-causal),
        # zamba2's shared block (MHA at hd 64) at prefill and at decode
        fam = {
            "flash_attention seamless encoder": attention_cell(
                torch, dtype, timer, time_it, B=8, S=1024, H=16, KV=16, hd=64,
                causal=False, seed=21),
            "flash_attention zamba2 shared block": attention_cell(
                torch, dtype, timer, time_it, B=8, S=256, H=32, KV=32, hd=64, seed=22),
            "flash_decode zamba2 shared block": dense_decode_cell(
                torch, dtype, timer, time_it, H=32, KV=32, hd=64),
        }
        cells[dtype] = {"gmm": g, "esp_mesh_gmm": ge, "decode": d, "attn": a, "esp_gmm": eg,
                        "mesh_gmm": mg,
                        "fused": fu, "dense_decode": dd, "partials": pa, "padded": pg,
                        "paged_partials": pp, "family": fam}
        log(f"kernels {dtype} at phase 3g's shapes, error over its limit: "
            + "; ".join(f"{name} [{c.get('shape', '')}] {c['excess']:.3g}"
                        for name, c in fam.items()))
        log(f"kernels {dtype}, error over its limit (rtol, atol) = "
            f"{PLAIN[getattr(torch, dtype)]}: gmm_dual_act_ragged decode "
            f"{g['decode']['gmm_dual_act_ragged']['excess']:.3g} prefill "
            f"{g['prefill']['gmm_dual_act_ragged']['excess']:.3g}; gmm_ragged decode "
            f"{g['decode']['gmm_ragged']['excess']:.3g} prefill "
            f"{g['prefill']['gmm_ragged']['excess']:.3g}; the ragged pair at ESP under the "
            f"mesh (8 experts, F 16384) decode "
            f"{ge['decode']['gmm_dual_act_ragged']['excess']:.3g} / "
            f"{ge['decode']['gmm_ragged']['excess']:.3g} prefill "
            f"{ge['prefill']['gmm_dual_act_ragged']['excess']:.3g} / "
            f"{ge['prefill']['gmm_ragged']['excess']:.3g}; flash_decode_paged "
            f"{d['excess']:.3g}; flash_attention {a['excess']:.3g}; "
            + "; ".join(f"{n} {path} decode {c['decode'][n]['excess']:.3g} prefill "
                        f"{c['prefill'][n]['excess']:.3g}"
                        for path, c in (("ESP", eg), ("mesh", mg))
                        for n in ("gmm_dual_act_gather", "gmm_scatter"))
            + f"; gmm_fused_ffn decode {fu['decode']['excess']:.3g} prefill "
            f"{fu['prefill']['excess']:.3g} (vs the pair {fu['decode']['excess_vs_pair']:.3g}"
            f" / {fu['prefill']['excess_vs_pair']:.3g}); flash_decode {dd['excess']:.3g}; "
            f"flash_decode partials acc {pa['excess']:.3g}, m {pa['excess_m']:.3g}, l "
            f"{pa['excess_l']:.3g} (m, l at {PLAIN[torch.float32]}), 4 slices merged vs the "
            f"normalised kernel {pa['excess_merge_vs_normalised']:.3g}, an empty request "
            f"(acc, m, l) = (0, -1e30, 0); "
            + "; ".join(f"{n} decode {pg['decode'][n]['excess']:.3g} prefill "
                        f"{pg['prefill'][n]['excess']:.3g}" for n in ("gmm_dual_act", "gmm"))
            + f"; gmm_gather mesh decode {mg['decode']['gmm_gather']['excess']:.3g} prefill "
            f"{mg['prefill']['gmm_gather']['excess']:.3g}; flash_decode_paged partials acc "
            f"{pp['excess']:.3g}, m {pp['excess_m']:.3g}, l {pp['excess_l']:.3g}, 4 slices "
            f"merged vs the normalised kernel {pp['excess_merge_vs_normalised']:.3g}, a "
            f"request of length 0 (acc, m, l) = (0, -1e30, 0)")
        torch.cuda.empty_cache()

    bf = cells["bfloat16"]
    for name in ("gmm_dual_act_ragged", "gmm_ragged"):
        for phase in ("decode", "prefill"):
            c = bf["gmm"][phase][name]
            log(f"{name} {phase} bf16 vs the fp32 product at {ROUNDING}: "
                f"{c['excess_fp32_product']:.3f}; faults caught: "
                + ", ".join(f"{k} {v:.2f}" for k, v in c["faults"].items()))
    for name, c in (("flash_decode_paged", bf["decode"]), ("flash_attention", bf["attn"])):
        log(f"{name} bf16 faults caught: "
            + ", ".join(f"{k} {v:.2f}" for k, v in c["faults"].items()))
    for name in ("gmm_dual_act_ragged", "gmm_ragged"):
        for phase in ("decode", "prefill"):
            c = bf["esp_mesh_gmm"][phase][name]
            log(f"{name} ESP under the mesh {phase} bf16 vs the fp32 product at {ROUNDING}: "
                f"{c['excess_fp32_product']:.3f}; faults caught: "
                + ", ".join(f"{k} {v:.2f}" for k, v in c["faults"].items()))
    for key, path in (("gmm", ""), ("esp_mesh_gmm", " ESP under the mesh")):
        for name in ("gmm_dual_act_ragged", "gmm_ragged"):
            for phase in ("decode", "prefill"):
                c = bf[key][phase][name]
                log(f"time {name}{path} {phase} [{c['shape']}]: kernel {c['ms']:.3f} ms, plain "
                    f"{c['plain_ms']:.3f} ms, torch.bmm {c['library_ms']:.3f} ms, bound "
                    f"{c['bound_ms']:.3f} ms ({c['bound_by']}) [{card}]")
    for path, key in (("ESP", "esp_gmm"), ("mesh", "mesh_gmm")):
        for name in ("gmm_dual_act_gather", "gmm_scatter"):
            for phase in ("decode", "prefill"):
                c = bf[key][phase][name]
                log(f"{name} {path} {phase} bf16 vs the fp32 product at {ROUNDING}: "
                    f"{c['excess_fp32_product']:.3f}; faults caught: "
                    + ", ".join(f"{k} {v:.2f}" for k, v in c["faults"].items()))
    for phase in ("decode", "prefill"):
        c = bf["fused"][phase]
        log(f"gmm_fused_ffn {phase} bf16 ({c['body']} body) vs the fp32 products at "
            f"{ROUNDING}: {c['excess_fp32_product']:.3f} (the kernel pair "
            f"{c['pair_excess_fp32_product']:.3f}; logged, not held), against float64 with the "
            "hidden values rounded to bf16: "
            + ", ".join(f"{k} {v:.3f}" for k, v in c["excess_float64"].items())
            + "; two calls bitwise equal; faults caught: "
            + ", ".join(f"{k} {v:.2f}" for k, v in c["faults"].items()))
    log("flash_decode bf16 faults caught: "
        + ", ".join(f"{k} {v:.2f}" for k, v in bf["dense_decode"]["faults"].items()))
    log("flash_decode partials bf16 faults caught: "
        + ", ".join(f"{k} {v:.2f}" for k, v in bf["partials"]["faults"].items()))
    for name in ("gmm_dual_act", "gmm"):
        for phase in ("decode", "prefill"):
            c = bf["padded"][phase][name]
            log(f"{name} {phase} bf16 vs the fp32 product at {ROUNDING}: "
                f"{c['excess_fp32_product']:.3f}; faults caught: "
                + ", ".join(f"{k} {v:.2f}" for k, v in c["faults"].items()))
            log(f"time {name} {phase} [{c['shape']}]: kernel {c['ms']:.3f} ms, plain "
                f"{c['plain_ms']:.3f} ms, torch.bmm {c['library_ms']:.3f} ms, bound "
                f"{c['bound_ms']:.3f} ms ({c['bound_by']}) [{card}]")
    for phase in ("decode", "prefill"):
        c = bf["mesh_gmm"][phase]["gmm_gather"]
        log(f"gmm_gather mesh {phase} bf16 vs the fp32 product at {ROUNDING}: "
            f"{c['excess_fp32_product']:.3f}; faults caught: "
            + ", ".join(f"{k} {v:.2f}" for k, v in c["faults"].items()))
    c = bf["paged_partials"]
    log("flash_decode_paged partials bf16 faults caught: "
        + ", ".join(f"{k} {v:.2f}" for k, v in c["faults"].items()))
    log(f"time flash_decode_paged partials [{c['shape']}]: kernel {c['ms']:.4f} ms, plain "
        f"{c['plain_ms']:.4f} ms, normalised kernel {c['normalised_ms']:.4f} ms, sdpa "
        f"(normalised) {c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
        f"({c['bound_by']}) [{card}]")
    for name, c in bf["family"].items():
        log(f"{name} bf16 faults caught: "
            + ", ".join(f"{k} {v:.2f}" for k, v in c["faults"].items()))
    for name, c, lib in (("flash_decode_paged", bf["decode"], "sdpa"),
                         ("flash_attention", bf["attn"], "sdpa"),
                         ("flash_decode", bf["dense_decode"], "sdpa"),
                         *((name, c, "sdpa") for name, c in bf["family"].items())):
        log(f"time {name} [{c['shape']}]: kernel {c['ms']:.4f} ms, plain "
            f"{c['plain_ms']:.4f} ms, {lib} {c['library_ms']:.4f} ms, bound "
            f"{c['bound_ms']:.4f} ms ({c['bound_by']}) [{card}]")
    c = bf["partials"]
    log(f"time flash_decode partials [{c['shape']}]: kernel {c['ms']:.4f} ms, plain "
        f"{c['plain_ms']:.4f} ms, normalised kernel {c['normalised_ms']:.4f} ms, sdpa "
        f"(normalised) {c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
        f"({c['bound_by']}) [{card}]")
    for what, c in (("flash_decode_paged", bf["decode"]),
                    ("flash_decode_paged partials", bf["paged_partials"]),
                    ("flash_decode", bf["dense_decode"]),
                    ("flash_decode partials", bf["partials"])):
        log(f"split-KV {what}: {c['live_bytes'] / c['ms'] / 1e6:.1f} GB/s of live K/V, q and "
            f"outputs over the timed call ({c['ms']:.4f} ms), "
            f"{c['live_bytes'] / c['device_ms'] / 1e6:.1f} GB/s over its device time "
            f"({c['device_ms']:.4f} ms; sdpa's device time {c['library_device_ms']:.4f} ms; "
            f"bound {c['bound_ms']:.4f} ms at 3350 GB/s) [{card}]")
    for path, key, names in (("ESP", "esp_gmm", ("gmm_dual_act_gather", "gmm_scatter")),
                             ("mesh", "mesh_gmm",
                              ("gmm_dual_act_gather", "gmm_scatter", "gmm_gather"))):
        for name in names:
            for phase in ("decode", "prefill"):
                c = bf[key][phase][name]
                log(f"time {name} {path} {phase} [{c['shape']}]: kernel {c['ms']:.3f} ms, "
                    f"plain {c['plain_ms']:.3f} ms, torch.bmm {c['library_ms']:.3f} ms, "
                    f"bound {c['bound_ms']:.3f} ms ({c['bound_by']}) [{card}]")
    for phase in ("decode", "prefill"):
        c = bf["fused"][phase]
        log(f"time gmm_fused_ffn {phase} [{c['shape']}]: kernel {c['ms']:.3f} ms, plain "
            f"{c['plain_ms']:.3f} ms, kernel pair {c['pair_ms']:.3f} ms, no library call, "
            f"bound {c['bound_ms']:.3f} ms ({c['bound_by']}) [{card}]")
        what = f"gmm_fused_ffn {phase}"
        if "slice_ms" in c:
            log(f"gmm_fused_ffn decode body by hidden slice width (the plan takes "
                f"{fused_decode_slice(8, 16384)}): "
                + ", ".join(f"{fs} columns ({-(-16384 // fs)} slices) {ms:.4f} ms"
                            for fs, ms in c["slice_ms"].items()) + f" [{card}]")
        log(f"redesigned {what} ({c['body']} body): {c['ms']:.4f} ms in this run, "
            f"{c['bound_ms'] / c['ms']:.1%} of its {c['bound_by']} bound ({c['bound_ms']:.4f} "
            f"ms); the gather + scatter pair {c['pair_ms']:.4f} ms in this run (the fused "
            f"kernel at {c['ms'] / c['pair_ms']:.3f}x it); replaced body as recorded in PERF.md "
            "(not measured here): " + " / ".join(f"{t:.3f}" for t in REPLACED_MS[what])
            + f" ms ({min(REPLACED_MS[what]) / c['ms']:.1f}x its fastest) [{card}]")

    now = {"flash_attention": bf["attn"]["ms"],
           **{f"{n} prefill": bf["gmm"]["prefill"][n]["ms"]
              for n in ("gmm_dual_act_ragged", "gmm_ragged")},
           **{f"{n} {path} prefill": bf[key]["prefill"][n]["ms"]
              for path, key, names in (
                  ("ESP", "esp_gmm", ("gmm_dual_act_gather", "gmm_scatter")),
                  ("mesh", "mesh_gmm", ("gmm_dual_act_gather", "gmm_scatter", "gmm_gather")))
              for n in names},
           **{f"{n} prefill": bf["padded"]["prefill"][n]["ms"] for n in ("gmm_dual_act", "gmm")},
           "flash_decode_paged": bf["decode"]["ms"],
           "flash_decode_paged partials": bf["paged_partials"]["ms"],
           "flash_decode": bf["dense_decode"]["ms"],
           "flash_decode partials": bf["partials"]["ms"]}
    # the decode GMM forms (one body, csrc/gmm_ragged.cu gmm_decode_kernel)
    decode_gmm = {
        **{f"{n} decode": bf["gmm"]["decode"][n] for n in ("gmm_dual_act_ragged", "gmm_ragged")},
        **{f"{n} {path} decode": bf[key]["decode"][n]
           for path, key, names in (
               ("ESP", "esp_gmm", ("gmm_dual_act_gather", "gmm_scatter")),
               ("mesh", "mesh_gmm", ("gmm_dual_act_gather", "gmm_scatter", "gmm_gather")))
           for n in names},
        **{f"{n} decode": bf["padded"]["decode"][n] for n in ("gmm_dual_act", "gmm")},
    }
    for what, c in decode_gmm.items():
        log(f"decode GMM {what} [{c['shape']}]: {c['bytes'] / c['ms'] / 1e6:.1f} GB/s over the "
            f"bytes it must move ({c['ms']:.4f} ms), {c['bound_ms'] / c['ms']:.1%} of its bytes "
            f"bound ({c['bound_ms']:.4f} ms at 3350 GB/s); torch.bmm {c['library_ms']:.4f} ms, "
            f"the kernel at {c['ms'] / c['library_ms']:.3f}x it [{card}]")
    now.update({what: c["ms"] for what, c in decode_gmm.items()})
    for what, ms in now.items():
        log(f"redesigned {what}: {ms:.4f} ms in this run [{card}]; replaced body as "
            "recorded in PERF.md (not measured here): "
            + " / ".join(f"{t:.4f}" for t in REPLACED_MS[what])
            + f" ms ({min(REPLACED_MS[what]) / ms:.2f}x its fastest)")

    tpu = {
        "gmm_dual_act_ragged": "src/repro/kernels/gmm/ragged.py:223",
        "gmm_ragged": "src/repro/kernels/gmm/ragged.py:151",
        "flash_decode_paged": "src/repro/kernels/flash_decode/paged.py:140",
        "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:116",
        "gmm_dual_act_gather": "src/repro/kernels/gmm/ragged.py:469",
        "gmm_scatter": "src/repro/kernels/gmm/ragged.py:605",
        "gmm_fused_ffn": "src/repro/kernels/gmm/ragged.py:790",
        "flash_decode": "src/repro/kernels/flash_decode/flash_decode.py:151",
        "flash_decode_partials": "src/repro/kernels/flash_decode/flash_decode.py:151",
        "gmm_gather": "src/repro/kernels/gmm/ragged.py:371",
        "gmm": "src/repro/kernels/gmm/gmm.py:71",
        "gmm_dual_act": "src/repro/kernels/gmm/gmm.py:123",
        "flash_decode_paged_partials": "src/repro/kernels/flash_decode/paged.py:140",
    }
    source = {
        "gmm_dual_act_ragged": "src/repro_torch/csrc/gmm_ragged.cu",
        "gmm_ragged": "src/repro_torch/csrc/gmm_ragged.cu",
        "flash_decode_paged": "src/repro_torch/csrc/flash_decode_paged.cu",
        "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
        "gmm_dual_act_gather": "src/repro_torch/csrc/gmm_ragged.cu",
        "gmm_scatter": "src/repro_torch/csrc/gmm_ragged.cu",
        "gmm_fused_ffn": "src/repro_torch/csrc/gmm_fused_ffn.cu",
        "flash_decode": "src/repro_torch/csrc/flash_decode.cu",
        "flash_decode_partials": "src/repro_torch/csrc/flash_decode.cu",
        "gmm_gather": "src/repro_torch/csrc/gmm_ragged.cu",
        "gmm": "src/repro_torch/csrc/gmm_ragged.cu",
        "gmm_dual_act": "src/repro_torch/csrc/gmm_ragged.cu",
        "flash_decode_paged_partials": "src/repro_torch/csrc/flash_decode_paged.cu",
    }
    fp = cells["float32"]
    # launches on the main path that runs each kernel (the ESP path runs
    # gmm_fused_ffn no time at d_model 6144; the small ESP model does)
    # (the op layer's four: its own path's launches; every served path's is 0)
    op_names = [k.__name__ for k in op_layer_kernels()]
    path_launches = {**launches, **{k: esp_launches[k] for k in (
        "gmm_dual_act_gather", "gmm_scatter", "gmm_fused_ffn", "flash_decode")},
        "flash_decode_partials": mesh_launches["flash_decode_partials"],
        **{k: op_launches[k] for k in op_names}}
    entries = []
    for name in ("gmm_dual_act_ragged", "gmm_ragged", "flash_decode_paged",
                 "flash_attention", "gmm_dual_act_gather", "gmm_scatter",
                 "gmm_fused_ffn", "flash_decode", "flash_decode_partials", *op_names):
        if name in ("flash_decode_partials", "flash_decode_paged_partials"):
            key = "partials" if name == "flash_decode_partials" else "paged_partials"
            c, c32 = bf[key], fp[key]
            err, ex, err32, ex32 = (c["max_abs_err"], c["excess"], c32["max_abs_err"],
                                    c32["excess"])
            extra = {k: c[k] for k in (
                "faults", "excess_m", "excess_l", "excess_merge_vs_normalised",
                "normalised_ms", "library_note")}
            extra.update(excess_m_fp32=c32["excess_m"], excess_l_fp32=c32["excess_l"],
                         tolerance_m_l=f"m and l at the fp32 limit {PLAIN[torch.float32]}")
            if name == "flash_decode_partials":
                extra["launches_small_mesh_model"] = small_mesh["flash_decode_partials"]
        elif name in ("gmm_fused_ffn", "flash_decode"):
            key = "fused" if name == "gmm_fused_ffn" else "dense_decode"
            if name == "gmm_fused_ffn":
                # timed at the prefill layout too, listed beside
                c, pre, c32, pre32 = (bf[key]["decode"], bf[key]["prefill"],
                                      fp[key]["decode"], fp[key]["prefill"])
                err, ex = max(c["max_abs_err"], pre["max_abs_err"]), max(c["excess"], pre["excess"])
                err32 = max(c32["max_abs_err"], pre32["max_abs_err"])
                ex32 = max(c32["excess"], pre32["excess"])
                extra = {"faults": {**c["faults"], **pre["faults"]},
                         "excess_vs_pair": max(c["excess_vs_pair"], pre["excess_vs_pair"]),
                         "excess_fp32_product": max(c["excess_fp32_product"],
                                                    pre["excess_fp32_product"]),
                         "pair_excess_fp32_product": max(c["pair_excess_fp32_product"],
                                                         pre["pair_excess_fp32_product"]),
                         "bodies": {"decode": c["body"], "prefill": pre["body"]},
                         "pair_ms": c["pair_ms"], "prefill_ms": pre["ms"],
                         "prefill_plain_ms": pre["plain_ms"], "prefill_pair_ms": pre["pair_ms"],
                         "prefill_bound_ms": pre["bound_ms"], "prefill_bound_by": pre["bound_by"],
                         "prefill_shape": pre["shape"],
                         "launches_small_esp_model": small_esp["gmm_fused_ffn"]}
            else:
                c, c32 = bf[key], fp[key]
                err, ex, err32, ex32 = (c["max_abs_err"], c["excess"], c32["max_abs_err"],
                                        c32["excess"])
                extra = {"faults": c["faults"]}
        elif name.startswith("gmm"):
            # timed at the decode cell: the kernel's call on every decode tick;
            # the gather/scatter pair is held at the ESP and the mesh layouts,
            # gmm_gather at the mesh layouts
            keys = {"gmm_dual_act_ragged": ("gmm",), "gmm_ragged": ("gmm",),
                    "gmm_dual_act": ("padded",), "gmm": ("padded",),
                    "gmm_gather": ("mesh_gmm",)}.get(name, ("esp_gmm", "mesh_gmm"))
            key = keys[0]
            c, pre = bf[key]["decode"][name], bf[key]["prefill"][name]
            heldb = [bf[kk][ph][name] for kk in keys for ph in ("decode", "prefill")]
            held32 = [fp[kk][ph][name] for kk in keys for ph in ("decode", "prefill")]
            err, ex, err32, ex32 = (max(x[k] for x in cs) for cs, k in (
                (heldb, "max_abs_err"), (heldb, "excess"),
                (held32, "max_abs_err"), (held32, "excess")))
            extra = {"excess_fp32_product": max(x["excess_fp32_product"] for x in heldb),
                     "faults": {f"{kk} {f}": v for kk in keys for ph in ("decode", "prefill")
                                for f, v in bf[kk][ph][name]["faults"].items()},
                     "prefill_ms": pre["ms"], "prefill_plain_ms": pre["plain_ms"],
                     "prefill_library_ms": pre["library_ms"],
                     "prefill_bound_ms": pre["bound_ms"],
                     "prefill_bound_by": pre["bound_by"], "prefill_shape": pre["shape"]}
            timed = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "shape")
            if name in ("gmm_dual_act_ragged", "gmm_ragged"):
                # ESP under the mesh: the same kernels at mixtral's buckets
                ed, ep_ = bf["esp_mesh_gmm"]["decode"][name], bf["esp_mesh_gmm"]["prefill"][name]
                extra["esp_mesh_path"] = {
                    "launches": esp_mesh_launches[name],
                    **{k: ed[k] for k in timed}, **{f"prefill_{k}": ep_[k] for k in timed},
                    "excess": max(ed["excess"], ep_["excess"]),
                    "excess_fp32": max(fp["esp_mesh_gmm"][ph][name]["excess"]
                                       for ph in ("decode", "prefill")),
                    "max_abs_err": max(ed["max_abs_err"], ep_["max_abs_err"]),
                    "excess_fp32_product": max(ed["excess_fp32_product"],
                                               ep_["excess_fp32_product"]),
                    "faults": {f"{ph} {f}": v for ph in ("decode", "prefill")
                               for f, v in bf["esp_mesh_gmm"][ph][name]["faults"].items()}}
            if len(keys) > 1:
                md, mp = bf["mesh_gmm"]["decode"][name], bf["mesh_gmm"]["prefill"][name]
                extra["mesh_path"] = {"launches": mesh_launches[name],
                                      **{k: md[k] for k in timed},
                                      **{f"prefill_{k}": mp[k] for k in timed}}
        else:
            key = "decode" if name == "flash_decode_paged" else "attn"
            c, c32 = bf[key], fp[key]
            err, ex, err32, ex32 = (c["max_abs_err"], c["excess"], c32["max_abs_err"],
                                    c32["excess"])
            extra = {"faults": c["faults"]}
        if "device_ms" in c:
            extra.update({k: c[k] for k in ("device_ms", "library_device_ms", "live_bytes")})
        if name in ("flash_attention", "flash_decode"):
            # phase 3g's shapes of the kernel, and its launches there
            extra["family_cells"] = {
                what.split(" ", 1)[1]: {
                    **{k: c[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                         "bound_by", "max_abs_err", "excess", "shape",
                                         "device_ms", "library_device_ms") if k in c},
                    "excess_fp32": fp["family"][what]["excess"], "faults": c["faults"]}
                for what, c in bf["family"].items() if what.startswith(name + " ")}
        extra["launches_family_paths"] = {
            arch: r["launches"].get(name, 0) for arch, r in family_runs.items()}
        extra["launches_family_mesh_paths"] = {
            arch: r["launches"].get(name, 0) for arch, r in family_mesh_runs.items()}
        extra["launches_training_paths"] = {
            **{f"full width {impl}, {len(r['ms_per_step'])} steps": r["launches"].get(name, 0)
               for impl, r in training["full_width"].items()},
            "train CLI llama3.2-1b, 20 steps": (training["cli"]["launches_flash_attention"]
                                                if name == "flash_attention" else 0),
            **{f"small {what}, 3 steps": r["launches"].get(name, 0)
               for what, r in training["small"].items()},
            **{f"1 x 1 mesh, full width {impl}, {len(r['mesh']['ms_per_step'])} steps":
               r["mesh"]["launches"].get(name, 0) for impl, r in training["full_width"].items()},
            **{f"1 x 1 mesh, small {what}, {len(r['losses'])} steps": r["launches"].get(name, 0)
               for what, r in training["mesh"]["small"].items()},
            "1 x 1 mesh, train CLI llama3.2-1b, 3 steps": (
                training["mesh"]["cli"]["launches_flash_attention"]
                if name == "flash_attention" else 0)}
        extra["launches_kernel_bench"] = bench["launch_totals"].get(name, {})
        if name in op_names:
            extra["launches_served_paths"] = {
                "EP": launches[name], "ESP": esp_launches[name], "mesh": mesh_launches[name]}
            extra["launches_op_layer_path"] = op_launches[name]
        entries.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": tpu[name], "launches": path_launches[name],
            "max_abs_err": err, "max_abs_err_fp32": err32,
            "excess": ex, "excess_fp32": ex32,
            "tolerance": (f"|kernel - plain| <= rtol |plain| + atol rms(row): "
                          f"bf16 {PLAIN[torch.bfloat16]}, fp32 {PLAIN[torch.float32]}"),
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["shape"], **extra,
        })
    print(json.dumps({"analytic_figures": analytic}), flush=True)
    print(json.dumps({"kernels": entries, "run": run, "run_esp": esp_run,
                      "run_mesh": mesh_run, "run_scheduler": sched_run,
                      "run_chunked": chunk_run,
                      "run_mesh_serving": {"small": small_served, "chunked_chaos": mesh_chunk_run,
                                           "esp": esp_mesh_run},
                      "run_families": family_runs, "small_families": small_families,
                      "run_families_mesh": family_mesh_runs,
                      "small_families_mesh": small_family_mesh,
                      "run_training": training,
                      "run_kernel_bench": {k: v for k, v in bench.items() if k != "smoke"},
                      "op_layer_excess": op_excess}), flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
