#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is non-zero):

1. the card's name and power limit (``nvidia-smi``); build the CUDA kernels
   from ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. a small fp32 model served on the card with the kernels and with the
   plain path: the greedy tokens must agree;
3. the main path: ``Server.generate`` at dbrx-132b width (4 layers, bf16,
   8 requests x 256-token prompts, 32 new tokens) with the NI-Balancer
   live and one stepped migration forced through ``apply_plan``, after a
   short warm-up run of the same server. Prefill (TTFT) and the decode loop
   are timed apart with CUDA events. Every kernel's launch count must equal
   what the layer count predicts. Then the expert groups' row counts of one
   prefill and one decode tick are kept for phase 4, and 8 more decode
   steps run under ``torch.profiler`` for the device busy share;
4. every kernel at the main path's shapes and row counts, in bf16 and in
   fp32 (TF32 off), held elementwise against its plain PyTorch version
   (``repro_torch.kernels.tolerance``) with dead rows and dead pages
   poisoned with NaN; the bf16 GMMs also against the fp32 product of the
   same bf16 inputs; deliberate faults (a dropped K tile, a dropped live
   row, a dropped key) must fail the bf16 limit. Then each kernel is timed
   beside its plain version and a PyTorch library call the port never
   makes, with its roofline bound;
5. a ``{"kernels": [...]}`` line, the card line, and the final
   ``{"ok": true, "device": {...}}`` line.

Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense tensor-core bf16 / fp32 non-tensor
GMM_BK = 32          # K tile of the bf16 tensor-core GMM (csrc/gmm_ragged.cu WM_BK)


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


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def gmm_cells(torch, groups, dtype, timer, time_it: bool):
    """gmm_dual_act_ragged and gmm_ragged at the main path's bucket shapes
    (20 slots, D=6144, F=10752) and row counts (``groups``: phase ->
    (capacity C, counts))."""
    from repro_torch.kernels.gmm import ragged as K
    from repro_torch.kernels.gmm import ref as R
    from repro_torch.kernels.tolerance import PLAIN, ROUNDING

    dt = getattr(torch, dtype)
    tol = PLAIN[dt]
    G, D, F = 20, 6144, 10752
    gen = torch.Generator(device="cuda").manual_seed(1)
    wg = (torch.randn((G, D, F), generator=gen, device="cuda") * 0.02).to(dt)
    wu = (torch.randn((G, D, F), generator=gen, device="cuda") * 0.02).to(dt)
    wd = (torch.randn((G, F, D), generator=gen, device="cuda") * 0.02).to(dt)
    results = {}
    for phase, (C, counts) in groups.items():
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
                    library_ms=timer(lib, reps), bound_ms=b_ms, bound_by=b_by,
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


def decode_cell(torch, dtype, timer, time_it: bool):
    """flash_decode_paged at the main path's decode shapes: 8 requests,
    48 query heads over 8 KV heads of 128, pages of 128, 8 blocks each."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_decode import paged as K
    from repro_torch.kernels.flash_decode import ref as R
    from repro_torch.kernels.tolerance import PLAIN

    dt = getattr(torch, dtype)
    tol = PLAIN[dt]
    B, H, KV, hd, bs, NB = 8, 48, 8, 128, 128, 8
    P = B * NB + 1
    gen = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn((B, H, hd), generator=gen, device="cuda").to(dt)
    pool_k = torch.randn((P, bs, KV, hd), generator=gen, device="cuda").to(dt)
    pool_v = torch.randn((P, bs, KV, hd), generator=gen, device="cuda").to(dt)
    lengths = torch.randint(257, 289, (B,), generator=gen, device="cuda").to(torch.int32)
    tables = torch.randperm(P - 1, generator=gen, device="cuda")[: B * NB]
    tables = tables.reshape(B, NB).to(torch.int32).contiguous()
    # Poison every row past each request's length: dead rows of the last
    # live page and every dead page.
    for b in range(B):
        n = int(lengths[b])
        for j in range(NB):
            lo = max(0, n - j * bs)
            if lo < bs:
                page = int(tables[b, j])
                pool_k[page, lo:] = float("nan")
                pool_v[page, lo:] = float("nan")
    want = R.paged_decode(q, pool_k, pool_v, tables, lengths)
    cell = held(torch, K.flash_decode_paged(q, pool_k, pool_v, tables, lengths), want,
                tol, f"flash_decode_paged {dtype}")
    if dt == torch.bfloat16:
        cell["faults"] = caught(tol, {
            "last live key dropped":
                (lambda: R.paged_decode(q, pool_k, pool_v, tables, lengths - 1), want),
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
        cell.update(
            ms=timer(lambda: K.flash_decode_paged(q, pool_k, pool_v, tables, lengths), 50),
            plain_ms=timer(lambda: R.paged_decode(q, pool_k, pool_v, tables, lengths), 20),
            library_ms=timer(lambda: Fn.scaled_dot_product_attention(
                q4, kd, vd, attn_mask=mask, enable_gqa=True), 50),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"B={B} H={H} K={KV} hd={hd} bs={bs} NB={NB} sum(len)={live}",
        )
    return cell


def attention_cell(torch, dtype, timer, time_it: bool):
    """flash_attention at the main path's prefill shapes: 8 x 256 tokens,
    48 query heads over 8 KV heads of 128, causal."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_attention import flash_attention as K
    from repro_torch.kernels.flash_attention import ref as R
    from repro_torch.kernels.tolerance import PLAIN

    dt = getattr(torch, dtype)
    tol = PLAIN[dt]
    B, S, H, KV, hd = 8, 256, 48, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dt)
    want = R.mha(q, k, v)
    cell = held(torch, K.flash_attention(q, k, v), want, tol, f"flash_attention {dtype}")
    # a shorter query block at the tail of the keys, with a window
    qt = q[:, -100:].contiguous()
    tail = held(torch, K.flash_attention(qt, k, v, window=64), R.mha(qt, k, v, window=64),
                tol, f"flash_attention tail+window {dtype}")
    cell = {key: max(cell[key], tail[key]) for key in cell}
    if dt == torch.bfloat16:
        # queries 1.. without their own (diagonal) key
        cell["faults"] = caught(tol, {
            "diagonal key dropped":
                (lambda: R.mha(q[:, 1:], k[:, :-1], v[:, :-1]), want[:, 1:]),
        }, f"flash_attention {dtype}")
    if time_it:
        isz = q.element_size()
        pairs = B * H * S * (S + 1) // 2
        nbytes = isz * (2 * B * S * H * hd + 2 * B * S * KV * hd)
        ops = 4 * hd * pairs
        b_ms, b_by = bound(nbytes, ops, dtype)
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        cell.update(
            ms=timer(lambda: K.flash_attention(q, k, v), 20),
            plain_ms=timer(lambda: R.mha(q, k, v), 20),
            library_ms=timer(lambda: Fn.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True), 20),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"B={B} S=T={S} H={H} K={KV} hd={hd} causal",
        )
    return cell


# ---------------------------------------------------------------------------
# phases 2-3: serving
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


def timed_generate(torch, srv, prompt, n_new: int):
    """``srv.generate`` with CUDA events at its start, after its prefill and
    at its end. Returns the tokens, the prefill's logits, the prefill time
    (TTFT) and the decode loop's time, in seconds."""
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
        out = srv.generate(prompt, n_new)
        events[2].record()
        torch.cuda.synchronize()
    finally:
        del srv.prefill
    return (out, kept["logits"], events[0].elapsed_time(events[1]) / 1e3,
            events[1].elapsed_time(events[2]) / 1e3)


def expert_groups(torch, srv, prompt) -> dict:
    """Layer 0's expert-group row counts in one prefill and one decode tick
    of the main-path server, after its timed run (committed replicas
    included): phase -> (bucket capacity, counts)."""
    from repro_torch.kernels import registry

    seen = []
    ffn = registry.expert_ffn

    def spy(x, wg, wu, wd, group_sizes, *args):
        seen.append((x.shape[1], group_sizes.cpu().numpy()))
        return ffn(x, wg, wu, wd, group_sizes, *args)

    registry.expert_ffn = spy
    try:
        logits, cache = srv.prefill(prompt)
        n_prefill = len(seen)
        srv.decode(torch.argmax(logits[:, -1:], dim=-1), cache)
    finally:
        registry.expert_ffn = ffn
    return {"decode": seen[n_prefill], "prefill": seen[0]}


def main_path(torch, card: str):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode.paged import flash_decode_paged
    from repro_torch.kernels.gmm.ragged import gmm_dual_act_ragged, gmm_ragged
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
    kernels = (gmm_dual_act_ragged, gmm_ragged, flash_decode_paged, flash_attention)
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


def profile_decode(torch, srv, prompt, card: str, steps: int = 8) -> dict:
    """Device busy share and time by kernel over ``steps`` decode steps of
    the main-path server (a separate window from the timed run)."""
    from torch.profiler import ProfilerActivity, profile

    logits, cache = srv.prefill(prompt)
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
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"profile: {steps} decode steps in {wall_ms:.1f} ms wall, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%); by kernel: "
        + "; ".join(f"{name[:48]} {ms:.2f} ms" for name, ms in top) + f" [{card}]")
    return {"profile_step_ms": wall_ms / steps, "device_busy_share": busy_ms / wall_ms}


# ---------------------------------------------------------------------------

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
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    migs = small_parity(torch)
    log(f"small fp32 model on the card: kernel and plain greedy tokens agree "
        f"(migrations {migs})")
    torch.cuda.empty_cache()

    launches, groups, run = main_path(torch, card)
    gc.collect()
    torch.cuda.empty_cache()

    timer = Timer(torch)
    cells = {}
    for dtype in ("bfloat16", "float32"):
        time_it = dtype == "bfloat16"
        g = gmm_cells(torch, groups, dtype, timer, time_it)
        d = decode_cell(torch, dtype, timer, time_it)
        a = attention_cell(torch, dtype, timer, time_it)
        cells[dtype] = {"gmm": g, "decode": d, "attn": a}
        log(f"kernels {dtype}, error over its limit (rtol, atol) = "
            f"{PLAIN[getattr(torch, dtype)]}: gmm_dual_act_ragged decode "
            f"{g['decode']['gmm_dual_act_ragged']['excess']:.3g} prefill "
            f"{g['prefill']['gmm_dual_act_ragged']['excess']:.3g}; gmm_ragged decode "
            f"{g['decode']['gmm_ragged']['excess']:.3g} prefill "
            f"{g['prefill']['gmm_ragged']['excess']:.3g}; flash_decode_paged "
            f"{d['excess']:.3g}; flash_attention {a['excess']:.3g}")
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
            c = bf["gmm"][phase][name]
            log(f"time {name} {phase} [{c['shape']}]: kernel {c['ms']:.3f} ms, plain "
                f"{c['plain_ms']:.3f} ms, torch.bmm {c['library_ms']:.3f} ms, bound "
                f"{c['bound_ms']:.3f} ms ({c['bound_by']}) [{card}]")
    for name, c, lib in (("flash_decode_paged", bf["decode"], "sdpa"),
                         ("flash_attention", bf["attn"], "sdpa")):
        log(f"time {name} [{c['shape']}]: kernel {c['ms']:.4f} ms, plain "
            f"{c['plain_ms']:.4f} ms, {lib} {c['library_ms']:.4f} ms, bound "
            f"{c['bound_ms']:.4f} ms ({c['bound_by']}) [{card}]")

    tpu = {
        "gmm_dual_act_ragged": "src/repro/kernels/gmm/ragged.py:223",
        "gmm_ragged": "src/repro/kernels/gmm/ragged.py:151",
        "flash_decode_paged": "src/repro/kernels/flash_decode/paged.py:140",
        "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:116",
    }
    source = {
        "gmm_dual_act_ragged": "src/repro_torch/csrc/gmm_ragged.cu",
        "gmm_ragged": "src/repro_torch/csrc/gmm_ragged.cu",
        "flash_decode_paged": "src/repro_torch/csrc/flash_decode_paged.cu",
        "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    }
    fp = cells["float32"]
    entries = []
    for name in ("gmm_dual_act_ragged", "gmm_ragged", "flash_decode_paged",
                 "flash_attention"):
        if name.startswith("gmm"):
            # timed at the decode cell: the kernel's call on every decode tick
            c, pre = bf["gmm"]["decode"][name], bf["gmm"]["prefill"][name]
            both, both32 = (c, pre), (fp["gmm"]["decode"][name], fp["gmm"]["prefill"][name])
            err, ex, err32, ex32 = (max(x[key] for x in cs) for cs, key in (
                (both, "max_abs_err"), (both, "excess"),
                (both32, "max_abs_err"), (both32, "excess")))
            extra = {"excess_fp32_product": max(x["excess_fp32_product"] for x in both),
                     "faults": {**c["faults"], **pre["faults"]},
                     "prefill_ms": pre["ms"], "prefill_plain_ms": pre["plain_ms"],
                     "prefill_library_ms": pre["library_ms"],
                     "prefill_bound_ms": pre["bound_ms"],
                     "prefill_bound_by": pre["bound_by"], "prefill_shape": pre["shape"]}
        else:
            key = "decode" if name == "flash_decode_paged" else "attn"
            c, c32 = bf[key], fp[key]
            err, ex, err32, ex32 = (c["max_abs_err"], c["excess"], c32["max_abs_err"],
                                    c32["excess"])
            extra = {"faults": c["faults"]}
        entries.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": tpu[name], "launches": launches[name],
            "max_abs_err": err, "max_abs_err_fp32": err32,
            "excess": ex, "excess_fp32": ex32,
            "tolerance": (f"|kernel - plain| <= rtol |plain| + atol rms(row): "
                          f"bf16 {PLAIN[torch.bfloat16]}, fp32 {PLAIN[torch.float32]}"),
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["shape"], **extra,
        })
    print(json.dumps({"kernels": entries, "run": run}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
