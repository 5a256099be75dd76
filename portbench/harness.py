"""One run of one cell: set-up, the measured window, the metrics of the
cell, and the comparison that decides ``correct``.

Set-up (counted in ``setup_s``): the CUDA kernels built, or found built,
in the checkout's ``build/``; the weights made on the device from the
seed; the server; and a warm phase that serves until every client has
finished one request, which admits a prompt in every prefill bucket the
mix uses. Then the window. With ``trace`` its first 2 x ``TRACE_TICKS``
ticks run under ``torch.profiler`` (host calls, spans and the card; then
the card alone), and the host-clock metrics are read from the rest. After
the window: the peak memory, the metrics, the program freed, and the
reference run over a sample of what the window served.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time

import numpy as np
import torch

from portbench import check, record, serving, spec, traffic

TRACE_TICKS = 32
BANNED = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def card(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def card_state(device, when: str) -> None:
    """The card's clocks, temperature, power and power limit on standard
    error, read outside the measured ticks."""
    if device.type != "cuda":
        return
    query = "name,clocks.sm,clocks.mem,temperature.gpu,power.draw,power.limit"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        out = f"unread ({exc})"
    log(f"card at {when}: {out}")


def build_kernels(device) -> None:
    if device.type == "cuda":
        from repro_torch.kernels.build import build_all
        build_all()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device="cuda", bench: dict | None = None, config: dict | None = None,
             mix: dict | None = None, limit: dict | None = None,
             control: bool = False, trace_ticks: int = TRACE_TICKS) -> dict:
    """The result line of one run. ``config``, ``mix`` and ``limit``
    replace the cell's files (the CPU tests shrink them); ``control`` also
    reads the fp8 control (the readings tool)."""
    bench = bench or spec.load()
    cell = spec.cell(bench, workload)
    config = config or spec.config(bench, cell["config"])
    mix = mix or traffic.load(cell["traffic"])
    limit = limit or check.load_limit(workload)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    m, dtype = config["model"], config["dtype"]

    build_kernels(device)
    log(f"set-up: kernels ready at {time.perf_counter() - t_start:.2f} s")
    sched = serving.build(config, mix, seed, device)
    stream = traffic.Stream(mix, m["vocab_size"], seed)
    log(f"set-up: weights and server at {time.perf_counter() - t_start:.2f} s")
    with serving.Probe(sched, config) as probe:
        loop = serving.Loop(sched, stream, mix["clients"], sync)
        loop.warm()
        setup_s = time.perf_counter() - t_start
        log(f"set-up: warm phase of {len(loop.t1)} ticks, window opens at {setup_s:.2f} s")
        card_state(device, "window opens")
        i_open, i_close, spans, device_trace, traced_end = loop.window(
            seconds, probe, trace_ticks if trace else 0, check.SAMPLE_MIN)
        card_state(device, "window closed")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    moe_rows = [r.tolist() for r in probe.moe_rows]
    dev = card(device)
    if peak is not None:
        dev["memory_peak_bytes"] = int(peak)
    run = record.Run(
        t0=loop.t0, t1=loop.t1, admits=loop.admits,
        requests=[{"submit": r["submit"], "ticks": r["ticks"], "prompt_len": len(r["prompt"])}
                  for r in loop.requests],
        i_open=i_open, i_close=i_close, traced_end=traced_end, model=m, dtype=dtype,
        batch=sched.batch, setup_s=setup_s,
        trace=spans, device_trace=device_trace, moe_rows=moe_rows)
    log(f"window: {i_close - i_open} ticks in {run.t_close - run.t_open:.3f} s")
    done = serving.served(loop, i_open)
    attempted = sum(1 for r in loop.requests if r["ticks"] or r["req"].done)
    failed = sum(1 for r in loop.requests if r["req"].state == "FAILED")
    stats = {"ticks": i_close - i_open, "requests_finished": len(done),
             "migrations_before_window": int(loop.migrations[i_open - 1]),
             "migrations_window": int(loop.migrations[i_close - 1] - loop.migrations[i_open - 1]),
             "dropped_rows": int(probe.dropped), "moe_dispatches": probe.dispatches}
    if moe_rows:
        per = np.asarray(moe_rows).sum(axis=0)
        stats["routed_share_traced"] = [round(float(x), 6) for x in per / max(per.sum(), 1)]
    metrics = {}
    for mt in spec.metrics(bench, workload, trace):
        value = spec.reader(mt["name"])(run)
        if value is not None:
            metrics[mt["name"]] = {"value": float(value), "unit": mt["unit"]}
    if run.device_trace is not None:
        dev["busy_s"] = run.device_trace.busy_s
        dev["window_s"] = run.device_trace.window_s
    breakdown = None
    if run.device_trace is not None and run.device_trace.device:
        breakdown = {"device_ops": run.device_trace.top_ops(),
                     "idle_gaps": run.trace.idle_gaps()}

    # the program is freed before the reference runs
    del sched, loop, probe, run, stream
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sample = check.sample(done, seed)
    t_ref = time.perf_counter()
    got = check.readings(m, seed, getattr(torch, dtype), device, sample, control=control,
                         std=config["init_std"])
    log(f"reference: {time.perf_counter() - t_ref:.2f} s for {got['positions']} positions")
    tokens_ok = all(0 <= t < m["vocab_size"] for r in sample for t in r["tokens"])
    lim = limit["mean_gap_sd"]
    compared = {
        "mean_gap_sd": {"value": got["mean_gap_sd"], "limit": lim},
        "dropped_rows": {"value": stats["dropped_rows"], "limit": 0},
        "moe_dispatches_at_least": {"value": stats["moe_dispatches"], "limit": 1},
        "failed_requests": {"value": failed, "limit": 0},
        "sampled_requests_at_least": {"value": len(sample), "limit": check.SAMPLE_MIN},
    }
    correct = (got["mean_gap_sd"] <= lim and stats["dropped_rows"] == 0
               and stats["moe_dispatches"] >= 1 and failed == 0 and tokens_ok
               and len(sample) >= check.SAMPLE_MIN)
    log(f"stats: {stats}")
    log(f"readings: {got}")
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["readings"] = got
    result["check"] = compared
    for name, c in compared.items():
        log(f"check {name}: {c['value']} limit {c['limit']}")
    return result
