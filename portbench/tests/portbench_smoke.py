"""Shared helpers of portbench's CPU tests: a cell shrunk to a size the
CPU serves in a second, run through the harness's own code."""

from __future__ import annotations

import copy
import time

import torch

from portbench import harness, spec, traffic

# The limit of mean_gap_sd at this size. The program serves in fp32 here
# (the CPU's bf16 products are slow to start and would shorten the timed
# window), so sound runs read 0 against the fp32 reference, and the fp8
# control reads 0.085-0.167 over seeds 31-40 of both chat cells.
SMOKE_LIMIT = 0.03

SMOKE_MODEL = dict(n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
                   d_ff=128, vocab_size=1024, n_experts=4, experts_per_token=2,
                   moe_d_ff=96)


def shrunk(workload: str):
    """(bench, config, mix) of ``workload`` at smoke size: the widths cut
    to SMOKE_MODEL, fp32, 4 clients, short prompts and outputs, one block
    of lengths a client (the warm phase admits every length). EP keeps its
    20 slots, so its drop-free capacity factor becomes 20 / 2. The
    weights' std keeps the full width's gain of a product, std x
    sqrt(d_model)."""
    bench = spec.load()
    cell = spec.cell(bench, workload)
    config = copy.deepcopy(spec.config(bench, cell["config"]))
    gain = config["init_std"] * config["model"]["d_model"] ** 0.5
    config["model"].update(SMOKE_MODEL)
    config["init_std"] = gain / SMOKE_MODEL["d_model"] ** 0.5
    config["dtype"] = "float32"
    serve = config["serve"]
    serve["batch"] = 4
    if serve.get("virtual_ep"):
        slots = serve["virtual_ep"] * serve["slots_per_device"]
        config["parallel"]["capacity_factor"] = slots / SMOKE_MODEL["experts_per_token"]
    mix = copy.deepcopy(traffic.load(cell["traffic"]))
    mix.update(clients=4, max_seq=64, block=4)
    mix["prompt_tokens"].update(lo=4, hi=24)
    mix["output_tokens"].update(lo=8, hi=20)
    return bench, config, mix


def run(workload: str, seed: int, *, seconds: float = 1.5, trace: bool = False,
        control: bool = False, parallel: dict | None = None) -> dict:
    """One smoke run on one CPU thread (the test workers share the cores),
    the process's thread count restored after it; ``parallel`` overrides
    keys of the configuration's ``ParallelCtx``."""
    bench, config, mix = shrunk(workload)
    config["parallel"].update(parallel or {})
    lim = {"mean_gap_sd": SMOKE_LIMIT}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(workload, seed, seconds, trace, t_start=time.perf_counter(),
                                device="cpu", bench=bench, config=config, mix=mix,
                                limit=lim, control=control, trace_ticks=3)
    finally:
        torch.set_num_threads(threads)
