"""Continuous-batching serving with admission control, preemption and a
seeded fault-injection schedule — all on a single process: virtual EP runs
the NI-Balancer (replicas, migration, evacuation) over slot rows without a
device mesh.

  PYTHONPATH=src python -m repro_torch.examples.continuous_serving [--device cpu]

Five ragged requests share a 3-slot batch over a deliberately undersized
page pool while the fault plan kills a (virtual) device, reports a
straggler, squeezes the pool and poisons one step's logits. Every request
still finishes, and its tokens are bit-identical to a sequential
fault-free run: the determinism contract of ``runtime/scheduler.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.examples import kernels, parser, smoke_model
from repro_torch.models import transformer as T
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.runtime.faults import FaultPlan
from repro_torch.runtime.optimizer import tree_map
from repro_torch.runtime.scheduler import FINISHED, RequestScheduler
from repro_torch.runtime.serve import ServeConfig, Server

MAX_NEW = 8
PROMPT_LENS = (5, 11, 3, 8, 13)


def main(argv=None, *, params=None, use_kernels=True) -> dict:
    """The sequential reference runs, then the chaos run; returns both
    runs' tokens, the chaos run's events, stats and migrations, and
    whether parity held."""
    args = parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    cfg = smoke_model("dbrx-132b", device, n_experts=4, experts_per_token=2)
    if params is None:
        params = T.init_params(cfg, seed=0, device=device)
    # capacity_factor high enough that routing never drops a copy — the
    # precondition for bit-exact replay
    ctx = ParallelCtx(capacity_factor=8.0, use_kernels=kernels(use_kernels))

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]

    def make_server(batch, pool_pages, prefill_chunk=None):
        # each server migrates expert rows in its own copy of the weights
        return Server(
            cfg, ctx, tree_map(torch.clone, params),
            ServeConfig(max_seq=64, batch=batch, paged=True, page_size=8,
                        pool_pages=pool_pages, slots_per_device=3, virtual_ep=4,
                        alpha=0.1, prefill_chunk=prefill_chunk),
            device=device,
        )

    print("sequential fault-free reference...")
    ref = []
    for p in prompts:
        sched = RequestScheduler(make_server(batch=1, pool_pages=64))
        req = sched.submit(p, max_new_tokens=MAX_NEW)
        sched.run()
        ref.append(list(req.tokens_out))

    print("chaos run: 3 slots, 10-page pool, chunked admission, faults...")
    plan = FaultPlan.chaos(seed=14, n_steps=12, n_devices=4, pressure_pages=5,
                           nan_slots=(0,))
    for f in plan:
        print(f"  step {f.step:>2}: {f.kind}")
    # prefill_chunk=8: admission rides the decode step's prefill lane, one
    # 8-token chunk per tick — live slots keep emitting while prompts load.
    sched = RequestScheduler(
        make_server(batch=3, pool_pages=10, prefill_chunk=8), faults=plan
    )
    reqs = [
        sched.submit(p, max_new_tokens=MAX_NEW, arrival=i)
        for i, p in enumerate(prompts)
    ]
    sched.run()

    for step, kind, detail in sched.events:
        print(f"  step {step:>2}: {kind} {detail}")
    ok = True
    for i, r in enumerate(reqs):
        match = list(r.tokens_out) == ref[i]
        ok &= r.state == FINISHED and match
        print(
            f"request {r.rid}: {r.state}, {len(r.tokens_out)} tokens, "
            f"{r.preemptions} preemption(s), parity={'OK' if match else 'FAIL'}"
        )
    stats = sched.stats()
    print(
        f"serving stats: max_ttft={stats['max_ttft_ticks']} ticks, "
        f"max_stall={stats['max_stall_ticks']} ticks, "
        f"queue_depth={stats['queue_depth']}, "
        f"prefill_backlog={stats['prefill_backlog']} tokens"
    )
    for rid, s in stats["per_request"].items():
        print(
            f"  request {rid}: ttft={s['ttft_ticks']} ticks, "
            f"stall={s['max_stall_ticks']}, tokens={s['n_tokens']}, "
            f"preemptions={s['preemptions']}"
        )
    print(
        f"{'PARITY HELD' if ok else 'PARITY BROKEN'} under "
        f"{len(plan)} faults, {sched.n_preempted} preemption(s), "
        f"{sched.server.migrations} migration(s)"
    )
    return {"ref": ref, "tokens": [list(r.tokens_out) for r in reqs],
            "events": sched.events, "stats": stats, "n_faults": len(plan),
            "n_preempted": sched.n_preempted, "migrations": sched.server.migrations,
            "parity": ok}


if __name__ == "__main__":
    main()
