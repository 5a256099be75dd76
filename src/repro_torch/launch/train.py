"""Training CLI (PyTorch port of ``repro.launch.train``), on one
process.

Runs any ``--arch`` (full or ``--smoke`` reduction) on the card by default;
``--device cpu`` takes the plain PyTorch path. Wired in, as in the
reference:

* the deterministic resumable data stream (``SyntheticLM``; its step
  cursor ``data_step`` rides in the checkpoint);
* async checkpoints every ``--ckpt-every`` steps, a final save, and
  restore-on-start from the newest complete checkpoint
  (``CheckpointManager``, the reference's file format: either package
  resumes the other's);
* the straggler watch (``StepTimer``), with one synchronisation a step so
  that it times the step.

A frontend-stub model (internvl2, seamless) trains on the serving CLI's
stub embeds, drawn per step (``launch.serve.stub_embeds`` seeded with the
step): the reference's CLI passes none, so its seamless run stops at the
encoder's assertion and its internvl2 trains on tokens alone.

``--mesh auto`` (the default) is one process. A mesh (``--mesh DxM``, a
``WORLD_SIZE`` above 1) and the cross-pod sync ``--pod-sync`` are ROADMAP
Queue 1 item 7b and raise.

Example (CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b --smoke \
      --device cpu --steps 3 --batch 2 --seq 16 --log-every 1
"""

from __future__ import annotations

import argparse
import os

import torch

from repro_torch.configs import ARCHS, get_config, smoke as smoke_cfg
from repro_torch.device import resolve_device
from repro_torch.launch.serve import parse_use_kernels, stub_embeds
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.data import DataConfig, SyntheticLM
from repro_torch.runtime.elastic import StepTimer
from repro_torch.runtime.optimizer import AdamWConfig, tree_map
from repro_torch.runtime.train import init_state, make_train_step

ITEM_7B = "ROADMAP Queue 1 item 7b: training under a mesh"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--pod-sync", type=int, default=0)
    ap.add_argument("--mesh", default="auto", help="auto (one process); DxM is not ported")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--use-kernels", default="auto", choices=("auto", "on", "off"),
                    help="CUDA kernels: auto = for CUDA tensors, on = always "
                    "(raises on the CPU), off = plain PyTorch paths")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    return ap.parse_args(argv)


def check_one_process(args: argparse.Namespace) -> None:
    """Refuse what needs training under a mesh (no fallback to one
    process)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.mesh != "auto" or world > 1:
        raise NotImplementedError(
            f"--mesh {args.mesh} with WORLD_SIZE {world}: {ITEM_7B} is not ported yet")
    if args.pod_sync:
        raise NotImplementedError(
            f"--pod-sync {args.pod_sync} (the compressed cross-pod sync): {ITEM_7B} "
            "is not ported yet")


def main(argv=None):
    """Train; returns the final state and one record a step (its metrics as
    floats and its ``seconds``)."""
    args = parse_args(argv)
    check_one_process(args)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_cfg(cfg)
    ctx = ParallelCtx(use_kernels=parse_use_kernels(args.use_kernels))

    opt = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    state = init_state(cfg, seed=0, device=device)
    step_fn = make_train_step(cfg, ctx, opt)

    data = SyntheticLM(DataConfig(cfg.vocab_size, args.batch, args.seq), device=device)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and mgr.latest() is not None:
        state, meta = mgr.restore(state)
        state = tree_map(lambda t: t.to(device), state)
        start = meta.get("data_step", meta["step"]) or 0
        print(f"[restore] resumed from step {start}")

    timer = StepTimer()
    history = []
    for step in range(start, args.steps):
        batch = data.batch_at(step)
        embeds = stub_embeds(cfg, args.batch, step, torch.float32, device)
        if embeds is not None:
            batch["embeds"] = embeds
        with timer:
            state, met = step_fn(state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        rec = {"step": step, **{k: float(v) for k, v in met.items()}, "seconds": timer.last}
        history.append(rec)
        if timer.is_straggling:
            print(f"[straggler] step {step} took {timer.ratio:.2f}x EMA")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(
                f"step {step:5d} loss {rec['loss']:.4f} "
                f"ce {rec['ce']:.4f} gnorm {rec['grad_norm']:.3f} "
                f"lr {rec['lr']:.2e} {timer.last:.2f}s"
            )
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.async_save(step + 1, state, extra={"data_step": step + 1})
    if mgr:
        mgr.wait()
        mgr.save(args.steps, state, extra={"data_step": args.steps})
        print(f"[ckpt] final at {args.steps}")
    return state, history


if __name__ == "__main__":
    main()
