"""End-to-end training example: a ~63M-parameter llama-family model trained
for a few hundred steps on the synthetic Markov corpus, with checkpointing
and restart along the way.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_tiny_lm [--steps 300]
      [--device cpu]

A run resumes from the newest checkpoint in ``--ckpt`` (either package's:
the file format is the reference's), saves one in the background every 100
steps and one at the end.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.examples import kernels, parser
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.data import DataConfig, SyntheticLM
from repro_torch.runtime.elastic import StepTimer
from repro_torch.runtime.optimizer import AdamWConfig, adamw_init, tree_map
from repro_torch.runtime.train import init_state, make_train_step


def parse_args(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_tiny_lm"))
    return ap.parse_args(argv)


def model_config():
    """~63M params: llama3.2-1b narrowed to 8 layers x 768 wide, 8k vocab."""
    return dataclasses.replace(
        get_config("llama3.2-1b"),
        n_layers=8,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab_size=8192,
        tie_embeddings=False,
    )


def main(argv=None, *, params=None, use_kernels=True) -> dict:
    """Train to ``--steps``; returns the parameter count (millions), the
    step it resumed from, one record a step run (loss, lr, seconds) and
    the final state. ``params`` replaces the seeded init (fresh moments);
    a checkpoint in ``--ckpt`` takes precedence over both."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = model_config()
    print(f"model: {cfg.param_count() / 1e6:.1f}M params")

    opt = AdamWConfig(lr=1e-3, warmup_steps=30, total_steps=args.steps)
    step_fn = make_train_step(cfg, ParallelCtx(use_kernels=kernels(use_kernels)), opt)
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.batch, args.seq), device=device)
    mgr = CheckpointManager(args.ckpt, keep=2)

    if params is None:
        state = init_state(cfg, seed=0, device=device)
    else:
        state = {"params": params, "opt": adamw_init(params)}
    start = 0
    if mgr.latest() is not None:
        state, meta = mgr.restore(state)
        state = tree_map(lambda t: t.to(device), state)
        start = meta["data_step"]
        print(f"resumed from step {start}")

    timer = StepTimer()
    history = []
    for step in range(start, args.steps):
        with timer:
            state, met = step_fn(state, data.batch_at(step))
            loss = float(met["loss"])     # waits for the step
        history.append({"step": step, "loss": loss, "lr": float(met["lr"]),
                        "seconds": timer.last})
        if step % 20 == 0 or step == args.steps - 1:
            print(
                f"step {step:4d}  loss {loss:.4f}  "
                f"lr {float(met['lr']):.2e}  {timer.last:.2f}s/step"
            )
        if (step + 1) % 100 == 0:
            mgr.async_save(step + 1, state, extra={"data_step": step + 1})
    mgr.wait()
    mgr.save(args.steps, state, extra={"data_step": args.steps})
    print(f"done; checkpoints in {args.ckpt}")
    return {"params_m": cfg.param_count() / 1e6, "start": start, "history": history,
            "state": state}


if __name__ == "__main__":
    main()
