"""Training CLI (PyTorch port of ``repro.launch.train``), on one
process or under a mesh of ``torch.distributed`` ranks.

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
  that it times the step;
* the compressed cross-pod sync every ``--pod-sync`` steps
  (``parallel.grad_compress.compressed_pod_mean``) when the mesh has a pod
  axis. As in the reference, the CLI's ``DxM`` meshes have none, so there
  the flag does nothing.

``--mesh auto`` (the default) is one process, or with ``WORLD_SIZE`` above
1 (``torchrun``) the reference's mesh: a model axis of the largest power
of two up to 8 that divides the world, the rest data. ``--mesh DxM`` runs
``D x M`` ranks under ``torchrun``; ``--mesh 1x1`` runs in this process. A
caller that has initialised ``torch.distributed`` already is joined as it
is. Under a mesh every rank draws the same full init and keeps its slices
(``parallel.sharding.rank_params``), trains on its rows of each global
batch, and logs nothing unless it is global rank 0. Checkpoints hold the
reference's global arrays: a save gathers the model-sharded leaves over
the model group and rank 0 writes them; a restore gives each rank its
slices, so a checkpoint resumes on any mesh (the reference's elastic
restore).

A frontend-stub model (internvl2, seamless) trains on the serving CLI's
stub embeds, drawn per step (``launch.serve.stub_embeds`` seeded with the
step): the reference's CLI passes none, so its seamless run stops at the
encoder's assertion and its internvl2 trains on tokens alone.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b --smoke \
      --device cpu --steps 3 --batch 2 --seq 16 --log-every 1
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch dbrx-132b --smoke --device cpu --mesh 2x2 --steps 3 --batch 4 --seq 16
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config, smoke as smoke_cfg
from repro_torch.device import resolve_device
from repro_torch.launch.serve import parse_use_kernels, stub_embeds
from repro_torch.parallel import sharding
from repro_torch.parallel.collectives import all_gather_dim
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.grad_compress import compressed_pod_mean
from repro_torch.parallel.mesh import init_distributed, make_mesh, parse_mesh
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.data import DataConfig, SyntheticLM
from repro_torch.runtime.elastic import StepTimer
from repro_torch.runtime.optimizer import AdamWConfig, tree_map
from repro_torch.runtime.train import init_state, make_train_step


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
    ap.add_argument("--pod-sync", type=int, default=0,
                    help="average the parameters over the pod axis, int8 on the wire, "
                    "every K steps; the DxM meshes have no pod axis, so it does "
                    "nothing there (as in the reference)")
    ap.add_argument("--mesh", default="auto",
                    help="auto (one process, or the reference's mesh over WORLD_SIZE "
                    "ranks) or DxM, e.g. 2x2 under torchrun; 1x1 runs in process")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--use-kernels", default="auto", choices=("auto", "on", "off"),
                    help="CUDA kernels: auto = for CUDA tensors, on = always "
                    "(raises on the CPU), off = plain PyTorch paths")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    return ap.parse_args(argv)


def mesh_shape(spec: str, world: int) -> tuple[int, int] | None:
    """``(data, model)`` of ``--mesh`` over ``world`` ranks; None for one
    process. ``auto`` takes the reference's model axis: the largest power
    of two up to 8 that divides the world."""
    if spec != "auto":
        d, m = parse_mesh(spec)
        if d * m != world:
            raise ValueError(f"--mesh {spec} needs {d * m} ranks; the world has {world} "
                             "(start it with torchrun)")
        return d, m
    if world == 1:
        return None
    m = 1
    while world % (m * 2) == 0 and m * 2 <= 8:
        m *= 2
    return world // m, m


def _with_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the tensors of a nested dict (``None``
    subtrees, zamba's empty ``trailing`` stack, stay ``None``)."""
    if isinstance(tree, dict):
        return {k: _with_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return None if tree is None else fn(prefix.rstrip("/"), tree)


def state_layout(cfg, ctx: ParallelCtx) -> dict:
    """The model-sharded leaves of the train state by path: the
    parameters' (``sharding.param_layout``) and their two moments'."""
    lay = sharding.param_layout(cfg, ctx)
    return {f"{pre}/{p}": v for pre in ("params", "opt/mu", "opt/nu") for p, v in lay.items()}


def gather_state(state: dict, layout: dict, ctx: ParallelCtx) -> dict:
    """The state with its model-sharded leaves gathered over the model
    group (global arrays; a Mamba2 leaf's B/C columns, which every rank
    holds, and a copied KV head, once); a collective: every rank of the
    group calls it."""
    if not layout:
        return state
    mesh = ctx.mesh

    def gather(p, t):
        if p not in layout:
            return t
        return sharding.whole(t, *layout[p], lambda own, dim: all_gather_dim(
            own, dim, mesh.model_group, mesh.model_order))

    return _with_paths(gather, state)


def restore_shardings(state: dict, layout: dict, device) -> dict:
    """One callable a leaf of ``state``, taking the checkpoint's global
    host array to this rank's slice on ``device``."""
    def cut(p, _):
        def fn(host, spec=layout.get(p)):
            if spec is not None:
                host = sharding.take(host, *spec)
            return host.to(device)
        return fn
    return _with_paths(cut, state)


def main(argv=None):
    """Train; returns the final state (the rank's slices) and one record a
    step (its metrics as floats and its ``seconds``)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    joined = dist.is_initialized()
    world = dist.get_world_size() if joined else int(os.environ.get("WORLD_SIZE", "1"))
    shape = mesh_shape(args.mesh, world)
    mesh = None
    if shape is not None:
        if not joined:
            if device.type == "cuda":
                device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            init_distributed(device, world, int(os.environ.get("RANK", "0")))
        mesh = make_mesh(*shape)
    main_rank = mesh is None or mesh.rank == 0
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_cfg(cfg)
    ctx = ParallelCtx(mesh=mesh, use_kernels=parse_use_kernels(args.use_kernels),
                      batch_replicated=mesh is not None and args.batch % mesh.n_batch != 0)
    rows = sharding.batch_rows(args.batch, ctx.n_batch, ctx.batch_rank)

    opt = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    state = init_state(cfg, seed=0, device=device, ctx=ctx if mesh else None)
    step_fn = make_train_step(cfg, ctx, opt)
    layout = state_layout(cfg, ctx)

    data = SyntheticLM(DataConfig(cfg.vocab_size, args.batch, args.seq), device=device)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and mgr.latest() is not None:
        if mesh is None:
            state, meta = mgr.restore(state)
            state = tree_map(lambda t: t.to(device), state)
        else:
            state, meta = mgr.restore(state, shardings=restore_shardings(state, layout,
                                                                           device))
        start = meta.get("data_step", meta["step"]) or 0
        if main_rank:
            print(f"[restore] resumed from step {start}")

    timer = StepTimer()
    history = []
    for step in range(start, args.steps):
        batch = {k: v[rows] for k, v in data.batch_at(step).items()}
        embeds = stub_embeds(cfg, args.batch, step, torch.float32, device)
        if embeds is not None:
            batch["embeds"] = embeds[rows]
        with timer:
            state, met = step_fn(state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        rec = {"step": step, **{k: float(v) for k, v in met.items()}, "seconds": timer.last}
        history.append(rec)
        if timer.is_straggling and main_rank:
            print(f"[straggler] step {step} took {timer.ratio:.2f}x EMA")
        if args.pod_sync and mesh is not None and mesh.pod > 1 \
                and (step + 1) % args.pod_sync == 0:
            state["params"] = compressed_pod_mean(state["params"], mesh)
        if main_rank and (step % args.log_every == 0 or step == args.steps - 1):
            print(
                f"step {step:5d} loss {rec['loss']:.4f} "
                f"ce {rec['ce']:.4f} gnorm {rec['grad_norm']:.3f} "
                f"lr {rec['lr']:.2e} {timer.last:.2f}s"
            )
        if mgr and (step + 1) % args.ckpt_every == 0:
            whole = gather_state(state, layout, ctx)
            if main_rank:
                mgr.async_save(step + 1, whole, extra={"data_step": step + 1})
            del whole
    if mgr:
        whole = gather_state(state, layout, ctx)
        if main_rank:
            mgr.wait()
            mgr.save(args.steps, whole, extra={"data_step": args.steps})
            print(f"[ckpt] final at {args.steps}")
        del whole
    if mesh is not None:
        dist.barrier()                  # the files are written before any rank reads them
        if not joined:
            dist.destroy_process_group()
    return state, history


if __name__ == "__main__":
    main()
