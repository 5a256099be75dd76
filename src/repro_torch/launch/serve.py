"""Serving driver: batched generation with the NI-Balancer active.

Runs on the card by default; ``--device cpu`` takes the plain PyTorch path.
The KV cache is dense unless ``--paged`` asks for the page pool, as in the
reference's CLI.

``--prefill-chunk N`` (with ``--paged``) serves each batch's requests
through the ``RequestScheduler`` with chunked admission: N context tokens
a tick ride the decode step's prefill lane.

``--arch`` takes every architecture of the reference. A frontend-stub
model (internvl2's patch embeddings, seamless's frame embeddings) gets,
for batch i, ``0.02 * randn(requests, frontend_tokens, d_model)`` from a
CPU ``torch.Generator`` seeded with i, as the reference's CLI draws them
(with JAX's generator), in the model's ``--dtype``: in float32 (the
default) that is the reference's dtype; in bfloat16 the encoder and
``flash_attention`` then run in bf16 (fp32 embeds with bf16 weights would
promote the encoder to fp32, as JAX does: ``models.layers.mm``).

``--mesh DxM`` serves under a ``("data", "model")`` mesh of
``torch.distributed`` ranks: EP (or with ``--moe-impl esp`` ESP's
hidden-dim shards) over the model axis, the dense cache's slots (or the
paged pool's KV heads) split over it, the batch over the data axis; every
option above serves under it. Under ``torchrun`` the ranks come from
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``; rank r uses ``cuda:LOCAL_RANK``
with NCCL, or gloo with ``--device cpu``. A world of one (``--mesh 1x1``)
needs no ``torchrun``. Rank 0 prints.

Examples (CPU, smoke size):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --smoke \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-76b --smoke \
      --device cpu --paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b --smoke \
      --device cpu --requests 4 --prompt-len 16 --gen 8 --virtual-ep 4 --slots 3 \
      --paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b --smoke \
      --device cpu --moe-impl esp
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch dbrx-132b --smoke --device cpu --mesh 2x2 --slots 3 --alpha 0.1 \
      --paged --page-size 8 --prefill-chunk 8
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config, smoke as smoke_cfg
from repro_torch.core.topology import MeshTopology
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.mesh import init_distributed, make_mesh, parse_mesh
from repro_torch.runtime.data import request_stream
from repro_torch.runtime.scheduler import RequestScheduler
from repro_torch.runtime.serve import ServeConfig, Server

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_use_kernels(value: str) -> str | bool:
    """CLI tri-state ("auto"|"on"|"off") -> ``ParallelCtx.use_kernels``."""
    return {"on": True, "off": False}.get(value, "auto")


def mesh_plan(m: int):
    """The planning parameters of a model axis of ``m`` ranks, as the
    reference CLI sets them: capacity factor 4.0 and the ER-Mapping hop
    distance between model ranks on ``MeshTopology(rows, m // rows)``, with
    rows = sqrt(m) when m is a square, else 1."""
    r = int(m**0.5)
    rows = r if r * r == m else 1
    topo = MeshTopology(rows, m // rows)
    return 4.0, lambda a, b: topo.hops(topo.coord(a), topo.coord(b))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths unchanged)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--virtual-ep", type=int, default=None,
                    help="logical EP devices of the balancer (default: none; "
                    "without a mesh the model then serves moe_impl 'auto')")
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--moe-impl", default="auto", choices=("auto", "dense", "ep", "esp"),
                    help="MoE path; esp serves the experts' own weights "
                    "(no --virtual-ep)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: shared page pool + per-request block "
                    "tables (default: one dense cache per layer)")
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--pool-pages", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked admission through the RequestScheduler: this "
                    "many context tokens a tick (needs --paged)")
    ap.add_argument("--ep-chunks", type=int, default=1)
    ap.add_argument("--use-kernels", default="auto", choices=("auto", "on", "off"),
                    help="CUDA kernels: auto = for CUDA tensors, on = always "
                    "(raises on the CPU), off = plain PyTorch paths")
    ap.add_argument("--mesh", default=None,
                    help="DxM: serve under a data x model mesh of ranks "
                    "(torchrun for more than one)")
    return ap.parse_args(argv)


def serve_config(args: argparse.Namespace) -> ServeConfig:
    return ServeConfig(
        max_seq=args.max_seq, batch=args.requests, slots_per_device=args.slots,
        alpha=args.alpha, paged=args.paged, page_size=args.page_size,
        pool_pages=args.pool_pages, virtual_ep=args.virtual_ep,
        prefill_chunk=args.prefill_chunk, ep_chunks=args.ep_chunks,
    )


def stub_embeds(cfg, requests: int, batch: int, dtype, device) -> torch.Tensor | None:
    """Batch ``batch``'s frontend-stub embeds (None without a stub):
    ``0.02 * randn(requests, frontend_tokens, d_model)`` drawn on the CPU
    from a generator seeded with the batch index, in ``dtype``."""
    if not cfg.frontend_stub:
        return None
    gen = torch.Generator().manual_seed(batch)
    e = torch.randn((requests, cfg.frontend_tokens, cfg.d_model), generator=gen) * 0.02
    return e.to(device=device, dtype=dtype)


def serve_batch(server: Server, prompt, n_new: int, embeds=None) -> torch.Tensor:
    """``(B, n_new)`` tokens of a batch of prompts: ``generate``, or with
    ``prefill_chunk`` the requests through a ``RequestScheduler``."""
    if not server.scfg.prefill_chunk:
        return server.generate(prompt, n_new, embeds=embeds)
    if embeds is not None:
        raise ValueError("--prefill-chunk admits token prompts only: a frontend-stub "
                         "model serves through generate (no --prefill-chunk)")
    sched = RequestScheduler(server)
    for p in prompt:
        sched.submit(p, n_new)
    res = sched.run()
    return torch.stack([torch.as_tensor(res[r]) for r in sorted(res)])


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    mesh = None
    if args.mesh:
        data, model = parse_mesh(args.mesh)
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world != data * model:
            raise ValueError(f"--mesh {args.mesh} needs {data * model} ranks; "
                             f"WORLD_SIZE is {world} (start it with torchrun)")
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        init_distributed(device, world, int(os.environ.get("RANK", "0")))
        mesh = make_mesh(data, model)
    main_rank = mesh is None or mesh.rank == 0
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_cfg(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    capacity_factor, distance = 2.0, None
    if mesh is not None:
        capacity_factor, distance = mesh_plan(model)
    ctx = ParallelCtx(mesh=mesh, moe_impl=args.moe_impl, capacity_factor=capacity_factor,
                      use_kernels=parse_use_kernels(args.use_kernels))
    params = T.init_params(cfg, seed=args.seed, dtype=DTYPES[args.dtype], device=device)
    server = Server(cfg, ctx, params, serve_config(args), device=device,
                    distance=distance)
    stream = request_stream(cfg.vocab_size, args.requests, args.prompt_len, args.seed)
    if cfg.frontend_stub and main_rank:
        print(f"frontend stub: {cfg.frontend_tokens} random embeds a request, in "
              f"{args.dtype}")
    for i, prompt in zip(range(args.batches), stream):
        embeds = stub_embeds(cfg, args.requests, i, DTYPES[args.dtype], device)
        t0 = time.perf_counter()
        out = serve_batch(server, prompt, args.gen, embeds)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        if main_rank:
            print(
                f"batch {i}: generated {tuple(out.shape)} on {device} in {dt:.2f}s "
                f"({args.requests * args.gen / dt:.1f} tok/s), migrations so far: "
                f"{server.migrations}"
                + (f", mesh {args.mesh}" if mesh else "")
            )
    if mesh is not None:
        dist.destroy_process_group()
    if main_rank:
        print("done")


if __name__ == "__main__":
    main()
