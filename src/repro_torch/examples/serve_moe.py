"""Batched MoE serving with expert parallelism and the NI-Balancer active.

Needs 8 or more ranks for real EP: under ``torchrun`` the ranks form a
``(W // 4, 4)`` ``("data", "model")`` mesh (NCCL on the cards, gloo with
``--device cpu``), with the ER-Mapping hop distances of a 2 x 2 wafer
between the model ranks; with fewer it serves the no-mesh fallback. Rank 0
prints.

  PYTHONPATH=src python -m repro_torch.examples.serve_moe [--device cpu]
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.examples.serve_moe \
      --device cpu
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from repro_torch.core.topology import MeshTopology
from repro_torch.device import resolve_device
from repro_torch.examples import kernels, parser, smoke_model
from repro_torch.models import transformer as T
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.mesh import init_distributed, make_mesh
from repro_torch.runtime.data import request_stream
from repro_torch.runtime.elastic import drill_failure
from repro_torch.runtime.serve import ServeConfig, Server

MESH_RANKS = 8      # the fewest ranks that serve under the mesh
MODEL_AXIS = 4
N_NEW = 24


def main(argv=None, *, params=None, use_kernels=True) -> dict:
    """Serve three batches, then drill a failure where the balancer runs;
    returns each batch's output and seconds, the last batch's output, the
    migrations and the drill's report (None without a balancer). A world
    the caller initialised is joined as it is."""
    args = parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    joined = dist.is_initialized()
    n_dev = dist.get_world_size() if joined else int(os.environ.get("WORLD_SIZE", "1"))
    mesh = None
    if n_dev >= MESH_RANKS:
        if not joined:
            if device.type == "cuda":
                device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            init_distributed(device, n_dev, int(os.environ.get("RANK", "0")))
        mesh = make_mesh(n_dev // MODEL_AXIS, MODEL_AXIS)
        ctx = ParallelCtx(mesh=mesh, capacity_factor=4.0, use_kernels=kernels(use_kernels))
        topo = MeshTopology(2, 2)

        def distance(a, b):
            return topo.hops(topo.coord(a), topo.coord(b))
    else:
        print(f"only {n_dev} device(s) — running the dense fallback")
        ctx, distance = ParallelCtx(use_kernels=kernels(use_kernels)), None
    main_rank = mesh is None or mesh.rank == 0

    cfg = smoke_model("dbrx-132b", device, n_experts=8, experts_per_token=2)
    if params is None:
        params = T.init_params(cfg, seed=0, device=device)
    server = Server(
        cfg, ctx, params,
        ServeConfig(max_seq=128, batch=4, slots_per_device=3, alpha=0.3),
        distance=distance, device=device,
    )
    outs, seconds = [], []
    for i, prompt in zip(range(3), request_stream(cfg.vocab_size, 4, 12)):
        t0 = time.perf_counter()
        out = server.generate(prompt, N_NEW).cpu()
        dt = time.perf_counter() - t0
        outs.append(out)
        seconds.append(dt)
        if main_rank:
            print(
                f"batch {i}: {tuple(out.shape)} in {dt:.2f}s "
                f"({4 * N_NEW / dt:.1f} tok/s), migrations={server.migrations}"
            )
    drill = None
    if server.state is not None:
        drill = drill_failure(server, device=1)
        if main_rank:
            print("failure drill:", drill)
    result = {"outs": outs, "out": outs[-1], "seconds": seconds,
              "migrations": server.migrations, "drill": drill,
              "mesh": None if mesh is None else (mesh.data, mesh.model)}
    if mesh is not None and not joined:
        dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
