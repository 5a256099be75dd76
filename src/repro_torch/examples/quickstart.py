"""Quickstart: the three layers of the framework in one script.

1. The paper's core — map a WSC mesh with ER-Mapping, compare collectives
   (modelled times of the paper's wafer-scale platform, not of the card).
2. The model zoo — forward an assigned architecture (smoke scale).
3. The serving loop — batched generation with the NI-Balancer plumbing.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import torch

from repro_torch.core.comm_model import A2AWorkload, mesh_allreduce, mesh_alltoall
from repro_torch.core.er_mapping import baseline_mapping, er_mapping
from repro_torch.core.ftd import ftd_stats
from repro_torch.core.hardware import WSC
from repro_torch.core.topology import MeshTopology
from repro_torch.device import resolve_device
from repro_torch.examples import kernels, parser, smoke_model
from repro_torch.models import transformer as T
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.runtime.serve import ServeConfig, Server


def main(argv=None, *, params=None, use_kernels=True) -> dict:
    """Run the three parts; returns each mapping's figures, the forward's
    logits and aux loss, and the generated tokens."""
    args = parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. ER-Mapping on a 4x4 wafer --------------------------------------
    topo = MeshTopology(4, 4)
    core = {}
    for name, mapping in (
        ("baseline", baseline_mapping(topo, 4, 4)),
        ("er", er_mapping(topo, 4, 4)),
    ):
        stats = ftd_stats(mapping)
        ar = mesh_allreduce(mapping, WSC, 256 * 8192)
        a2a = mesh_alltoall(mapping, WSC, A2AWorkload(256, 8192, 8))
        core[name] = {"avg_hops": stats.avg_hops,
                      "intersections": stats.n_intersecting_pairs,
                      "allreduce_us": ar.time * 1e6, "alltoall_us": a2a.time * 1e6}
        print(
            f"[core] {name:8s} FTD hops={stats.avg_hops:.2f} "
            f"intersections={stats.n_intersecting_pairs}  "
            f"allreduce={ar.time * 1e6:.2f}us  alltoall={a2a.time * 1e6:.2f}us"
        )

    # --- 2. model zoo -------------------------------------------------------
    cfg = smoke_model("mixtral-8x22b", device)
    if params is None:
        params = T.init_params(cfg, seed=0, device=device)
    ctx = ParallelCtx(use_kernels=kernels(use_kernels))
    tokens = torch.ones((2, 16), dtype=torch.long, device=device)
    with torch.no_grad():
        logits, aux = T.forward(params, tokens, cfg, ctx)
    aux_loss = float(aux["loss"])
    print(f"[model] {cfg.name} smoke forward -> {tuple(logits.shape)}, aux={aux_loss:.3f}")

    # --- 3. serving -----------------------------------------------------------
    server = Server(cfg, ctx, params, ServeConfig(max_seq=64, batch=2), device=device)
    out = server.generate(torch.ones((2, 8), dtype=torch.long, device=device), 8).cpu()
    print(f"[serve] generated {tuple(out.shape)} tokens: {out[0].tolist()}")
    return {"core": core, "logits": logits, "aux": aux_loss, "tokens": out}


if __name__ == "__main__":
    main()
