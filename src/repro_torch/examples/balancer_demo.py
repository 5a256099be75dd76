"""NI-Balancer walkthrough on the analytical evaluator: watch the load trace
drift, the Eq. 2 trigger fire, Algorithm 1 plan migrations, and the
Local/Global steps drain over cold links — zero exposed latency.

Run:  PYTHONPATH=src python -m repro_torch.examples.balancer_demo [--device cpu]

Numpy on the host: no kernel and no tensor on the device. Every time it
prints is a modelled time of the paper's wafer-scale platform, not of the
card. The device is resolved as by every entry point of the port (the card
unless ``--device cpu``).
"""

from __future__ import annotations

from repro_torch.core.comm_model import A2AWorkload, link_heatmaps
from repro_torch.core.er_mapping import er_mapping
from repro_torch.core.hardware import WSC
from repro_torch.core.migration import decompose
from repro_torch.core.simulator import WSCSystem, run_serving_trace
from repro_torch.core.topology import MeshTopology
from repro_torch.core.traces import mixed_scenario_trace
from repro_torch.core.workloads import DEEPSEEK_V3
from repro_torch.device import resolve_device
from repro_torch.examples import parser

POLICIES = ("none", "greedy", "topo", "topo_ni")


def main(argv=None, *, params=None, use_kernels=True) -> dict:
    """Print the walkthrough; returns the idle links, the migration's
    steps and each policy's figures. ``params`` and ``use_kernels`` are
    accepted for a uniform signature: nothing here has either."""
    args = parser(__doc__).parse_args(argv)
    resolve_device(args.device)
    topo = MeshTopology(4, 4)
    mapping = er_mapping(topo, 4, 4)
    sys_ = WSCSystem(WSC, mapping)

    # 1. hot/cold links are complementary (the NI-Balancer's opportunity)
    _, a2a = link_heatmaps(mapping, WSC, 256 * 8192 * 2, A2AWorkload(256, 8192, 8))
    idle = int((a2a == 0).sum())
    print(f"links idle during all-to-all: {idle}/{topo.n_links}")

    # 2. decompose one long migration into Local -> Global -> Local steps
    mig = (0, mapping.ftds[0][0], mapping.ftds[3][3])
    steps = [(s.kind, s.src, s.dst) for s in decompose(mig, mapping, 42e6)]
    print("migration steps:", steps)

    # 3. the full serving loop, all four policies
    trace = mixed_scenario_trace(256, 2048, 100, period=50, seed=0)
    policies = {}
    for bal in POLICIES:
        res = run_serving_trace(DEEPSEEK_V3, sys_, trace, 256, 4, balancer=bal, alpha=1.0)
        policies[bal] = {
            "iter_ms": float(res.iteration_times.mean() * 1e3),
            "peak_over_mean": float(res.peak_over_mean[-20:].mean()),
            "migrations": int(res.migrations),
            "exposed_ms": float(res.exposed_overhead * 1e3),
        }
        p = policies[bal]
        print(
            f"{bal:8s} iter={p['iter_ms']:.2f}ms  "
            f"peak/mean={p['peak_over_mean']:.2f}  "
            f"migrations={p['migrations']}  exposed={p['exposed_ms']:.2f}ms"
        )
    return {"idle_links": idle, "n_links": topo.n_links, "steps": steps,
            "policies": policies}


if __name__ == "__main__":
    main()
