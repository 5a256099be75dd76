"""Fig. 13(b): ER-Mapping communication gains across the five MoE models
(6x6 WSC vs 4-node DGX; balanced loads, 256 tokens per group).

Copy of ``benchmarks/fig13b_models.py``; the same ``run()`` rows.
"""

from repro_torch.core.simulator import simulate_iteration
from repro_torch.core.workloads import PAPER_MODELS
from repro_torch.figures.common import comm_us, dgx_system, row, wsc_system


def run():
    rows = []
    for name, model in PAPER_MODELS.items():
        dgx = comm_us(simulate_iteration(model, dgx_system(32), 256, 8))
        base = comm_us(
            simulate_iteration(model, wsc_system(6, 6, 6, 6, "baseline"), 256, 6)
        )
        er = comm_us(
            simulate_iteration(model, wsc_system(6, 6, 6, 6, "er"), 256, 6)
        )
        rows.append(
            row(
                f"fig13b/{name}",
                er,
                f"wsc_vs_dgx={1 - base / dgx:+.0%};er_vs_base={1 - er / base:+.0%}",
            )
        )
    return rows
