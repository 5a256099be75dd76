"""Fig. 14(a): ESP (expert-sharding parallelism) for few-large-expert
models (DBRX 16e, Mixtral 8e) — all-to-all is eliminated; the EP-group
all-reduce dominates; ER still helps but less.

Copy of ``benchmarks/fig14a_esp.py``; the same ``run()`` rows.
"""

from repro_torch.core.simulator import simulate_iteration
from repro_torch.core.workloads import DBRX, MIXTRAL_8X22B
from repro_torch.figures.common import comm_us, dgx_system, row, wsc_system


def run():
    rows = []
    for model in (DBRX, MIXTRAL_8X22B):
        dgx = comm_us(simulate_iteration(model, dgx_system(32), 256, 8))
        base = comm_us(
            simulate_iteration(model, wsc_system(6, 6, 6, 6, "baseline"), 256, 6)
        )
        er = comm_us(
            simulate_iteration(model, wsc_system(6, 6, 6, 6, "er"), 256, 6)
        )
        rows.append(
            row(
                f"fig14a/{model.name}",
                er,
                f"wsc_vs_dgx={1 - base / dgx:+.0%};er_vs_base={1 - er / base:+.0%}",
            )
        )
    return rows
