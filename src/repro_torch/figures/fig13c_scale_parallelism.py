"""Fig. 13(c): ER-Mapping gain across WSC scales and TP degrees (Qwen3).

Copy of ``benchmarks/fig13c_scale_parallelism.py``; the same ``run()`` rows.
"""

from repro_torch.core.simulator import simulate_iteration
from repro_torch.core.workloads import QWEN3_235B
from repro_torch.figures.common import comm_us, row, wsc_system


def run():
    rows = []
    cases = [
        (4, 4, 4, 4), (4, 4, 2, 8),
        (6, 6, 6, 6), (6, 6, 4, 9), (6, 6, 9, 4),
        (8, 8, 8, 8), (8, 8, 4, 16), (8, 8, 16, 4),
    ]
    for r, c, dp, tp in cases:
        base = comm_us(
            simulate_iteration(
                QWEN3_235B, wsc_system(r, c, dp, tp, "baseline"), 256, tp
            )
        )
        er = comm_us(
            simulate_iteration(QWEN3_235B, wsc_system(r, c, dp, tp, "er"), 256, tp)
        )
        rows.append(
            row(
                f"fig13c/{r}x{c}/dp{dp}xtp{tp}",
                er,
                f"er_gain={1 - er / base:+.0%}",
            )
        )
    return rows
