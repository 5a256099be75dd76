"""Fig. 13(d): Hierarchical ER-Mapping on multi-WSC systems.

Flat ER rings spanning wafers pay the border repeatedly; HER decouples the
all-reduce into intra-wafer reduce-scatter + inter-wafer all-gather.

Copy of ``benchmarks/fig13d_her.py``; the same ``run()`` rows.
"""

from repro_torch.core.simulator import simulate_iteration
from repro_torch.core.workloads import DEEPSEEK_V3, QWEN3_235B
from repro_torch.figures.common import comm_us, row, wsc_system


def run():
    rows = []
    for model in (DEEPSEEK_V3, QWEN3_235B):
        for wafers, dp, tp in ((2, 8, 16), (4, 8, 32)):
            base = comm_us(
                simulate_iteration(
                    model,
                    wsc_system(8, 8, dp, tp, "baseline", n_wafers=wafers),
                    256,
                    tp,
                )
            )
            er = comm_us(
                simulate_iteration(
                    model, wsc_system(8, 8, dp, tp, "her", n_wafers=wafers), 256, tp
                )
            )
            her = comm_us(
                simulate_iteration(
                    model,
                    wsc_system(8, 8, dp, tp, "her", n_wafers=wafers, hier=True),
                    256,
                    tp,
                )
            )
            rows.append(
                row(
                    f"fig13d/{model.name}/{wafers}wafers",
                    her,
                    f"er_gain={1 - er / base:+.0%};her_gain={1 - her / base:+.0%}",
                )
            )
    return rows
