"""Fig. 13(a): WSC-over-DGX communication advantage vs token count.

6x6 wafer vs 4-node DGX (32 GPUs) and 8x8 wafer vs 8-node DGX, sweeping
tokens per TP group; reports WSC gain and the additional ER-Mapping gain.

Copy of ``benchmarks/fig13a_token_count.py``; the same ``run()`` rows.
"""

from repro_torch.core.simulator import simulate_iteration
from repro_torch.core.workloads import QWEN3_235B
from repro_torch.figures.common import comm_us, dgx_system, row, wsc_system


def run():
    rows = []
    for wafer, dgx_n, dp, tp in ((6, 32, 6, 6), (8, 64, 8, 8)):
        for tokens in (32, 64, 128, 256, 512, 1024):
            dgx = comm_us(
                simulate_iteration(QWEN3_235B, dgx_system(dgx_n), tokens, 8)
            )
            base = comm_us(
                simulate_iteration(
                    QWEN3_235B, wsc_system(wafer, wafer, dp, tp, "baseline"),
                    tokens, tp,
                )
            )
            er = comm_us(
                simulate_iteration(
                    QWEN3_235B, wsc_system(wafer, wafer, dp, tp, "er"), tokens, tp
                )
            )
            rows.append(
                row(
                    f"fig13a/{wafer}x{wafer}/tokens{tokens}",
                    er,
                    f"wsc_gain={1 - base / dgx:+.0%};er_gain={1 - er / dgx:+.0%}",
                )
            )
    return rows
