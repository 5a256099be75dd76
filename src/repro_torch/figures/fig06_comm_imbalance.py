"""Fig. 6: all-to-all latency surges with scale while all-reduce stays flat.

Sweeps WSC scale from a single 4x4 to a 2-wafer 8x8 system and reports the
two collectives' latencies for a fixed per-group token count.

Copy of ``benchmarks/fig06_comm_imbalance.py``; the same ``run()`` rows.
"""

from repro_torch.core.simulator import simulate_iteration
from repro_torch.core.workloads import DEEPSEEK_V3
from repro_torch.figures.common import row, wsc_system


def run():
    rows = []
    cases = [
        ("4x4", 4, 4, 4, 4, 1),
        ("6x6", 6, 6, 6, 6, 1),
        ("8x8", 8, 8, 8, 8, 1),
        ("2x(8x8)", 8, 8, 8, 16, 2),
    ]
    for name, r, c, dp, tp, wafers in cases:
        sys_ = wsc_system(r, c, dp, tp, "baseline", n_wafers=wafers)
        bd = simulate_iteration(DEEPSEEK_V3, sys_, 256, tp)
        ar, a2a = bd.allreduce * 1e6, bd.alltoall * 1e6
        rows.append(
            row(f"fig06/{name}/allreduce", ar, f"ratio_a2a_over_ar={a2a / ar:.2f}")
        )
        rows.append(row(f"fig06/{name}/alltoall", a2a, f"devices={r * c * wafers}"))
    return rows
