"""Fig. 15: run-time device-load traces under the four balancing regimes.

Reports the steady-state peak/mean device load, migration counts and
exposed interruption time over a mixed-scenario trace (8x8 WSC,
DeepSeek-V3).

Copy of ``benchmarks/fig15_load_traces.py``; the same ``run()`` rows.
"""

from repro_torch.core.simulator import run_serving_trace
from repro_torch.core.traces import mixed_scenario_trace
from repro_torch.core.workloads import DEEPSEEK_V3
from repro_torch.figures.common import row, wsc_system


def run():
    rows = []
    sys_ = wsc_system(8, 8, 8, 8, "er")
    trace = mixed_scenario_trace(256, 8192, 150, period=75, seed=0)
    for bal in ("none", "greedy", "topo", "topo_ni"):
        res = run_serving_trace(
            DEEPSEEK_V3, sys_, trace, 256, 8, balancer=bal, alpha=1.0
        )
        tail = res.peak_over_mean[-30:]
        rows.append(
            row(
                f"fig15/{bal}",
                float(res.iteration_times.mean() * 1e6),
                f"peak_over_mean={tail.mean():.2f};migs={res.migrations};"
                f"exposed_ms={res.exposed_overhead * 1e3:.2f}",
            )
        )
    return rows
