"""Fig. 16: balancing strategies across serving scenarios.

Single-scenario (math-only: ratios stabilize, few migrations) vs mixed
(cyclic drift: continuous rebalancing). Reports mean iteration time,
MoE-compute reduction vs no balancing, and exposed migration overhead.

Copy of ``benchmarks/fig16_balancers.py``; the same ``run()`` rows.
"""

from repro_torch.core.simulator import run_serving_trace
from repro_torch.core.traces import mixed_scenario_trace, single_scenario_trace
from repro_torch.core.workloads import DEEPSEEK_V3
from repro_torch.figures.common import row, wsc_system


def run():
    rows = []
    sys_ = wsc_system(8, 8, 8, 8, "er")
    scenarios = {
        "math_only": single_scenario_trace(256, 8192, 120, "math", seed=0),
        "mixed": mixed_scenario_trace(256, 8192, 120, period=60, seed=0),
    }
    for sname, trace in scenarios.items():
        base = run_serving_trace(
            DEEPSEEK_V3, sys_, trace, 256, 8, balancer="none"
        )
        moe_base = base.breakdown_last.moe_compute
        for bal in ("greedy", "topo", "topo_ni"):
            res = run_serving_trace(
                DEEPSEEK_V3, sys_, trace, 256, 8, balancer=bal, alpha=1.0
            )
            moe_gain = 1 - res.breakdown_last.moe_compute / moe_base
            rows.append(
                row(
                    f"fig16/{sname}/{bal}",
                    float(res.iteration_times.mean() * 1e6),
                    f"moe_compute_gain={moe_gain:+.0%};"
                    f"exposed_ms={res.exposed_overhead * 1e3:.2f};"
                    f"migs={res.migrations}",
                )
            )
    return rows
