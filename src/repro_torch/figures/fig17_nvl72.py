"""Fig. 17: multi-WSC cluster (4x 8x8 wafers = 256 devices) vs NVL72.

The paper's headline ablation ladder: baseline mapping -> +ER -> +HER ->
+topology-aware balancing -> +non-invasive balancing; compared against
NVL72 per-device MoE performance (EP=72, NVMe-hidden migration).

Copy of ``benchmarks/fig17_nvl72.py``; the same ``run()`` rows.
"""

from repro_torch.core.simulator import run_serving_trace
from repro_torch.core.traces import mixed_scenario_trace
from repro_torch.core.workloads import DEEPSEEK_V3
from repro_torch.figures.common import nvl72_system, row, wsc_system


def _perf_per_device(res, n_devices, tokens_iter):
    """Tokens/s/device over the trace."""
    return tokens_iter / res.iteration_times.mean() / n_devices


def run():
    rows = []
    model = DEEPSEEK_V3
    trace = mixed_scenario_trace(model.n_experts, 8192, 80, period=40, seed=0)
    tokens_iter = 256 * 8  # dp * tokens_per_group

    nvl = run_serving_trace(
        model, nvl72_system(tp=8), trace, 256, 8, balancer="greedy", alpha=1.0
    )
    nvl_perf = _perf_per_device(nvl, 72, 256 * 9)
    rows.append(
        row("fig17/nvl72+balancing", float(nvl.iteration_times.mean() * 1e6),
            f"per_device_tok_s={nvl_perf:.0f}")
    )

    ladder = [
        ("baseline", dict(mapping="her", hier=False), "none"),
        ("+er", dict(mapping="her", hier=False), "none"),
        ("+her", dict(mapping="her", hier=True), "none"),
        ("+topo_balance", dict(mapping="her", hier=True), "topo"),
        ("+ni_balance", dict(mapping="her", hier=True), "topo_ni"),
    ]
    for i, (name, kw, bal) in enumerate(ladder):
        mapping = "baseline" if name == "baseline" else kw["mapping"]
        sys_ = wsc_system(8, 8, 8, 32, mapping, n_wafers=4, hier=kw["hier"])
        res = run_serving_trace(
            model, sys_, trace, 256, 32, balancer=bal, alpha=1.0
        )
        perf = _perf_per_device(res, 256, tokens_iter * 4)
        rows.append(
            row(
                f"fig17/wsc/{name}",
                float(res.iteration_times.mean() * 1e6),
                f"per_device_tok_s={perf:.0f};vs_nvl72={perf / nvl_perf - 1:+.0%}",
            )
        )
    return rows
