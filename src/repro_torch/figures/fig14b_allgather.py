"""Fig. 14(b): justification for retaining the all-gather phase.

Dropping AG halves the all-reduce but forces all-to-all fetches from
scattered reduce-scatter owners: longer paths, more congestion. Retaining
AG should come out ahead overall (paper: +17% average).

Copy of ``benchmarks/fig14b_allgather.py``; the same ``run()`` rows.
"""

from repro_torch.core import comm_model as cm
from repro_torch.core.hardware import WSC
from repro_torch.core.workloads import DEEPSEEK_V3, QWEN3_235B
from repro_torch.figures.common import row, wsc_system


def run():
    rows = []
    for model in (DEEPSEEK_V3, QWEN3_235B):
        for r, c, dp, tp in ((6, 6, 6, 6), (8, 8, 8, 8)):
            sys_ = wsc_system(r, c, dp, tp, "er")
            m = sys_.mapping
            b = 256 * model.token_bytes
            wl = cm.A2AWorkload(256, model.token_bytes, model.topk)
            with_ag = (
                cm.mesh_allreduce(m, WSC, b, retain_ag=True).time
                + cm.mesh_alltoall(m, WSC, wl, retain_ag=True).time
            )
            no_ag = (
                cm.mesh_allreduce(m, WSC, b, retain_ag=False).time
                + cm.mesh_alltoall(m, WSC, wl, retain_ag=False).time
            )
            rows.append(
                row(
                    f"fig14b/{model.name}/{r}x{c}",
                    with_ag * 1e6,
                    f"no_ag_us={no_ag * 1e6:.1f};retain_gain={1 - with_ag / no_ag:+.0%}",
                )
            )
    return rows
