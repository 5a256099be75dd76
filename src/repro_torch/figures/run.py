"""Print the paper's figures from the analytic model as CSV.

    PYTHONPATH=src python -m repro_torch.figures.run [names...]

prints ``name,us_per_call,derived``, one row per point, the rows of the
reference's ``python -m benchmarks.run``; each argument selects the modules
whose name contains it. The times are outputs of the analytic model for the
paper's platforms (``repro_torch.core.hardware``), not measurements;
``roofline``'s are model output at H100 datasheet constants over the dry
run's records (``results/torch/dryrun``; no rows before a dry run). A
figure that raises stops the run with its traceback and a non-zero exit,
where the reference's runner prints an ``ERROR`` row and goes on; an
argument that selects no module is refused.
"""

from __future__ import annotations

import importlib
import sys
import time

MODULES = [
    "fig06_comm_imbalance",
    "fig13a_token_count",
    "fig13b_models",
    "fig13c_scale_parallelism",
    "fig13d_her",
    "fig14a_esp",
    "fig14b_allgather",
    "fig15_load_traces",
    "fig16_balancers",
    "fig17_nvl72",
    "roofline",
]


def select(only: list[str]) -> list[str]:
    """The modules whose name contains one of ``only`` (all if empty)."""
    for o in only:
        if not any(o in m for m in MODULES):
            raise ValueError(f"{o!r} selects no figure of {MODULES}")
    return [m for m in MODULES if not only or any(o in m for o in only)]


def main(argv: list[str] | None = None) -> int:
    names = select(sys.argv[1:] if argv is None else argv)
    print("name,us_per_call,derived")
    for modname in names:
        mod = importlib.import_module(f"repro_torch.figures.{modname}")
        t0 = time.time()
        rows = mod.run()
        for r in rows:
            print(f"{r['name']},{r['us_per_call']},{r['derived']}")
        print(f"# {modname}: {len(rows)} rows in {time.time() - t0:.1f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
