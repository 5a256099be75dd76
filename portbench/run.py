"""Run one cell of ``BENCHMARK.json`` once, on the card:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON object; the numbers the comparison read, each beside its
limit, are the last lines of standard error. Exits non-zero, printing no
result, without a CUDA device, with fewer devices than the cell asks for,
or when JAX, Flax or the JAX package is loaded once the window has
closed. The checkout's ``src`` is put on the path, as the repository's
entry points run with ``PYTHONPATH=src``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from portbench import harness, spec

    bench = spec.load(ROOT)
    chips = spec.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"refused: the cell needs {chips} CUDA device(s), found {n}")
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START, device="cuda", bench=bench)
    found = harness.banned_modules()
    if found:
        harness.log(f"refused: modules loaded in the process: {found}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
