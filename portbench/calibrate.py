"""Readings for the limits of ``correct``: the program's numbers and the
fp8 control's over many seeds in one process, at a cell's own sizes and
load (the kernels built and loaded once):

    python -m portbench.calibrate --workload <cell> --seeds 1,2,3 --seconds 6

Prints one JSON line per seed. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--plain", action="store_true",
                    help="serve on the program's plain PyTorch path (use_kernels=False): "
                         "the second witness of the widest gap (PERF.md, section 4)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from portbench import harness, spec

    if not torch.cuda.is_available():
        harness.log("refused: no CUDA device")
        return 2
    bench = spec.load(ROOT)
    config = spec.config(bench, spec.cell(bench, args.workload)["config"])
    if args.plain:
        config["parallel"]["use_kernels"] = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run_cell(args.workload, seed, args.seconds, False, t_start=t0,
                               bench=bench, config=config, control=True)
        line = {"workload": args.workload, "seed": seed, "plain": args.plain,
                "correct": res["correct"],
                **res["readings"], "seconds": time.perf_counter() - t0,
                "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
