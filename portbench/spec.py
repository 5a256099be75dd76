"""``BENCHMARK.json`` and the files it names, found by name."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` off) or per-layer metrics
    (on): every metric of the kind without a ``workloads`` key, and those
    whose key names the cell."""
    kind = bench["per_layer" if trace else "end_to_end"]
    return [m for m in kind if workload in m.get("workloads", [workload])]


def reader(name: str):
    """``metrics/<name>.py``'s ``read(run) -> float | None``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
