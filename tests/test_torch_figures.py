"""The port's paper figures (``repro_torch.figures``) against the
reference's ``benchmarks/`` scripts: each figure's ``run()`` returns the
same rows, name, ``us_per_call`` and ``derived`` string alike.

Both sides are the same numpy arithmetic on the same constants, so the
rows must be equal, not close: a difference is a fault of the copy. The
figures that drive the serving simulator over a load trace (fig15-17, most
of the time) are in ``tests/test_torch_figures_traces.py``."""

import importlib
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))   # the reference's benchmarks/ is not a package

FIGURES = ["fig06_comm_imbalance", "fig13a_token_count", "fig13b_models",
           "fig13c_scale_parallelism", "fig13d_her", "fig14a_esp", "fig14b_allgather"]


def same_rows(name: str) -> list[dict]:
    rows = importlib.import_module(f"repro_torch.figures.{name}").run()
    want = importlib.import_module(f"benchmarks.{name}").run()
    assert rows == want
    assert rows and all(set(r) == {"name", "us_per_call", "derived"} for r in rows)
    return rows


@pytest.mark.parametrize("name", FIGURES)
def test_figure_rows_equal_reference(name):
    same_rows(name)


def test_runner_lists_every_reference_figure():
    """The runner's modules are the reference's, ``roofline`` (over the
    dry run's records) included."""
    from repro_torch.figures import run

    ref = importlib.import_module("benchmarks.run").MODULES
    assert run.MODULES == ref
    assert run.select(["fig13"]) == [m for m in run.MODULES if "fig13" in m]
    assert run.select(["roofline"]) == ["roofline"]
    with pytest.raises(ValueError, match="fig99"):
        run.select(["fig99"])
