"""The port's trace-driven figures (fig15-17: the serving simulator over a
load trace, under each balancer) against the reference's ``benchmarks/``
scripts, row for row and exactly, as in ``tests/test_torch_figures.py``;
a file of their own so that their minute runs beside the other figures."""

import pytest

from test_torch_figures import same_rows


@pytest.mark.parametrize("name", ["fig15_load_traces", "fig16_balancers", "fig17_nvl72"])
def test_figure_rows_equal_reference(name):
    rows = same_rows(name)
    if name != "fig17_nvl72":
        assert any("migs=0" not in r["derived"] for r in rows)
