"""The port's serve CLI plans as the reference CLI does: capacity factor
and ER-Mapping hop distance under a mesh, no virtual EP by default."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from repro.core.topology import MeshTopology as RefTopology
from repro_torch.launch import serve as cli


def _reference_plan(m: int):
    """``src/repro/launch/serve.py``'s mesh branch: capacity 4.0 and the
    hop distance on MeshTopology(rows, m // rows)."""
    rows = int(np.sqrt(m)) if int(np.sqrt(m)) ** 2 == m else 1
    topo = RefTopology(rows, m // rows)
    return 4.0, lambda a, b: topo.hops(topo.coord(a), topo.coord(b))


@pytest.mark.parametrize("m", [2, 4, 8, 16])
def test_mesh_plan_matches_reference(m):
    cap, dist = cli.mesh_plan(m)
    ref_cap, ref_dist = _reference_plan(m)
    assert cap == ref_cap
    for a, b in itertools.product(range(m), repeat=2):
        assert dist(a, b) == ref_dist(a, b), (m, a, b)


def test_mesh_plan_square_axis_hops():
    _, dist = cli.mesh_plan(4)
    # a 2 x 2 grid: the diagonals are two hops, not |a - b|
    assert dist(0, 3) == 2 and dist(1, 2) == 2
    assert dist(0, 1) == 1 and dist(0, 2) == 1


def test_default_parse_serves_without_virtual_ep():
    args = cli.parse_args(["--arch", "dbrx-132b", "--smoke"])
    assert args.virtual_ep is None
    assert cli.serve_config(args).virtual_ep is None
    args = cli.parse_args(["--arch", "dbrx-132b", "--smoke", "--virtual-ep", "4"])
    assert cli.serve_config(args).virtual_ep == 4
