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


def test_prefill_chunk_serves_through_the_scheduler():
    """``--prefill-chunk`` admits each batch's requests a chunk a tick
    through the ``RequestScheduler``: the same greedy tokens as
    ``generate``'s splice admission (fp32, the plain path)."""
    import torch

    from repro_torch.configs import get_config, smoke
    from repro_torch.models import transformer as T
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.serve import Server

    base = ["--arch", "dbrx-132b", "--smoke", "--device", "cpu", "--virtual-ep", "4",
            "--slots", "3", "--paged", "--page-size", "8", "--max-seq", "32"]
    args = cli.parse_args(base + ["--prefill-chunk", "8"])
    assert cli.serve_config(args).prefill_chunk == 8
    cfg = smoke(get_config("dbrx-132b"))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 12)).astype(np.int32)
    out = {}
    for name, argv in (("splice", base), ("chunked", base + ["--prefill-chunk", "8"])):
        srv = Server(cfg, ParallelCtx(capacity_factor=8.0),
                     T.init_params(cfg, seed=0, device="cpu"),
                     cli.serve_config(cli.parse_args(argv)), device="cpu")
        out[name] = cli.serve_batch(srv, prompt, 6)
    assert out["chunked"].shape == (4, 6)
    assert torch.equal(out["chunked"], out["splice"].cpu())
