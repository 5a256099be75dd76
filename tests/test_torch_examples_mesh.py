"""``serve_moe``'s mesh branch on the CPU: the port's example on 8 gloo
ranks (a 2 x 4 ``("data", "model")`` mesh, one spawn) against the
reference's script on 8 forced host devices (``(2, 4)`` mesh), with the
script's own parameters bridged to every rank.

Each batch's shape, the last batch's tokens (on every rank) and the
migrations equal the reference's; the failure drill's report equals the
one it prints, floats within 1e-6; rank 0 prints the reference's lines,
wall-clock fields aside. The ranks meet through a file in the test's
temporary directory and bound every collective with a timeout.
"""

import ast
import datetime

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from torch_examples_ref import finish, lines, run_port, start_reference, tree

torch.set_num_threads(1)
RANKS, DATA, MODEL = 8, 2, 4
SPECS = {"serve_moe": {"params": "params", "out": "out",
                       "migrations": "server.migrations"}}


def _rank_main(rank, init_file, ref_path, out_dir):
    import torch.distributed as dist

    from repro_torch.bridge import params_from_numpy
    from repro_torch.examples import serve_moe

    torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=120)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=RANKS, rank=rank, timeout=timeout)
    params = params_from_numpy(tree(dict(np.load(ref_path)), "serve_moe/params/"))
    res, text = run_port(serve_moe.main, ["--device", "cpu"], params=params)
    np.savez(f"{out_dir}/rank{rank}.npz", out=res["out"].numpy(),
             shapes=np.asarray([tuple(o.shape) for o in res["outs"]]),
             migrations=res["migrations"], mesh=np.asarray(res["mesh"]),
             drill=np.asarray(repr(res["drill"])), stdout=np.asarray(text))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("examples_mesh")
    ref_path = base / "ref.npz"
    ref = finish(start_reference(SPECS, ref_path, devices=RANKS), ref_path)
    tmp.spawn(_rank_main, args=(str(base / "pg"), str(ref_path), str(base)),
              nprocs=RANKS, join=True)
    return ref, [dict(np.load(base / f"rank{r}.npz")) for r in range(RANKS)]


def _drill(text: str) -> dict:
    line = next(x for x in text.splitlines() if x.startswith("failure drill: "))
    return ast.literal_eval(line[len("failure drill: "):])


def test_mesh_tokens_and_migrations(runs):
    ref, port = runs
    for r in port:
        assert tuple(r["mesh"]) == (DATA, MODEL)
        assert r["shapes"].tolist() == [[4, 24]] * 3
        np.testing.assert_array_equal(r["out"], ref["serve_moe/out"])
        assert int(r["migrations"]) == int(ref["serve_moe/migrations"]) > 0


def test_mesh_failure_drill(runs):
    """The drill's report on every rank: keys, counts and flags equal, the
    peak heats within 1e-6."""
    ref, port = runs
    want = _drill(str(ref["serve_moe/stdout"]))
    assert want["supported"]
    for r in port:
        got = ast.literal_eval(str(r["drill"]))
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, float):
                assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-6), k
            else:
                assert got[k] == v, k


def test_mesh_prints_the_reference_lines(runs):
    """Rank 0 prints the reference's lines; the other ranks print none."""
    ref, port = runs
    assert lines(str(port[0]["stdout"])) == lines(str(ref["serve_moe/stdout"]))
    assert all(not str(r["stdout"]) for r in port[1:])
