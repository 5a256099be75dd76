"""The ER-mapped mesh (``repro_torch.launch.mesh``, ``parallel.mesh``'s
``order`` and ``"pod"`` axis):

* ``mesh_order`` for baseline, er and her at 16 x 16 against the
  reference's ``MAPPINGS[m](MeshTopology(16, 16), 16, 16).device_order()``
  (the reference's ``test_er_mesh_device_permutation``), and every rank's
  logical coordinates read back through the order, pods included;
* the production and ER meshes over a fake world of 256 and 512 ranks
  (the dry run's), and the refusal of a world too small;
* one spawn of four gloo ranks serving dbrx-132b's ``smoke()`` with the
  NI-Balancer live on three 2 x 2 meshes: row-major, the ER order
  ``[[0, 2], [1, 3]]`` (``MAPPINGS["er"]`` on a 2 x 2 grid), and an
  order whose groups' ranks are out of order (``[[3, 0], [1, 2]]``, so
  the all-to-all, gather and send/recv go through the logical order):
  every rank's greedy tokens equal the JAX package's no-mesh Server's, and
  the three meshes' migration counts agree.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro.core.er_mapping import MAPPINGS as J_MAPPINGS
from repro.core.topology import MeshTopology as JMeshTopology
from repro_torch.core.er_mapping import MAPPINGS
from repro_torch.core.topology import MeshTopology
from repro_torch.launch.mesh import make_er_mesh, make_production_mesh, mesh_order
from repro_torch.parallel.mesh import Mesh, make_mesh

torch.set_num_threads(1)
SERVE = dict(max_seq=32, batch=4, slots_per_device=3)
N_NEW = 8
ORDERS = {"row-major": None, "er": [[0, 2], [1, 3]], "unsorted": [[3, 0], [1, 2]]}


@pytest.mark.parametrize("mapping", ("baseline", "er", "her"))
def test_mesh_order_matches_reference_device_order(mapping):
    want = np.asarray(J_MAPPINGS[mapping](JMeshTopology(16, 16), 16, 16).device_order())
    got = mesh_order(mapping)
    np.testing.assert_array_equal(got, want)
    assert sorted(got.ravel()) == list(range(256))
    if mapping == "er":
        assert not np.array_equal(got, np.arange(256).reshape(16, 16))


@pytest.mark.parametrize("pod", (1, 2))
def test_coordinates_read_the_order(pod):
    """Every rank of a (pod x) 16 x 16 ER mesh sits where the order puts
    it; the batch spans pod x data; the groups' logical orders."""
    order = mesh_order("er")
    for rank in range(pod * 256):
        m = Mesh(16, 16, rank, None, None, pod, order)
        assert m.global_rank(m.data_rank, m.model_rank) == rank
        assert order[m.data_rank, m.model_rank] == rank % 256
        assert m.pod_rank == rank // 256
        assert m.n_batch == 16 * pod
        assert m.batch_rank == m.pod_rank * 16 + m.data_rank
        members = [m.global_rank(m.data_rank, r) for r in range(16)]
        want = [sorted(members).index(x) for x in members]
        assert (m.model_order or list(range(16))) == want
    plain = Mesh(2, 4, 6, None, None)
    assert (plain.data_rank, plain.model_rank, plain.model_order, plain.batch_order) == (
        1, 2, None, None)
    assert MAPPINGS["er"](MeshTopology(2, 2), 2, 2).device_order().tolist() == ORDERS["er"]


@pytest.fixture
def fake_world():
    from repro_torch.launch import dryrun

    yield dryrun.fake_world
    if dist.is_initialized():
        dist.destroy_process_group()


def test_production_meshes_over_a_fake_world(fake_world):
    fake_world(256)
    m = make_er_mesh()
    assert (m.pod, m.data, m.model, m.n_batch) == (1, 16, 16, 16)
    np.testing.assert_array_equal(m.pod_order, mesh_order("er"))
    assert m.pod_group is None
    assert make_production_mesh().order is None
    with pytest.raises(ValueError, match="need 512 ranks, have 256"):
        make_er_mesh(multi_pod=True)
    fake_world(512)
    m = make_er_mesh(multi_pod=True, mapping="her")
    assert (m.pod, m.n_batch, dist.get_world_size(m.data_group),
            dist.get_world_size(m.pod_group), dist.get_world_size(m.model_group)) == (
        2, 32, 32, 2, 16)
    with pytest.raises(ValueError, match="permutation"):
        make_mesh(16, 32, order=np.zeros((16, 32), int))


def _rank_main(rank, init_file, params_file, out_dir):
    """One gloo rank: the smoke model served on each mesh order."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config, smoke
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.runtime.serve import ServeConfig, Server

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=4,
                            rank=rank)
    cfg = smoke(get_config("dbrx-132b"))
    flat = dict(np.load(params_file))
    prompt = torch.tensor(flat.pop("prompt")).long()
    params = {}
    for key, val in flat.items():
        node = params
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    out = {}
    for name, order in ORDERS.items():
        mesh = make_mesh(2, 2, order=order)
        srv = Server(cfg, ParallelCtx(mesh=mesh, capacity_factor=8.0),
                     params_from_numpy(params), ServeConfig(alpha=0.1, **SERVE), device="cpu")
        out[f"{name}/tokens"] = srv.generate(prompt, N_NEW).numpy()
        out[f"{name}/migrations"] = np.asarray(srv.migrations)
        out[f"{name}/coords"] = np.asarray([mesh.data_rank, mesh.model_rank])
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def test_er_mesh_serves_the_no_mesh_tokens(tmp_path):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.configs import smoke as jsmoke
    from repro.models import transformer as JT
    from repro.parallel.ctx import ParallelCtx as JCtx
    from repro.runtime.serve import ServeConfig as JServeConfig
    from repro.runtime.serve import Server as JServer

    jcfg = jsmoke(jget("dbrx-132b"))
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    prompt = np.random.default_rng(0).integers(0, 256, (SERVE["batch"], 8)).astype(np.int32)
    srv = JServer(jcfg, JCtx(capacity_factor=8.0), jax.tree.map(jnp.copy, jparams),
                  JServeConfig(**SERVE))
    want = np.asarray(srv.generate(jnp.asarray(prompt), N_NEW))
    flat = {"/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    np.savez(tmp_path / "params.npz", prompt=prompt, **flat)
    tmp.spawn(_rank_main, args=(str(tmp_path / "pg"), str(tmp_path / "params.npz"),
                                str(tmp_path)), nprocs=4, join=True)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    migs = {name: int(ranks[0][f"{name}/migrations"]) for name in ORDERS}
    assert len(set(migs.values())) == 1 and migs["er"] > 0, migs
    for name, order in ORDERS.items():
        layout = np.arange(4).reshape(2, 2) if order is None else np.asarray(order)
        for rank, r in enumerate(ranks):
            np.testing.assert_array_equal(r[f"{name}/tokens"], want, err_msg=f"{name} {rank}")
            assert int(r[f"{name}/migrations"]) == migs[name]
            g, m = r[f"{name}/coords"]
            assert layout[g, m] == rank
