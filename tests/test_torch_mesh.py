"""The port's mesh path in this process, on a 1 x 1 mesh over a gloo world
of one, against the JAX package on ``make_mesh_compat((1, 1), ...)``: the
path the card runs (``seq_parallel_decode_attend`` on the partials mode,
the LSE merge through a real collective, ``ep_moe_shardmap``'s all-to-all
legs), on bridged weights and random prompts, fp32. Prefill and decode
logits within 1e-5; ``Server.generate`` greedy tokens equal to the
reference's, with the plain versions of the kernels and with the plain
path, with the NI-Balancer live on virtual EP (the same migrations) and
without it. Four ranks: ``tests/test_torch_mesh_ranks.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.launch.mesh import make_mesh_compat
from repro.models import transformer as JT
from repro.parallel.ctx import ParallelCtx as JCtx
from repro.runtime.serve import ServeConfig as JServeConfig
from repro.runtime.serve import Server as JServer
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke
from repro_torch.models import transformer as T
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.mesh import make_mesh
from repro_torch.runtime.serve import ServeConfig, Server

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
CFG = smoke(get_config("dbrx-132b"))
JCFG = jsmoke(jget("dbrx-132b"))


@pytest.fixture(scope="module")
def jparams():
    return JT.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture
def mesh(tmp_path):
    """A 1 x 1 mesh over a gloo world of one in this process, torn down
    after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    yield make_mesh(1, 1)
    dist.destroy_process_group()


def _bridge(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _prompt(seed, b=4, s=8):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("use_kernels", ["auto", False])
def test_prefill_and_decode_logits_match_reference(jparams, mesh, use_kernels):
    """The rank's dense cache (all its slots here) is filled and read the
    reference's way: logits of the prefill and of three decode steps."""
    jmesh = make_mesh_compat((1, 1), ("data", "model"))
    jctx = JCtx(mesh=jmesh, capacity_factor=8.0)
    ctx = ParallelCtx(mesh=mesh, capacity_factor=8.0, use_kernels=use_kernels)
    tokens = _prompt(0)
    with jmesh:
        jlog, jcache = JT.prefill(jparams, jnp.asarray(tokens), JCFG, jctx, max_seq=16)
    params = _bridge(jparams)
    log, cache = T.prefill(params, torch.tensor(tokens), CFG, ctx, max_seq=16)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    tok = np.asarray(jnp.argmax(jlog[:, -1:], -1)).astype(np.int32)
    for _ in range(3):
        with jmesh:
            jlog, jcache, _ = JT.decode_step(jparams, jnp.asarray(tok), jcache, JCFG, jctx)
        log, cache, _ = T.decode_step(params, torch.tensor(tok), cache, CFG, ctx)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
        tok = np.asarray(jnp.argmax(jlog[:, -1:], -1)).astype(np.int32)
    np.testing.assert_allclose(cache["layers"]["k"].numpy(), np.asarray(jcache["layers"]["k"]),
                               **TOL)


@pytest.mark.parametrize("virtual_ep", [None, 4])
def test_server_generate_matches_reference(jparams, mesh, virtual_ep):
    """Greedy tokens equal to the reference Server's on the 1 x 1 mesh,
    with the kernels' plain versions (``auto`` on CPU tensors) and with the
    plain path; on virtual EP the balancer migrates as often as the
    reference's does."""
    jmesh = make_mesh_compat((1, 1), ("data", "model"))
    prompt = _prompt(1)
    kw = dict(max_seq=32, batch=4, slots_per_device=3, alpha=0.1, virtual_ep=virtual_ep)
    with jmesh:
        jsrv = JServer(JCFG, JCtx(mesh=jmesh, capacity_factor=8.0),
                       jax.tree.map(jnp.copy, jparams), JServeConfig(**kw))
        want = np.asarray(jsrv.generate(jnp.asarray(prompt), 10))
    for uk in ("auto", False):
        srv = Server(CFG, ParallelCtx(mesh=mesh, capacity_factor=8.0, use_kernels=uk),
                     _bridge(jparams), ServeConfig(**kw), device="cpu")
        got = srv.generate(torch.tensor(prompt), 10).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"use_kernels={uk}")
        assert srv.migrations == jsrv.migrations
    if virtual_ep:
        assert jsrv.migrations > 0


def test_unported_mesh_layouts_raise(jparams, mesh):
    """ESP under the mesh, once refused here, now serves: ``T.prefill`` and
    three decode steps through ``esp_expert_ffn`` (the ragged pair's plain
    versions, the reduce-scatter over a group of one) give the reference's
    logits on the same 1 x 1 mesh within 1e-5 (its einsum branch here, the
    kernels being off on its CPU), and so does the plain path. Four ranks:
    ``tests/test_torch_mesh_serve.py``."""
    jmesh = make_mesh_compat((1, 1), ("data", "model"))
    jctx = JCtx(mesh=jmesh, moe_impl="esp", capacity_factor=8.0)
    tokens = _prompt(2)
    with jmesh:
        jlog0, jcache0 = JT.prefill(jparams, jnp.asarray(tokens), JCFG, jctx, max_seq=16)
    params = _bridge(jparams)
    for uk in ("auto", False):
        ctx = ParallelCtx(mesh=mesh, moe_impl="esp", capacity_factor=8.0, use_kernels=uk)
        jlog, jcache = jlog0, jcache0
        log, cache = T.prefill(params, torch.tensor(tokens), CFG, ctx, max_seq=16)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
        for _ in range(3):
            tok = np.asarray(jnp.argmax(jlog[:, -1:], -1)).astype(np.int32)
            with jmesh:
                jlog, jcache, _ = JT.decode_step(jparams, jnp.asarray(tok), jcache, JCFG, jctx)
            log, cache, _ = T.decode_step(params, torch.tensor(tok), cache, CFG, ctx)
            np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)


def test_snapshot_under_mesh_round_trip(jparams, mesh, tmp_path):
    """A scheduler on the 1 x 1 mesh (chunked admission) crashes mid-stream
    at tick 3: the world checks its snapshot, rank 0 writes the file, and
    the scheduler restored from it on the mesh serves on. Every stream
    equals the uninterrupted mesh run's, fp32 bit for bit."""
    from repro_torch.runtime import faults as F
    from repro_torch.runtime import snapshot as S
    from repro_torch.runtime.scheduler import FINISHED, RequestScheduler

    ctx = ParallelCtx(mesh=mesh, capacity_factor=8.0)
    scfg = ServeConfig(max_seq=32, batch=2, paged=True, page_size=8, prefill_chunk=8)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, CFG.vocab_size, n).astype(np.int32) for n in (5, 11, 4)]

    def run(plan=None):
        sched = RequestScheduler(Server(CFG, ctx, _bridge(jparams), scfg, device="cpu"),
                                 faults=plan)
        for i, p in enumerate(prompts):
            sched.submit(p, max_new_tokens=5, arrival=i)
        return sched

    want = run().run()
    path = str(tmp_path / "snap.npz")
    plan = F.FaultPlan([F.Fault(step=3, kind=F.CRASH_RESTART, path=path)])
    with pytest.raises(F.SimulatedCrash) as ei:
        run(plan).run()
    assert ei.value.step == 3 and (tmp_path / "snap.npz").exists()
    restored = S.restore_scheduler(path, CFG, ctx, _bridge(jparams), faults=plan,
                                   device="cpu")
    got = restored.run()
    assert got.keys() == want.keys()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert all(r.state == FINISHED for r in restored.requests)
