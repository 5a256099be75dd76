"""The serving slice end to end on the CPU, against the JAX package on
bridged weights: paged prefill fill and decode, and ``Server.generate``
with the NI-Balancer live (virtual EP, stepped migrations). fp32; greedy
tokens, migration counts and committed placements must be equal, floats
within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.models import transformer as JT
from repro.parallel.ctx import ParallelCtx as JCtx
from repro.runtime.serve import ServeConfig as JServeConfig
from repro.runtime.serve import Server as JServer
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke
from repro_torch.kernels.flash_decode.ref import gather_pages
from repro_torch.models import transformer as T
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.runtime.serve import (
    PagePool,
    ServeConfig,
    Server,
    SlotReleaseError,
)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
CFG = smoke(get_config("dbrx-132b"))
JCFG = jsmoke(jget("dbrx-132b"))


@pytest.fixture(scope="module")
def jparams():
    return JT.init_params(jax.random.PRNGKey(0), JCFG)


def _bridge(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _skew(params_np, hot=(0, 1), factor=8.0):
    """Scale the hot experts' router columns: sustained skewed traffic, so
    the Eq. 2 trigger fires and migrations run."""
    router = np.array(params_np["layers"]["moe"]["router"])
    router[..., list(hot)] *= factor
    params_np["layers"]["moe"]["router"] = router
    return params_np


def test_paged_prefill_and_decode_match_reference(jparams):
    """Ragged right-padded prompts through scrambled block tables, then
    decode steps: logits, written lengths and every live KV row agree."""
    b, s, bs, nb = 3, 10, 4, 4
    n_pages = b * nb
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG.vocab_size, (b, s)).astype(np.int32)
    lengths = np.asarray([10, 7, 3], np.int32)
    tables = rng.permutation(n_pages).reshape(b, nb).astype(np.int32)
    jlog, jcache = JT.prefill(jparams, jnp.asarray(tokens), JCFG, JCtx(), max_seq=16,
                              paged=True, page_size=bs, n_pages=n_pages,
                              tables=jnp.asarray(tables), lengths=jnp.asarray(lengths))
    params = _bridge(jparams)
    log, cache = T.prefill(params, torch.tensor(tokens), CFG, ParallelCtx(), max_seq=16,
                           paged=True, page_size=bs, n_pages=n_pages,
                           tables=torch.tensor(tables), lengths=torch.tensor(lengths))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    tok = np.asarray(jnp.argmax(jlog[:, -1:], -1)).astype(np.int32)
    for _ in range(3):
        jlog, jcache, jst = JT.decode_step(jparams, jnp.asarray(tok), jcache, JCFG, JCtx())
        log, cache, st = T.decode_step(params, torch.tensor(tok), cache, CFG, ParallelCtx())
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
        np.testing.assert_array_equal(st["expert_counts"].numpy(),
                                      np.asarray(jst["expert_counts"]))
        tok = np.asarray(jnp.argmax(jlog[:, -1:], -1)).astype(np.int32)
    jl = np.asarray(jcache["layers"]["lengths"])
    np.testing.assert_array_equal(cache["layers"]["lengths"].numpy(), jl)
    np.testing.assert_array_equal(jl[0], lengths + 3)
    for name in ("pool_k", "pool_v"):
        for layer in range(CFG.n_layers):
            got = gather_pages(cache["layers"][name][layer], torch.tensor(tables)).numpy()
            want = np.asarray(jcache["layers"][name][layer])[tables.reshape(-1)]
            want = want.reshape(got.shape)
            for i in range(b):
                np.testing.assert_allclose(got[i, : jl[layer, i]], want[i, : jl[layer, i]],
                                           **TOL)


@pytest.mark.parametrize("migration_slices", [4, 0])
def test_server_generate_matches_reference(jparams, migration_slices):
    """Virtual EP over 4 devices x 3 slots, paged, eager balancer on skewed
    traffic: same greedy tokens, migration count, committed placement and
    slice schedule as the JAX Server."""
    kw = dict(max_seq=32, batch=2, slots_per_device=3, virtual_ep=4, alpha=0.1,
              paged=True, page_size=8, migration_slices=migration_slices)
    np_params = _skew(jax.tree.map(np.asarray, jparams))
    prompt = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 6)).astype(np.int32)
    js = JServer(JCFG, JCtx(capacity_factor=8.0),
                 jax.tree.map(jnp.asarray, np_params), JServeConfig(**kw))
    jout = np.asarray(js.generate(jnp.asarray(prompt), 10))
    srv = Server(CFG, ParallelCtx(capacity_factor=8.0), params_from_numpy(np_params),
                 ServeConfig(**kw), device="cpu")
    out = srv.generate(prompt, 10)
    np.testing.assert_array_equal(out.numpy(), jout)
    assert srv.migrations == js.migrations > 0
    np.testing.assert_array_equal(srv.table.slot_of, js.table.slot_of)
    np.testing.assert_array_equal(srv.table.n_replicas, js.table.n_replicas)
    srv.table.check()
    if migration_slices:
        recs = [{k: r[k] for k in ("mig", "src_slot", "dst_slot", "issue_ticks",
                                   "committed")} for r in srv.driver.history]
        jrecs = [{k: r[k] for k in ("mig", "src_slot", "dst_slot", "issue_ticks",
                                    "committed")} for r in js.driver.history]
        assert recs == jrecs
        for r in recs:
            assert r["committed"] > max(r["issue_ticks"])
    # replicas are exact copies of their native expert's rows
    moe = srv.params["layers"]["moe"]
    for e in range(CFG.n_experts):
        for s in srv.table.committed_slots(e):
            for w in ("w_gate", "w_up", "w_down"):
                assert torch.equal(moe[w][:, s], moe[w][:, e])


def test_server_generate_ep_chunks_bit_identical(jparams):
    np_params = jax.tree.map(np.asarray, jparams)
    prompt = np.ones((2, 5), np.int32)
    outs = []
    for kc in (1, 2):
        srv = Server(CFG, ParallelCtx(capacity_factor=8.0), params_from_numpy(np_params),
                     ServeConfig(max_seq=32, batch=2, slots_per_device=3, virtual_ep=4,
                                 paged=True, page_size=8, ep_chunks=kc), device="cpu")
        outs.append(srv.generate(prompt, 6))
    assert torch.equal(outs[0], outs[1])


def test_slot_admission_release_and_pool(jparams):
    srv = Server(CFG, ParallelCtx(capacity_factor=8.0), _bridge(jparams),
                 ServeConfig(max_seq=32, batch=2, slots_per_device=3, virtual_ep=4,
                             paged=True, page_size=8, pool_pages=6), device="cpu")
    cache = srv.empty_cache()
    assert srv.page_pool.n_free == 6
    logits, cache = srv.prefill_into_slot(1, np.arange(1, 10), cache)
    assert logits.shape == (1, 1, CFG.vocab_size)
    assert srv.page_pool.n_free == 4 and int(cache["layers"]["lengths"][0, 1]) == 9
    tok = torch.zeros((2, 1), dtype=torch.long)
    for _ in range(8):   # grows into a third page at the block boundary
        logits, cache = srv.decode(tok, cache)
    assert srv.page_pool.n_free == 3
    assert int(cache["layers"]["lengths"][0, 0]) == 0   # empty row stays inert
    with pytest.raises(RuntimeError, match="still admitted"):
        srv.prefill_into_slot(1, [1, 2], cache)
    srv.release(1, cache)
    assert srv.page_pool.n_free == 6
    with pytest.raises(SlotReleaseError):
        srv.release(1)
    pool = PagePool(2)
    pages = pool.alloc(2)
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(1)
    pool.free(pages)
    with pytest.raises(ValueError, match="double free"):
        pool.free(pages[:1])


def test_serve_config_validation_and_unported_paths(jparams, tmp_path):
    with pytest.raises(ValueError, match="page-size-aligned"):
        ServeConfig(paged=True, page_size=8, prefill_chunk=12)
    with pytest.raises(ValueError, match="requires paged"):
        ServeConfig(prefill_chunk=128)
    with pytest.raises(ValueError, match="does not divide"):
        ServeConfig(slots_per_device=3, virtual_ep=4, ep_chunks=5)
    base = dict(max_seq=32, batch=2, slots_per_device=3, virtual_ep=4, page_size=8)
    # the dense cache (the default) serves, with the balancer live
    srv = Server(CFG, ParallelCtx(), _bridge(jparams), ServeConfig(**base), device="cpu")
    out = srv.generate(np.ones((2, 3), np.int32), 2)
    assert out.shape == (2, 2) and srv.ctx.moe_impl == "ep"
    # the chunk lane serves (paged) and generate takes splice prefills as
    # before; under a mesh (once refused) too, with the same tokens
    chunked = Server(CFG, ParallelCtx(), _bridge(jparams),
                     ServeConfig(paged=True, prefill_chunk=8, **base), device="cpu")
    assert chunked.scfg.prefill_chunk == 8 and chunked.noop_chunk()["length"] == 0
    want = chunked.generate(np.ones((2, 3), np.int32), 2)
    assert want.shape == (2, 2)
    import torch.distributed as dist

    from repro_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        meshed = Server(CFG, ParallelCtx(mesh=make_mesh(1, 1)), _bridge(jparams),
                        ServeConfig(paged=True, prefill_chunk=8, **base), device="cpu")
        assert meshed.noop_chunk()["length"] == 0
        assert torch.equal(meshed.generate(np.ones((2, 3), np.int32), 2), want)
    finally:
        dist.destroy_process_group()
    # ESP serves the experts' own weights, on either cache
    for paged in (False, True):
        srv = Server(CFG, ParallelCtx(moe_impl="esp"), _bridge(jparams),
                     ServeConfig(paged=paged, max_seq=32, batch=2, page_size=8),
                     device="cpu")
        out = srv.generate(np.ones((2, 3), np.int32), 2)
        assert out.shape == (2, 2) and not srv.use_balancer
    small = dataclasses.replace(CFG, n_experts=4)
    with pytest.raises(ValueError, match="not enough slots"):
        Server(small, ParallelCtx(), _bridge(jparams),
               ServeConfig(paged=True, **dict(base, slots_per_device=1, virtual_ep=2)),
               device="cpu")


def test_paged_decode_freezes_at_capacity(jparams):
    """A full-attention request at capacity stops writing (freeze on
    overflow), exactly as the reference: the pool and the logits match."""
    bs, nb = 4, 2
    cap = bs * nb
    tokens = np.arange(1, 2 * cap + 1, dtype=np.int32).reshape(2, cap)
    jlog, jcache = JT.prefill(jparams, jnp.asarray(tokens), JCFG, JCtx(), max_seq=cap,
                              paged=True, page_size=bs)
    params = _bridge(jparams)
    log, cache = T.prefill(params, torch.tensor(tokens), CFG, ParallelCtx(), max_seq=cap,
                           paged=True, page_size=bs)
    pool_before = cache["layers"]["pool_k"].clone()
    tok = np.ones((2, 1), np.int32)
    jlog, jcache, _ = JT.decode_step(jparams, jnp.asarray(tok), jcache, JCFG, JCtx())
    log, cache, _ = T.decode_step(params, torch.tensor(tok), cache, CFG, ParallelCtx())
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    assert torch.equal(cache["layers"]["pool_k"], pool_before)
    np.testing.assert_array_equal(cache["layers"]["lengths"].numpy(),
                                  np.asarray(jcache["layers"]["lengths"]))
