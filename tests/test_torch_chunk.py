"""The chunk lane (chunked admission) of the port against the JAX package.

``chunk_prefill_attention`` and ``decode_step(chunk=...)`` are held to the
reference's on bridged weights (fp32, within 1e-5; integer counts and
untouched pool pages exactly), the no-op chunk included: the port skips
the lane where the reference runs it with every row masked, and the tick
must come out the same. The ``Server``'s chunk methods and their errors.
Then the reference's four chunk cases (``tests/test_scheduler.py``), one
for one, with both schedulers on the same requests: stream parity with
bounded stall, preemption mid-prefill, chaos parity with chunked prefill
(seed 11, the reference's own) and validation. The reference's "one
compiled step program" has no eager counterpart; the port counts the
attention calls of each tick kind against the prediction instead.

Last, where the port's prefill routing leaves the reference's (ROADMAP
Queue 3 item 2): with committed replicas and a dropping capacity factor,
the port's table-routed prefill keeps more copies than the reference's
native-routed splice prefill, and agrees with the reference's ``moe_ep``
given the same placement, the routing of the reference's own chunk lane."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.models import attention as JA
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.parallel.ctx import ParallelCtx as JCtx
from repro.parallel.placement import PlacementTable as JTable
from repro.runtime import faults as JF
from repro.runtime.scheduler import RequestScheduler as JScheduler
from repro.runtime.serve import ServeConfig as JServeConfig
from repro.runtime.serve import Server as JServer
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.parallel import collectives as C
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.placement import PlacementTable
from repro_torch.runtime import faults as F
from repro_torch.runtime.scheduler import (
    FINISHED,
    PREFILLING,
    RequestScheduler,
)
from repro_torch.runtime.serve import ServeConfig, Server, SlotReleaseError

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
DENSE = smoke(get_config("llama3.2-1b"))
JDENSE = jsmoke(jget("llama3.2-1b"))
MOE = dataclasses.replace(smoke(get_config("dbrx-132b")), n_experts=4, experts_per_token=2)
JMOE = dataclasses.replace(jsmoke(jget("dbrx-132b")), n_experts=4, experts_per_token=2)
MOE_KW = dict(slots_per_device=3, virtual_ep=4)


@pytest.fixture(scope="module")
def dense_np():
    return jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), JDENSE))


@pytest.fixture(scope="module")
def moe_np():
    return jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), JMOE))


def _scfg(**kw):
    out = dict(max_seq=64, paged=True, page_size=8)
    out.update(kw)
    return out


def _servers(cfg, jcfg, np_params, **kw):
    srv = Server(cfg, ParallelCtx(capacity_factor=8.0), params_from_numpy(np_params),
                 ServeConfig(**_scfg(**kw)), device="cpu")
    jsrv = JServer(jcfg, JCtx(capacity_factor=8.0), jax.tree.map(jnp.asarray, np_params),
                   JServeConfig(**_scfg(**kw)))
    return srv, jsrv


def _prompts(lens, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _serve(sched, prompts, max_new, eos=None, arrivals=None):
    reqs = [sched.submit(p, max_new_tokens=max_new, eos_id=eos if i == 0 else None,
                         arrival=i if arrivals is None else arrivals[i])
            for i, p in enumerate(prompts)]
    return reqs, sched.run()


def _same_run(ps, js):
    assert [(s, k) for s, k, _ in ps.events] == [(s, k) for s, k, _ in js.events]
    assert ps.n_preempted == js.n_preempted
    pr, jr = ps.results(), js.results()
    assert pr.keys() == jr.keys()
    for rid in pr:
        np.testing.assert_array_equal(pr[rid], jr[rid])
    assert [r.state for r in ps.requests] == [r.state for r in js.requests]


def _sequential(cfg, jcfg, np_params, prompts, max_new, **kw):
    """Each request alone in a fresh batch-1 splice-admission server of the
    port with an ample pool and no faults (the reference's oracle)."""
    out = []
    for p in prompts:
        srv, _ = _servers(cfg, jcfg, np_params, batch=1, pool_pages=64, **kw)
        (req,), _ = _serve(RequestScheduler(srv), [p], max_new)
        assert req.state == FINISHED
        out.append(np.asarray(req.tokens_out, np.int32))
    return out


# ---------------------------------------------------------------------------
# chunk_prefill_attention and decode_step(chunk=...)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start,length", [(0, 8), (8, 8), (16, 5), (24, 1)])
def test_chunk_prefill_attention_matches_reference(dense_np, start, length):
    """One chunk against a pool holding earlier chunks' rows: the output
    within 1e-5, the chunk's rows written at slot == position, pad rows on
    the write-off page only, every other page untouched."""
    rng = np.random.default_rng(start + length)
    n_pages, bs, nb, c = 9, 8, 4, 8
    kv = (DENSE.n_kv_heads, DENSE.head_dim_)
    pool_k = rng.standard_normal((n_pages + 1, bs, *kv)).astype(np.float32)
    pool_v = rng.standard_normal((n_pages + 1, bs, *kv)).astype(np.float32)
    table = np.array([5, 2, 7, 0], np.int32)
    x = rng.standard_normal((1, c, DENSE.d_model)).astype(np.float32)
    p = {k: v[0] for k, v in dense_np["layers"]["attn"].items()}
    tables = np.full((2, nb), n_pages, np.int32)
    lengths = np.zeros(2, np.int32)
    jcache = {"pool_k": jnp.asarray(pool_k), "pool_v": jnp.asarray(pool_v),
              "tables": jnp.asarray(tables), "lengths": jnp.asarray(lengths)}
    jout, jnew = JA.chunk_prefill_attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcache, jnp.asarray(table),
        jnp.asarray(start, jnp.int32), jnp.asarray(length, jnp.int32), JDENSE, JCtx())
    cache = {"pool_k": torch.tensor(pool_k), "pool_v": torch.tensor(pool_v),
             "tables": torch.tensor(tables), "lengths": torch.tensor(lengths)}
    out, new = A.chunk_prefill_attention(
        {k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x), cache,
        torch.tensor(table), start, length, DENSE, ParallelCtx())
    assert new["pool_k"] is cache["pool_k"]          # written in place
    np.testing.assert_allclose(out[0, :length].numpy(), np.asarray(jout)[0, :length], **TOL)
    for name in ("pool_k", "pool_v"):
        got, want = new[name].numpy(), np.asarray(jnew[name])
        np.testing.assert_allclose(got[:n_pages], want[:n_pages], **TOL)
        written = {(int(table[(start + i) // bs]), (start + i) % bs) for i in range(length)}
        orig = pool_k if name == "pool_k" else pool_v
        for pg in range(n_pages):
            for r in range(bs):
                if (pg, r) not in written:
                    np.testing.assert_array_equal(got[pg, r], orig[pg, r])
    with pytest.raises(ValueError, match="full attention"):
        A.chunk_prefill_attention({}, torch.tensor(x), cache, torch.tensor(table), 0, 1,
                                  dataclasses.replace(DENSE, sliding_window=16), ParallelCtx())


def _step_pair(np_params, chunk_kind):
    """Both packages' EP servers with request 0 decoding in slot 0 and
    request 1 mid-prefill in slot 1; one decode_step of each with this
    tick's chunk operand (``noop``, ``mid`` or ``last``)."""
    srv, jsrv = _servers(MOE, JMOE, np_params, batch=3, pool_pages=12,
                         prefill_chunk=8, **MOE_KW)
    prompt, ctx1 = _prompts([6, 13], seed=3)
    cache, jcache = srv.empty_cache(), jsrv.empty_cache()
    _, cache = srv.prefill_into_slot(0, prompt, cache)
    _, jcache = jsrv.prefill_into_slot(0, prompt, jcache)
    for s in (srv, jsrv):
        s.begin_chunk_prefill(1, len(ctx1))
    start, n = {"noop": (0, 0), "mid": (0, 8), "last": (8, 5)}[chunk_kind]
    buf = np.zeros(8, np.int32)
    buf[:n] = ctx1[start:start + n]
    if chunk_kind == "noop":
        op, jop = srv.noop_chunk(), jsrv.noop_chunk()
    else:
        if chunk_kind == "last":   # the first chunk, through both lanes
            first = np.asarray(ctx1[:8])
            _, cache = srv.decode(np.zeros((3, 1), np.int32), cache,
                                  chunk=srv.chunk_operand(1, first, 0, 8))
            _, jcache = jsrv.decode(jnp.zeros((3, 1), jnp.int32), jcache,
                                    chunk=jsrv.chunk_operand(1, first, 0, 8))
        op, jop = srv.chunk_operand(1, buf, start, n), jsrv.chunk_operand(1, buf, start, n)
    tok = np.array([[7], [0], [0]], np.int32)
    live = np.array([True, False, False])
    out = T.decode_step(srv.params, torch.tensor(tok), cache, MOE, srv.ctx,
                        placement=srv.table.device_view("cpu"),
                        slot_mask=torch.tensor(live), chunk=op)
    jout = JT.decode_step(jsrv.params, jnp.asarray(tok), jcache, JMOE, jsrv.ctx,
                          placement=jsrv.table.device_view(),
                          slot_mask=jnp.asarray(live), chunk=jop)
    return srv, out, jout, n


@pytest.mark.parametrize("chunk_kind", ["noop", "mid", "last"])
def test_decode_step_with_chunk_matches_reference(moe_np, chunk_kind):
    """A decode tick with the lane: logits, expert counts (both lanes'),
    the chunk's logits and the live pool pages as the reference's. A no-op
    chunk (skipped by the port) gives the same logits, counts and live
    pages as the reference's masked no-op lane, and no chunk logits."""
    srv, (logits, cache, stats), (jlogits, jcache, jstats), n = _step_pair(moe_np, chunk_kind)
    np.testing.assert_allclose(logits[0].numpy(), np.asarray(jlogits)[0], **TOL)
    np.testing.assert_array_equal(stats["expert_counts"].numpy(),
                                  np.asarray(jstats["expert_counts"]))
    live = sorted(set(srv.page_pool._live))
    for name in ("pool_k", "pool_v"):
        np.testing.assert_allclose(cache["layers"][name][:, live].numpy(),
                                   np.asarray(jcache["layers"][name])[:, live], **TOL)
    np.testing.assert_array_equal(cache["layers"]["lengths"].numpy()[:, 0],
                                  np.asarray(jcache["layers"]["lengths"])[:, 0])
    if chunk_kind == "noop":
        assert "chunk_logits" not in stats
        # the decode lane's counts only: one live row, top-2, every layer
        assert float(stats["expert_counts"].sum()) == 2 * MOE.n_layers
    else:
        np.testing.assert_allclose(stats["chunk_logits"].numpy(),
                                   np.asarray(jstats["chunk_logits"]), **TOL)
        assert float(stats["expert_counts"].sum()) == 2 * MOE.n_layers * (1 + n)


def test_server_chunk_methods_and_errors(dense_np):
    srv, _ = _servers(DENSE, JDENSE, dense_np, batch=2, pool_pages=10, prefill_chunk=8)
    plain, _ = _servers(DENSE, JDENSE, dense_np, batch=2, pool_pages=10)
    cache = srv.empty_cache()
    with pytest.raises(ValueError, match="prefill_chunk"):
        plain.begin_chunk_prefill(0, 5)
    with pytest.raises(ValueError, match="prefill_chunk"):
        plain.decode(np.zeros((2, 1), np.int32), plain.empty_cache(), chunk=srv.noop_chunk())
    with pytest.raises(RuntimeError, match="begin_chunk_prefill first"):
        srv.chunk_operand(0, np.zeros(8), 0, 8)
    free = srv.page_pool.n_free
    srv.begin_chunk_prefill(0, 20)
    assert srv.page_pool.n_free == free - 3
    assert (srv._tables[0] == srv.trash_page).all()   # the live row stays trash
    with pytest.raises(RuntimeError, match="mid-prefill"):
        srv.begin_chunk_prefill(0, 4)
    with pytest.raises(ValueError, match="exactly prefill_chunk=8"):
        srv.chunk_operand(0, np.zeros(5), 0, 5)
    noop = srv.noop_chunk()
    assert noop["length"] == 0 and (noop["table"] == srv.trash_page).all()
    with pytest.raises(SlotReleaseError):
        srv.abort_chunk_prefill(1)
    with pytest.raises(RuntimeError, match="no chunked prefill"):
        srv.finish_chunk_prefill(1, cache, 4)
    # the decode lane's masked write for the prefilling row lands on the
    # trash page: the side pages stay as the chunk wrote them
    tokens = np.arange(1, 21, dtype=np.int32)
    for start in (0, 8, 16):
        n = min(8, 20 - start)
        buf = np.zeros(8, np.int32)
        buf[:n] = tokens[start:start + n]
        _, cache = srv.decode(np.zeros((2, 1), np.int32), cache,
                              chunk=srv.chunk_operand(0, buf, start, n))
    assert srv.last_chunk_logits.shape == (1, 1, DENSE.vocab_size)
    assert int(cache["layers"]["lengths"][0, 0]) == 0
    side = list(srv._prefill_pages[0])
    written = cache["layers"]["pool_k"][:, side].clone()
    cache = srv.finish_chunk_prefill(0, cache, 20)
    assert srv._pages[0] == side and 0 not in srv._released
    assert int(cache["layers"]["lengths"][0, 0]) == 20
    assert cache["layers"]["tables"][:, 0, :3].tolist() == [side] * DENSE.n_layers
    assert torch.equal(cache["layers"]["pool_k"][:, side], written)
    # the splice of the same context gives the same first token
    ref, _ = _servers(DENSE, JDENSE, dense_np, batch=2, pool_pages=10)
    logits, _ = ref.prefill_into_slot(0, tokens, ref.empty_cache())
    assert int(logits[0, -1].argmax()) == int(srv.last_chunk_logits[0, -1].argmax())
    # aborts come back on empty_cache and prefill
    srv.begin_chunk_prefill(1, 9)
    srv.empty_cache()
    assert not srv._prefill_pages and srv.page_pool.n_free == 10


# ---------------------------------------------------------------------------
# the reference's four chunk cases
# ---------------------------------------------------------------------------

def test_prefill_chunk_validation():
    kw = dict(max_seq=64, paged=True, page_size=8)
    for bad, match in ((-8, "positive"), (0, "positive"), (12, "page-size-aligned"),
                       (128, "max_seq")):
        with pytest.raises(ValueError, match=match):
            ServeConfig(prefill_chunk=bad, **kw)
        with pytest.raises(ValueError, match=match):
            JServeConfig(prefill_chunk=bad, **kw)
    with pytest.raises(ValueError, match="paged=True"):
        ServeConfig(prefill_chunk=128, max_seq=256, paged=False)
    assert ServeConfig(prefill_chunk=16, **kw).prefill_chunk == 16
    windowed = dataclasses.replace(smoke(get_config("mixtral-8x22b")))
    params = T.init_params(windowed, device="cpu")
    with pytest.raises(ValueError, match="full attention"):
        Server(windowed, ParallelCtx(), params, ServeConfig(prefill_chunk=8, **kw),
               device="cpu")


def test_chunked_admission_stream_parity_and_bounded_stall(dense_np, monkeypatch):
    """Chunked against splice admission and against the reference's chunked
    scheduler: equal streams and events; no live request stalls; each
    first token within ceil(len/chunk)+1 ticks of admission. Every tick
    runs the attention calls its kind predicts: none idle, one decode
    attention a layer on a decode tick, plus one chunk attention a layer
    on a chunk tick."""
    prompts = _prompts([30, 5, 9, 12], vocab=DENSE.vocab_size)
    chunk = 8

    def run(prefill_chunk):
        srv, jsrv = _servers(DENSE, JDENSE, dense_np, batch=3, pool_pages=32,
                             prefill_chunk=prefill_chunk)
        return RequestScheduler(srv), JScheduler(jsrv)

    splice, jsplice = run(None)
    _serve(splice, prompts, 6)
    _serve(jsplice, prompts, 6)
    _same_run(splice, jsplice)
    sched, jsched = run(chunk)
    calls = {"decode": 0, "chunk": 0}
    for name, attr in (("decode", "decode_attention"), ("chunk", "chunk_prefill_attention")):
        def spy(*a, _fn=getattr(T, attr), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(T, attr, spy)
    step = sched.step
    ticks = []

    def counted():
        before = dict(calls)
        out = step()
        ticks.append((calls["decode"] - before["decode"], calls["chunk"] - before["chunk"]))
        return out

    monkeypatch.setattr(sched, "step", counted)
    reqs, res = _serve(sched, prompts, 6)
    _serve(jsched, prompts, 6)
    _same_run(sched, jsched)
    for rid, want in splice.results().items():
        np.testing.assert_array_equal(res[rid], want)
    L = DENSE.n_layers
    for n_dec, n_chunk in ticks:
        assert (n_dec, n_chunk) in ((0, 0), (L, 0), (L, L))
    assert sum(n for _, n in ticks) == L * sum(-(-len(p) // chunk) for p in prompts)
    stats = sched.stats()
    assert stats["max_stall_ticks"] == 0
    assert stats["queue_depth"] == 0 and stats["prefill_backlog"] == 0
    for r in reqs:
        assert r.state == FINISHED
        assert r.first_token_step - r.admitted_step + 1 <= -(-len(r.prompt) // chunk) + 1
        assert stats["per_request"][r.rid]["ttft_ticks"] == r.ttft_ticks
        assert stats["per_request"][r.rid]["n_tokens"] == 6


def test_preempt_mid_prefill_requeues_without_tokens(dense_np):
    """Preempting a half-prefilled request returns its side pages, resets
    its progress, counts no token and requeues it at the front; both
    packages then serve the same streams, equal to the sequential
    oracle."""
    prompts = _prompts([40, 4], vocab=DENSE.vocab_size)
    seq = _sequential(DENSE, JDENSE, dense_np, prompts, 5)
    scheds = []
    for srv in _servers(DENSE, JDENSE, dense_np, batch=2, pool_pages=16, prefill_chunk=8):
        sched = (RequestScheduler if isinstance(srv, Server) else JScheduler)(srv)
        r0 = sched.submit(prompts[0], max_new_tokens=5)
        sched.submit(prompts[1], max_new_tokens=5)
        while not (r0.state == PREFILLING and r0.prefill_pos > 0):
            sched.step()
        free_before = srv.page_pool.n_free
        held = len(srv._prefill_pages[r0.slot])
        sched._preempt(r0, "test-evict")
        assert r0.tokens_out == [] and r0.prefill_pos == 0 and r0.preemptions == 1
        assert srv.page_pool.n_free == free_before + held
        assert sched.queue[0] is r0
        assert sched.stats()["prefill_backlog"] == 44
        sched.run()
        scheds.append(sched)
    _same_run(*scheds)
    for rid, got in scheds[0].results().items():
        np.testing.assert_array_equal(got, seq[rid])


def test_chaos_parity_chunked_prefill(moe_np):
    """The reference's chaos harness with chunked admission (seed 11, which
    still preempts): device death, pool pressure, a NaN step and an EOS;
    both packages run event for event alike, and every stream equals the
    sequential fault-free splice-admission oracle."""
    seed, max_new = 11, 7
    lens = [int(x) for x in np.random.default_rng(seed).integers(3, 14, size=4)]
    prompts = _prompts(lens, seed=seed, vocab=MOE.vocab_size)
    seq = _sequential(MOE, JMOE, moe_np, prompts, max_new, **MOE_KW)
    eos = int(seq[0][2])
    seq[0] = seq[0][: int(np.argmax(seq[0] == eos)) + 1]
    kw = dict(batch=3, pool_pages=10, alpha=0.1, prefill_chunk=8, **MOE_KW)
    srv, jsrv = _servers(MOE, JMOE, moe_np, **kw)
    args = dict(n_steps=12, n_devices=4, pressure_pages=5, nan_slots=(0,))
    ps = RequestScheduler(srv, faults=F.FaultPlan.chaos(seed, **args))
    js = JScheduler(jsrv, faults=JF.FaultPlan.chaos(seed, **args))
    reqs, res = _serve(ps, prompts, max_new, eos)
    _serve(js, prompts, max_new, eos)
    _same_run(ps, js)
    fired = {d[0] for _, k, d in ps.events if k == "fault"}
    assert {"device_death", "pool_pressure", "nan_logits"} <= fired
    assert ps.n_preempted > 0
    for r in reqs:
        assert r.state == FINISHED
        np.testing.assert_array_equal(res[r.rid], seq[r.rid])
    np.testing.assert_array_equal(srv.table.slot_of, jsrv.table.slot_of)
    srv.table.check()


# ---------------------------------------------------------------------------
# where the port's prefill leaves the reference's (ROADMAP Queue 3 item 2)
# ---------------------------------------------------------------------------

def _hot_router(np_params):
    """Every token's top choice is expert 0: embedding feature 0 is a large
    constant and expert 0's router weight on it is raised, a margin far from
    underflow (tied zero probabilities would let ``torch.topk`` and
    ``lax.top_k`` order the other experts differently)."""
    p = jax.tree.map(np.copy, np_params)
    p["embed"][:, 0] = 4.0
    p["layers"]["moe"]["router"][:, 0, 0] += 5.0
    return p


def _replicated(table_cls):
    """4 experts on 6 slots (3 devices x 2), expert 0 committed on slots 0,
    4 and 5: two replicas beside its native slot."""
    slot_of = np.tile(np.arange(4, dtype=np.int32)[:, None], (1, 4))
    slot_of[0, :3] = [0, 4, 5]
    return table_cls(4, 6, 2, slot_of, np.array([3, 1, 1, 1], np.int32))


def test_prefill_routing_against_reference(moe_np):
    """Where the port's table-routed prefill leaves the reference's
    native-routed splice prefill. (a) Every copy of 16 tokens x top-2 to
    expert 0, two committed replicas, capacity factor 1.0: native routing
    keeps 8 of the 32 copies and table routing 24, in both packages, and
    the port's ``ep_moe_local`` under the table equals the reference's
    under the same placement. (b) A router whose top choice is always
    expert 0: the port's ``moe_ep`` under the committed table equals the
    JAX ``moe_ep`` given that placement, and differs from its native
    routing. (c) The two Servers' prefills, expert 0 replicated by
    ``apply_plan``: equal where no copy drops (factor 8.0), different at
    factor 1.0."""
    from repro.parallel import collectives as JC

    params = _hot_router(moe_np)
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    slot_p = {k: np.take(p[k], np.arange(6) % 4, axis=0) for k in ("w_gate", "w_up", "w_down")}
    x = np.random.default_rng(0).standard_normal((1, 16, MOE.d_model)).astype(np.float32)
    x[..., 0] = 8.0
    tx = torch.tensor(x)
    tp, tj = _replicated(PlacementTable), _replicated(JTable)
    ctx = ParallelCtx(capacity_factor=1.0, moe_impl="ep")
    jctx = JCtx(capacity_factor=1.0, moe_impl="ep")
    tslot = {k: torch.tensor(v) for k, v in slot_p.items()}
    jslot = jax.tree.map(jnp.asarray, slot_p)

    # (a) the re-anchor's scratch case: ids all expert 0
    ids = np.zeros((1, 16, 2), np.int32)
    w = np.full((1, 16, 2), 0.5, np.float32)
    cap = C.bucket_capacity(16, 2, 1.0, 6)
    kept = {}
    for name, (pv, jv) in (("table", (tp.device_view("cpu"), tj.device_view())),
                           ("native", (C.uniform_placement(4, 6), JC.uniform_placement(4, 6)))):
        slots = C.choose_slots(torch.tensor(ids).reshape(16, 2), *pv, sentinel=7)
        jslots = JC.choose_slots(jnp.asarray(ids).reshape(16, 2), *jv, sentinel=7)
        keep = C.bucket_dispatch(tx.reshape(16, -1), slots, 6, cap)[2]
        jkeep = JC.bucket_dispatch(jnp.asarray(x).reshape(16, -1), jslots, 6, cap)[2]
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
        kept[name] = int(keep.sum())
        out = C.ep_moe_local(tx, torch.tensor(ids), torch.tensor(w), tslot, *pv, ctx, 1.0, 6)
        jout = JC.ep_moe_local(jnp.asarray(x), jnp.asarray(ids), jnp.asarray(w), jslot,
                               *jv, jctx, 1.0, 6)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert kept == {"table": 24, "native": 8}

    # (b) the hot router through moe_ep
    tparams = {"router": torch.tensor(p["router"]), **tslot}
    jparams = {"router": jnp.asarray(p["router"]), **jslot}
    assert bool((M.route(tparams, tx, MOE)[0][..., 0] == 0).all())
    got, _ = M.moe_ep(tparams, tx, MOE, ctx, placement=tp)
    want, _ = JM.moe_ep(jparams, jnp.asarray(x), JMOE, jctx, placement=tj.device_view())
    native, _ = JM.moe_ep(jparams, jnp.asarray(x), JMOE, jctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not np.allclose(np.asarray(native), np.asarray(want), **TOL)

    # (c) the Servers' prefills
    prompt = np.random.default_rng(1).integers(0, MOE.vocab_size, (2, 16)).astype(np.int32)
    kw = _scfg(batch=2, slots_per_device=3, virtual_ep=3, migration_slices=0)
    outs = {}
    for cf in (1.0, 8.0):
        srv = Server(MOE, ParallelCtx(capacity_factor=cf), params_from_numpy(params),
                     ServeConfig(**kw), device="cpu")
        jsrv = JServer(JMOE, JCtx(capacity_factor=cf), jax.tree.map(jnp.asarray, params),
                       JServeConfig(**kw))
        for s in (srv, jsrv):
            assert s.apply_plan([(0, 0, 1), (0, 0, 2)]) == 2
        np.testing.assert_array_equal(srv.table.slot_of, jsrv.table.slot_of)
        logits, _ = srv.prefill(prompt)
        jlogits, _ = jsrv.prefill(jnp.asarray(prompt))
        outs[cf] = (logits.numpy(), np.asarray(jlogits))
    np.testing.assert_allclose(*outs[8.0], **TOL)
    assert not np.allclose(*outs[1.0], **TOL)
