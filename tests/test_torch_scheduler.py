"""The port's fault plans and ``RequestScheduler`` against the JAX package.

``FaultPlan.chaos`` must draw exactly as the reference's. Then both
schedulers serve the same requests on bridged weights (fp32, the MoE smoke
model with 4 experts top-2 over virtual EP, 4 devices x 3 slots, paged)
under the same plan: ragged arrivals, seed 5's chaos plan (the reference's
chaos harness; seed 14's plan no longer preempts under the reference's
jax, seed 5's does), seed 14's death-and-revival plan with the routing
invariant, the skewed-router migration stream, and a NaN fault with no
retry budget. Events (step, kind), preemption counts and token streams
must be equal.

Oracles: every case also holds the port to its own fault-free run at the
same batch and to its own sequential batch-1 run (on the CPU the port's
per-row computations do not depend on the batch). Seed 5's chaos case also
holds it to the reference's batch-1 oracle, as the reference's harness
does."""

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
from repro.runtime import faults as JF
from repro.runtime.scheduler import RequestScheduler as JScheduler
from repro.runtime.scheduler import SchedulerConfig as JSchedulerConfig
from repro.runtime.serve import ServeConfig as JServeConfig
from repro.runtime.serve import Server as JServer
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke
from repro_torch.models import transformer as T
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.runtime import faults as F
from repro_torch.runtime.scheduler import (
    FAILED,
    FINISHED,
    RequestScheduler,
    SchedulerConfig,
)
from repro_torch.runtime.serve import ServeConfig, Server

torch.set_num_threads(1)
CFG = dataclasses.replace(smoke(get_config("dbrx-132b")), n_experts=4, experts_per_token=2)
JCFG = dataclasses.replace(jsmoke(jget("dbrx-132b")), n_experts=4, experts_per_token=2)
MOE_KW = dict(slots_per_device=3, virtual_ep=4)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), JCFG))


def _skewed(np_params):
    """Hot experts' router columns dominate: the balancer keeps a stream of
    stepped migrations in flight."""
    p = jax.tree.map(np.copy, np_params)
    p["layers"]["moe"]["router"][..., [0, 1]] *= 8.0
    return p


def _scfg(**kw):
    out = dict(max_seq=64, paged=True, page_size=8, **MOE_KW)
    out.update(kw)
    return out


def _port(np_params, plan=None, sched_cfg=None, **kw):
    srv = Server(CFG, ParallelCtx(capacity_factor=8.0), params_from_numpy(np_params),
                 ServeConfig(**_scfg(**kw)), device="cpu")
    return RequestScheduler(srv, sched_cfg, faults=plan)


def _jax(np_params, plan=None, sched_cfg=None, **kw):
    srv = JServer(JCFG, JCtx(capacity_factor=8.0), jax.tree.map(jnp.asarray, np_params),
                  JServeConfig(**_scfg(**kw)))
    return JScheduler(srv, sched_cfg, faults=plan)


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=n).astype(np.int32) for n in lens]


def _serve(sched, prompts, max_new, eos=None, arrivals=None):
    reqs = [sched.submit(p, max_new_tokens=max_new, eos_id=eos if i == 0 else None,
                         arrival=i if arrivals is None else arrivals[i])
            for i, p in enumerate(prompts)]
    return reqs, sched.run()


def _sequential(make, prompts, max_new):
    """Each request alone in a fresh batch-1 server with an ample pool and
    no faults."""
    out = []
    for p in prompts:
        sched = make(batch=1, pool_pages=64)
        (req,), _ = _serve(sched, [p], max_new)
        assert req.state == FINISHED, (req.state, req.error)
        out.append(np.asarray(req.tokens_out, np.int32))
    return out


def _eos_cut(stream, eos):
    return stream[: int(np.argmax(stream == eos)) + 1]


def _same_run(ps, js):
    """Equal events (step, kind), preemptions and streams."""
    assert [(s, k) for s, k, _ in ps.events] == [(s, k) for s, k, _ in js.events]
    assert ps.n_preempted == js.n_preempted
    pr, jr = ps.results(), js.results()
    assert pr.keys() == jr.keys()
    for rid in pr:
        np.testing.assert_array_equal(pr[rid], jr[rid])
    assert [r.state for r in ps.requests] == [r.state for r in js.requests]


def _fired(sched):
    return {d[0] for _, k, d in sched.events if k == "fault"}


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("revive", [False, True])
@pytest.mark.parametrize("seed", [0, 5, 11, 14, 23])
def test_chaos_plan_draws_like_reference(seed, revive):
    for kw in (dict(n_steps=12, n_devices=4, pressure_pages=5, nan_slots=(0,)),
               dict(n_steps=24, n_devices=4, pressure_pages=6, nan_slots=(0, 2),
                    straggler_ratio=2.5),
               dict(n_steps=5, n_devices=1, pressure_pages=0)):
        plan = F.FaultPlan.chaos(seed, revive=revive, **kw)
        jplan = JF.FaultPlan.chaos(seed, revive=revive, **kw)
        assert len(plan) == len(jplan)
        assert [dataclasses.astuple(f) for f in plan] == \
            [dataclasses.astuple(f) for f in jplan]
        for step in range(50):
            assert [f.kind for f in plan.at(step)] == [f.kind for f in jplan.at(step)]


def test_fault_kinds_and_validation():
    assert F.KINDS == JF.KINDS
    with pytest.raises(ValueError, match="unknown fault kind"):
        F.Fault(step=0, kind="meteor")
    plan = F.FaultPlan([F.Fault(3, F.STRAGGLER), F.Fault(1, F.NAN_LOGITS)])
    assert [f.step for f in plan] == [1, 3] and plan.at(2) == ()


# ---------------------------------------------------------------------------
# both schedulers on the same plan
# ---------------------------------------------------------------------------

def test_ragged_arrivals_match_reference(np_params):
    """More requests than slots, ragged lengths, staggered arrivals."""
    prompts = _prompts([5, 11, 3, 8, 14])
    ps = _port(np_params, batch=3, pool_pages=14)
    reqs, res = _serve(ps, prompts, 6)
    js = _jax(np_params, batch=3, pool_pages=14)
    _serve(js, prompts, 6)
    _same_run(ps, js)
    seq = _sequential(lambda **kw: _port(np_params, **kw), prompts, 6)
    for i, r in enumerate(reqs):
        assert r.state == FINISHED
        np.testing.assert_array_equal(res[r.rid], seq[i])
    admits = [(s, rid) for s, k, rid in ps.events if k == "admit"]
    assert len(admits) == 5 and all(s >= reqs[rid].arrival for s, rid in admits)
    stats = ps.stats()
    assert stats["queue_depth"] == 0 and stats["prefill_backlog"] == 0
    assert [stats["per_request"][r.rid]["n_tokens"] for r in reqs] == [6] * 5


def _chaos_harness(np_params, seed, revive=False, skew=False, n_requests=4, max_new=7):
    """The reference's chaos harness (``tests/test_scheduler.py``): ragged
    prompts from ``seed``, request 0 stops at its own third fault-free
    token, batch 3 over a 10-page pool, ``FaultPlan.chaos(seed, 12, 4, 5,
    (0,))``. Returns the port's and the reference's schedulers, the
    prompts, the eos and the port's fault-free streams at the same batch."""
    params = _skewed(np_params) if skew else np_params
    lens = [int(x) for x in np.random.default_rng(seed).integers(3, 14, size=n_requests)]
    prompts = _prompts(lens, seed=seed)
    kw = dict(batch=3, pool_pages=10, alpha=0.1)
    _, free = _serve(_port(params, **kw), prompts, max_new)
    eos = int(free[0][min(2, max_new - 1)])
    free[0] = _eos_cut(free[0], eos)
    plan = F.FaultPlan.chaos(seed, n_steps=12, n_devices=4, pressure_pages=5,
                             nan_slots=(0,), revive=revive)
    jplan = JF.FaultPlan.chaos(seed, n_steps=12, n_devices=4, pressure_pages=5,
                               nan_slots=(0,), revive=revive)
    ps = _port(params, plan, **kw)
    js = _jax(params, jplan, **kw)
    return ps, js, prompts, eos, free


def _check_chaos(ps, js, prompts, eos, free, max_new=7):
    reqs, res = _serve(ps, prompts, max_new, eos)
    _serve(js, prompts, max_new, eos)
    _same_run(ps, js)
    for i, r in enumerate(reqs):
        assert r.state == FINISHED, (i, r.state, r.error)
        np.testing.assert_array_equal(res[r.rid], free[i])
    return reqs


def test_chaos_seed5_matches_reference(np_params):
    """Device death, straggler, pool pressure and a NaN step: the chaos
    bites (two preemptions in both packages), and every stream, recomputed
    ones included, equals the reference's, the port's fault-free run at the
    same batch and the reference's sequential batch-1 oracle."""
    ps, js, prompts, eos, free = _chaos_harness(np_params, seed=5)
    _check_chaos(ps, js, prompts, eos, free)
    assert {"device_death", "straggler", "pool_pressure", "nan_logits"} <= _fired(ps)
    assert ps.n_preempted == js.n_preempted > 0
    oracle = _sequential(lambda **kw: _jax(np_params, **kw), prompts, 7)
    oracle[0] = _eos_cut(oracle[0], eos)
    for rid, got in ps.results().items():
        np.testing.assert_array_equal(got, oracle[rid])
    np.testing.assert_array_equal(ps.server.table.slot_of, js.server.table.slot_of)
    assert ps.server.migrations == js.server.migrations
    ps.server.table.check()


def test_death_revival_routing_invariant_matches_reference(np_params, monkeypatch):
    """Seed 14's plan with revival (death of device 3 at step 2, revival at
    step 7): equal runs; the revived device is in no decode tick's
    committed routing view between its death and its first re-committed
    replica, and routes again afterwards."""
    ps, js, prompts, eos, free = _chaos_harness(np_params, seed=14, revive=True)
    srv = ps.server
    dev = next(f.device for f in ps.faults if f.kind == F.DEVICE_REVIVAL)
    routed, marks = [], {}
    inner = T.decode_step

    def spy(*args, **kw):
        routed.append((srv.t, dev in srv.table.committed_devices()))
        return inner(*args, **kw)

    monkeypatch.setattr(T, "decode_step", spy)
    mark_dead, revive = srv.mark_dead, srv.revive
    monkeypatch.setattr(srv, "mark_dead",
                        lambda d: (marks.setdefault("death", srv.t), mark_dead(d))[1])
    monkeypatch.setattr(srv, "revive",
                        lambda d: (marks.setdefault("revive", srv.t), revive(d))[1])
    _check_chaos(ps, js, prompts, eos, free)
    assert {"device_death", "device_revival"} <= _fired(ps)
    commits = [r["committed"] for r in srv.driver.history
               if r["mig"][2] == dev and r["committed"] > marks["revive"]]
    assert commits, "revival copies never committed"
    first = min(commits)
    assert not [t for t, present in routed if marks["death"] <= t < first and present]
    assert any(present for t, present in routed if t >= first)
    heats = srv.state.heats()
    assert np.isfinite(heats[dev]) and heats[dev] > 0
    assert srv.driver.history == js.server.driver.history
    np.testing.assert_array_equal(srv.table.slot_of, js.server.table.slot_of)
    srv.table.check()


def test_chaos_with_migration_stream_matches_reference(np_params):
    """Seed 14's chaos plan over a skewed router: stepped migrations land
    while faults fire; equal runs, equal migration records."""
    ps, js, prompts, eos, free = _chaos_harness(np_params, seed=14, skew=True)
    _check_chaos(ps, js, prompts, eos, free)
    srv = ps.server
    assert srv.migrations == js.server.migrations > 0
    assert srv.driver.history == js.server.driver.history
    assert srv.driver.aborted == js.server.driver.aborted
    srv.table.check()


def test_nan_fault_without_retry_budget_matches_reference(np_params):
    """With no retry budget a NaN-poisoned request FAILs, named, with a
    clean prefix of its stream; its batchmate finishes unharmed."""
    prompts = _prompts([6, 9])
    plan = F.FaultPlan([F.Fault(step=3, kind=F.NAN_LOGITS, slots=(0,))])
    jplan = JF.FaultPlan([JF.Fault(step=3, kind=JF.NAN_LOGITS, slots=(0,))])
    ps = _port(np_params, plan, SchedulerConfig(max_preemptions=0), batch=2, pool_pages=12)
    (r0, r1), _ = _serve(ps, prompts, 8, arrivals=[0, 0])
    js = _jax(np_params, jplan, JSchedulerConfig(max_preemptions=0), batch=2,
              pool_pages=12)
    _serve(js, prompts, 8, arrivals=[0, 0])
    _same_run(ps, js)
    seq = _sequential(lambda **kw: _port(np_params, **kw), prompts, 8)
    assert r0.state == FAILED and "evicted" in r0.error
    assert r1.state == FINISHED
    np.testing.assert_array_equal(np.asarray(r1.tokens_out), seq[1])
    np.testing.assert_array_equal(np.asarray(r0.tokens_out), seq[0][: len(r0.tokens_out)])


# ---------------------------------------------------------------------------
# the port's lifecycle against its own oracles
# ---------------------------------------------------------------------------

def test_eos_retires_mid_flight_and_slot_is_reused(np_params):
    prompts = _prompts([5, 9, 7])
    seq = _sequential(lambda **kw: _port(np_params, **kw), prompts, 8)
    eos = int(seq[0][0])
    sched = _port(np_params, batch=2, pool_pages=10)
    (r0, r1, r2), _ = _serve(sched, prompts, 8, eos, arrivals=[0, 0, 0])
    np.testing.assert_array_equal(np.asarray(r0.tokens_out), _eos_cut(seq[0], eos))
    np.testing.assert_array_equal(np.asarray(r1.tokens_out), seq[1])
    np.testing.assert_array_equal(np.asarray(r2.tokens_out), seq[2])
    ev = {(k, d): s for s, k, d in sched.events if k in ("admit", "retire")}
    assert ev[("admit", r2.rid)] >= ev[("retire", r0.rid)]


def test_watermark_defers_admission(np_params):
    prompts = _prompts([16, 16])
    sched = _port(np_params, None, SchedulerConfig(admit_watermark=0.5), batch=2, pool_pages=6)
    (r0, r1), res = _serve(sched, prompts, 4, arrivals=[0, 0])
    ev = {(k, d): s for s, k, d in sched.events if k in ("admit", "retire")}
    assert ev[("admit", r1.rid)] >= ev[("retire", r0.rid)]
    seq = _sequential(lambda **kw: _port(np_params, **kw), prompts, 4)
    for i in (0, 1):
        np.testing.assert_array_equal(res[i], seq[i])


def test_pool_pressure_preempts_and_recomputes_bit_identical(np_params):
    prompts = _prompts([7, 10, 6])
    plan = F.FaultPlan([F.Fault(step=2, kind=F.POOL_PRESSURE, pages=4),
                        F.Fault(step=8, kind=F.POOL_RELEASE, pages=4)])
    sched = _port(np_params, plan, batch=3, pool_pages=9)
    reqs, res = _serve(sched, prompts, 10, arrivals=[0, 0, 0])
    assert sched.n_preempted > 0
    assert any(k == "preempt" and d[1] == "pool-exhausted" for _, k, d in sched.events)
    _, free = _serve(_port(np_params, batch=3, pool_pages=9), prompts, 10, arrivals=[0, 0, 0])
    for r in reqs:
        assert r.state == FINISHED
        np.testing.assert_array_equal(res[r.rid], free[r.rid])
    assert sched.stats()["n_preempted"] == sched.n_preempted


def test_starved_pool_and_oversized_requests_fail(np_params):
    plan = F.FaultPlan([F.Fault(step=0, kind=F.POOL_PRESSURE, pages=4)])
    sched = _port(np_params, plan, batch=2, pool_pages=4)
    req = sched.submit(_prompts([6])[0], max_new_tokens=4)
    sched.run(max_steps=50)
    assert req.state == FAILED and "pool" in req.error
    sched = _port(np_params, batch=1, pool_pages=8)
    big = sched.submit(np.arange(40, dtype=np.int32), max_new_tokens=100)
    assert big.state == FAILED and "capacity" in big.error and not sched.queue
    assert sched.submit(np.arange(3), max_new_tokens=0).state == FAILED


def test_unported_paths_raise(np_params, tmp_path):
    """What ROADMAP Queue 1 items 3 and 4 ported now serves: a
    ``crash_restart`` fault raises ``SimulatedCrash`` with a snapshot,
    ``snapshot_every`` keeps ``last_snapshot``, ``save_snapshot`` writes
    the file, and a chunked server admits through the prefill lane. What
    stays refused: a dense-cache server, and ``prefill_chunk`` under a mesh
    (item 5, in ``tests/test_torch_serve.py``)."""
    from repro_torch.runtime import snapshot as S

    crash = F.FaultPlan([F.Fault(step=1, kind=F.CRASH_RESTART)])
    sched = _port(np_params, crash, batch=2, pool_pages=8)
    sched.submit(_prompts([5])[0], max_new_tokens=4)
    with pytest.raises(F.SimulatedCrash) as ei:
        sched.run()
    assert ei.value.step == 1 and ei.value.snapshot.step_no == 1 and not ei.value.path
    sched = _port(np_params, None, SchedulerConfig(snapshot_every=2), batch=2, pool_pages=8)
    sched.submit(_prompts([5])[0], max_new_tokens=4)
    sched.run()
    assert sched.last_snapshot is not None and sched.last_snapshot.step_no % 2 == 0
    path = str(tmp_path / "snap.npz")
    snap = sched.save_snapshot(path)
    assert S.load_snapshot(path).step_no == snap.step_no == sched.step_no
    chunked = _port(np_params, batch=2, pool_pages=8, prefill_chunk=8)
    (req,), res = _serve(chunked, _prompts([11]), 3)
    assert req.state == FINISHED and chunked.chunk == 8
    np.testing.assert_array_equal(res[0], _serve(_port(np_params, batch=2, pool_pages=8),
                                                 _prompts([11]), 3)[1][0])
    dense = Server(CFG, ParallelCtx(capacity_factor=8.0), params_from_numpy(np_params),
                   ServeConfig(**_scfg(batch=2, paged=False)), device="cpu")
    with pytest.raises(ValueError, match="paged=True"):
        RequestScheduler(dense)


def test_admission_after_revival_routes_by_table(np_params):
    """Device 1 (expert 3's native slot) dies and revives with blank rows;
    requests admitted afterwards must not read them. The port's prefill
    routes by the committed table, so every stream equals the fault-free
    run's. (The reference's prefill routes to native slots: on this plan
    its request 2 emits a wrong stream; no reference file is changed.)"""
    from repro_torch.runtime.serve import BLANK_WEIGHT

    prompts = _prompts([5, 9, 7, 6])
    arrivals = [0, 0, 6, 7]
    kw = dict(batch=2, pool_pages=12, alpha=0.1)
    _, free = _serve(_port(np_params, **kw), prompts, 6, arrivals=arrivals)
    plan = F.FaultPlan([F.Fault(step=1, kind=F.DEVICE_DEATH, device=1),
                        F.Fault(step=3, kind=F.DEVICE_REVIVAL, device=1)])
    sched = _port(np_params, plan, **kw)
    srv = sched.server
    revive, blank = srv.revive, {}

    def spy(d):
        out = revive(d)
        blank["native"] = bool((srv._moe()["w_gate"][:, 3] == BLANK_WEIGHT).all())
        return out

    srv.revive = spy
    reqs, res = _serve(sched, prompts, 6, arrivals=arrivals)
    assert blank["native"], "the revival scrubbed no native slot"
    assert {"device_death", "device_revival"} <= _fired(sched)
    for r in reqs:
        assert r.state == FINISHED
        np.testing.assert_array_equal(res[r.rid], free[r.rid])
    srv.table.check()
