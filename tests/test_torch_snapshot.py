"""Checkpoints, crash-safe snapshots and elastic glue of the port against
the JAX package.

* ``runtime/checkpoint.py``: the flatten keys and their order are the
  reference's; a file written by either package restores in the other
  (bf16 leaves as the reference stores them, raw 2-byte records);
  retention, torn-file skipping and the background writer.
* ``runtime/snapshot.py``: a snapshot round trip; a snapshot written by
  either package, with a request mid-prefill and migrations in flight,
  restores in both and serves on to the same tokens, tables and events.
* ``crash_restart`` (the reference's ``tests/test_recovery.py`` and
  ``tests/test_scheduler.py::test_crash_restart_mid_prefill``): mid-stream,
  with seed 14's chaos plan and pending migrations, mid-prefill, and the
  ``snapshot_every`` cadence; both packages crash at the same tick with the
  same requests, restore and serve on alike, and every stream equals the
  uninterrupted run's.
* ``runtime/elastic.py``: ``StepTimer``, ``drill_failure`` against the
  reference's, and ``restore_elastic`` onto a 1 x 1 gloo mesh."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.models import transformer as JT
from repro.parallel.ctx import ParallelCtx as JCtx
from repro.runtime import checkpoint as JCk
from repro.runtime import elastic as JE
from repro.runtime import faults as JF
from repro.runtime import snapshot as JS
from repro.runtime.scheduler import RequestScheduler as JScheduler
from repro.runtime.scheduler import SchedulerConfig as JSchedulerConfig
from repro.runtime.serve import ServeConfig as JServeConfig
from repro.runtime.serve import Server as JServer
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.runtime import checkpoint as Ck
from repro_torch.runtime import faults as F
from repro_torch.runtime import snapshot as S
from repro_torch.runtime.elastic import StepTimer, drill_failure, restore_elastic
from repro_torch.runtime.scheduler import (
    FINISHED,
    PREFILLING,
    RequestScheduler,
    SchedulerConfig,
)
from repro_torch.runtime.serve import ServeConfig, Server

torch.set_num_threads(1)
MOE = dataclasses.replace(smoke(get_config("dbrx-132b")), n_experts=4, experts_per_token=2)
JMOE = dataclasses.replace(jsmoke(jget("dbrx-132b")), n_experts=4, experts_per_token=2)
DENSE = smoke(get_config("llama3.2-1b"))
JDENSE = jsmoke(jget("llama3.2-1b"))
MOE_KW = dict(slots_per_device=3, virtual_ep=4)


@pytest.fixture(scope="module")
def moe_np():
    return jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), JMOE))


@pytest.fixture(scope="module")
def skewed_np(moe_np):
    """Hot experts 0 and 1: the balancer keeps migrations in flight."""
    p = jax.tree.map(np.copy, moe_np)
    p["layers"]["moe"]["router"][..., [0, 1]] *= 8.0
    return p


@pytest.fixture(scope="module")
def dense_np():
    return jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), JDENSE))


def _scfg(**kw):
    out = dict(max_seq=64, paged=True, page_size=8)
    out.update(kw)
    return out


def _port(cfg, np_params, plan=None, sched_cfg=None, **kw):
    srv = Server(cfg, ParallelCtx(capacity_factor=8.0), params_from_numpy(np_params),
                 ServeConfig(**_scfg(**kw)), device="cpu")
    return RequestScheduler(srv, sched_cfg, faults=plan)


def _jax(jcfg, np_params, plan=None, sched_cfg=None, **kw):
    srv = JServer(jcfg, JCtx(capacity_factor=8.0), jax.tree.map(jnp.asarray, np_params),
                  JServeConfig(**_scfg(**kw)))
    return JScheduler(srv, sched_cfg, faults=plan)


def _restore_port(path_or_snap, cfg, np_params, plan=None):
    return S.restore_scheduler(path_or_snap, cfg, ParallelCtx(capacity_factor=8.0),
                               params_from_numpy(np_params), faults=plan, device="cpu")


def _restore_jax(path_or_snap, jcfg, np_params, plan=None):
    return JS.restore_scheduler(path_or_snap, jcfg, JCtx(capacity_factor=8.0),
                                jax.tree.map(jnp.asarray, np_params), faults=plan)


def _prompts(lens, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _submit(sched, prompts, arrivals, max_new):
    return [sched.submit(p, max_new_tokens=max_new, arrival=a)
            for p, a in zip(prompts, arrivals)]


def _same_run(ps, js):
    """Equal events (step, kind), streams, states and placement."""
    assert [(s, k) for s, k, _ in ps.events] == [(s, k) for s, k, _ in js.events]
    assert ps.n_preempted == js.n_preempted
    pr, jr = ps.results(), js.results()
    assert pr.keys() == jr.keys()
    for rid in pr:
        np.testing.assert_array_equal(pr[rid], jr[rid])
    assert [r.state for r in ps.requests] == [r.state for r in js.requests]
    if ps.server.table is not None:
        np.testing.assert_array_equal(ps.server.table.slot_of, js.server.table.slot_of)
        np.testing.assert_array_equal(ps.server.table.n_replicas, js.server.table.n_replicas)
        assert ps.server.migrations == js.server.migrations


def _crash(sched, prompts, arrivals, max_new, pkg):
    _submit(sched, prompts, arrivals, max_new)
    with pytest.raises(pkg.SimulatedCrash) as ei:
        sched.run()
    return ei.value


# ---------------------------------------------------------------------------
# checkpoint files
# ---------------------------------------------------------------------------

def _trees():
    """The same tree in both packages' leaf types: nested dicts and lists,
    fp32, int32 and bf16 leaves, a scalar and a None subtree."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    h = rng.standard_normal(5).astype(np.float32)
    steps = np.arange(6, dtype=np.int32)
    port = {"params": {"w": torch.tensor(w), "h_bf16": torch.tensor(h).to(torch.bfloat16)},
            "opt": [torch.tensor(steps), {"lr": np.float32(0.5)}], "cursor": 7, "none": None}
    ref = {"params": {"w": w, "h_bf16": h.astype(ml_dtypes.bfloat16)},
           "opt": [steps, {"lr": np.float32(0.5)}], "cursor": 7, "none": None}
    return port, ref


def test_flatten_keys_match_reference():
    port, ref = _trees()
    flat, jflat = Ck._flatten(port), JCk._flatten(ref)
    assert list(flat) == list(jflat) == [
        "cursor", "opt/0", "opt/1/lr", "params/h_bf16", "params/w"]
    for k in flat:
        # bf16 in memory: raw records in the port, ml_dtypes in the
        # reference; the same bytes, and the same dtype once in a file
        assert flat[k].dtype.itemsize == jflat[k].dtype.itemsize, k
        assert flat[k].tobytes() == jflat[k].tobytes(), k
    assert flat["params/h_bf16"].dtype == np.lib.format.descr_to_dtype(
        np.lib.format.dtype_to_descr(jflat["params/h_bf16"].dtype))


def test_checkpoint_files_cross_packages(tmp_path):
    """Port-written files restore in JAX and JAX-written files in the port,
    bf16 included, bit for bit."""
    port, ref = _trees()
    Ck.save(str(tmp_path / "p.npz"), port, step=3, extra={"who": "port"})
    JCk.save(str(tmp_path / "j.npz"), ref, step=3, extra={"who": "jax"})
    for name in ("p.npz", "j.npz"):
        path = str(tmp_path / name)
        got = Ck.restore(path, port)
        assert got["params"]["h_bf16"].dtype == torch.bfloat16
        assert torch.equal(got["params"]["h_bf16"], port["params"]["h_bf16"])
        assert torch.equal(got["params"]["w"], port["params"]["w"])
        assert torch.equal(got["opt"][0], port["opt"][0])
        assert float(got["opt"][1]["lr"]) == 0.5 and int(got["cursor"]) == 7
        assert got["none"] is None
        jgot = JCk.restore(path, ref)
        np.testing.assert_array_equal(
            np.asarray(jgot["params"]["h_bf16"]).view(ml_dtypes.bfloat16).astype(np.float32),
            ref["params"]["h_bf16"].astype(np.float32))
        np.testing.assert_array_equal(np.asarray(jgot["params"]["w"]), ref["params"]["w"])
        assert Ck.load_meta(path)["step"] == JCk.load_meta(path)["step"] == 3
    assert Ck.load_meta(str(tmp_path / "j.npz"))["who"] == "jax"


def test_checkpoint_manager_retention_and_torn_files(tmp_path, monkeypatch):
    port, _ = _trees()
    mgr = Ck.CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, port, extra={"data_step": step})
    assert mgr.steps() == [2, 3] and mgr.latest() == 3
    # a crash between the npz and the meta replace: a torn step 4
    Ck.save(mgr._path(4), port, 4)
    os.remove(mgr._path(4) + ".meta")
    assert mgr.steps() == [2, 3] and mgr.steps(complete_only=False) == [2, 3, 4]
    tree, meta = mgr.restore(port)
    assert meta["step"] == 3 and meta["data_step"] == 3
    assert torch.equal(tree["params"]["w"], port["params"]["w"])
    # the background writer: the copy is taken before it returns
    live = {"w": torch.ones(3)}
    mgr.async_save(5, live)
    live["w"].add_(1.0)
    mgr.wait()
    assert mgr.steps() == [3, 5]
    assert not os.path.exists(mgr._path(4))      # older than step 5: debris
    Ck.save(mgr._path(9), port, 9)
    os.remove(mgr._path(9) + ".meta")
    mgr.save(6, live)
    assert mgr.steps() == [5, 6]
    assert os.path.exists(mgr._path(9))          # newer: maybe in progress
    tree, _ = mgr.restore({"w": torch.zeros(3)}, step=5)
    assert torch.equal(tree["w"], torch.ones(3))
    def disk_full(*a, **kw):
        raise OSError("no space left on device")

    monkeypatch.setattr(Ck, "save", disk_full)
    mgr.async_save(7, live)
    with pytest.raises(OSError, match="no space"):
        mgr.wait()
    mgr.wait()   # the error was raised once
    empty = Ck.CheckpointManager(str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError):
        empty.restore(port)


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

# request 1's 30-token prompt takes 4 chunk ticks from its admission at
# tick 1: a crash at tick 3 finds it mid-prefill (16 tokens written), with
# the skewed router's first plan of 8 migrations in flight
CROSS = dict(lens=[5, 30, 4, 7, 6], arrivals=[0, 1, 2, 3, 6], crash=3, max_new=6,
             kw=dict(batch=2, pool_pages=12, alpha=0.1, prefill_chunk=8, **MOE_KW))


def test_snapshot_round_trip(skewed_np, tmp_path):
    c = CROSS
    prompts = _prompts(c["lens"], seed=3)
    path = str(tmp_path / "snap.npz")
    plan = F.FaultPlan([F.Fault(step=c["crash"], kind=F.CRASH_RESTART, path=path)])
    crash = _crash(_port(MOE, skewed_np, plan, **c["kw"]), prompts, c["arrivals"],
                   c["max_new"], F)
    snap = crash.snapshot
    assert crash.step == snap.step_no == c["crash"] and crash.path == path
    assert os.path.exists(path) and os.path.exists(path + ".meta")
    assert Ck.load_meta(path)["snapshot"]["version"] == S.SNAPSHOT_VERSION
    back = S.load_snapshot(path)
    for f in dataclasses.fields(S.ServerSnapshot):
        a, b = getattr(snap, f.name), getattr(back, f.name)
        if f.name in ("prompts", "emitted"):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        elif f.name == "table":
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    states = {r["rid"]: (r["state"], r["prefill_pos"]) for r in snap.requests}
    assert states[1] == (PREFILLING, 16)
    assert len(snap.pending_migrations) == 8
    restored = _restore_port(back, MOE, skewed_np)
    assert restored.requests[1].prefill_pos == 0 and restored.queue[1].rid == 1
    assert len(restored.server.driver.in_flight) == 8


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_file_restores_in_both_packages(skewed_np, tmp_path, writer):
    """One package crashes mid-prefill with migrations in flight and writes
    the snapshot; both packages restore it and serve on to the same tokens,
    tables and events, equal to the uninterrupted run's streams."""
    c = CROSS
    prompts = _prompts(c["lens"], seed=3)
    ref = _port(MOE, skewed_np, **c["kw"])
    _submit(ref, prompts, c["arrivals"], c["max_new"])
    want = ref.run()
    path = str(tmp_path / f"{writer}.npz")
    if writer == "port":
        plan = F.FaultPlan([F.Fault(step=c["crash"], kind=F.CRASH_RESTART, path=path)])
        crashed = _port(MOE, skewed_np, plan, **c["kw"])
        _crash(crashed, prompts, c["arrivals"], c["max_new"], F)
    else:
        plan = JF.FaultPlan([JF.Fault(step=c["crash"], kind=JF.CRASH_RESTART, path=path)])
        crashed = _jax(JMOE, skewed_np, plan, **c["kw"])
        _crash(crashed, prompts, c["arrivals"], c["max_new"], JF)
    assert crashed.requests[1].state == PREFILLING and crashed.requests[1].prefill_pos == 16
    ps = _restore_port(path, MOE, skewed_np)
    js = _restore_jax(path, JMOE, skewed_np)
    assert len(ps.server.driver.in_flight) == len(js.server.driver.in_flight) == 8
    ps.run()
    js.run()
    _same_run(ps, js)
    assert ps.server.driver.history == js.server.driver.history
    for rid, tokens in want.items():
        np.testing.assert_array_equal(ps.results()[rid], tokens)
    assert all(r.state == FINISHED for r in ps.requests)


def _crash_case(np_params, cfg, jcfg, tmp_path, crash_step, lens, arrivals, max_new, kw,
                chaos=None, seed=3):
    """Both packages: the uninterrupted run, then a run with a crash at
    ``crash_step`` (plus ``chaos``'s faults), restored from its file and
    served on. Returns the port's pieces for the caller's checks."""
    prompts = _prompts(lens, seed=seed, vocab=cfg.vocab_size)
    ref = _port(cfg, np_params, **kw)
    _submit(ref, prompts, arrivals, max_new)
    want = ref.run()
    out = {}
    for name, pkg, make, restore, c in (("port", F, _port, _restore_port, cfg),
                                        ("jax", JF, _jax, _restore_jax, jcfg)):
        path = str(tmp_path / f"{name}.npz")
        faults = [pkg.Fault(step=crash_step, kind=pkg.CRASH_RESTART, path=path)]
        if chaos:
            faults += list(pkg.FaultPlan.chaos(**chaos))
        plan = pkg.FaultPlan(faults)
        sched = make(c, np_params, plan, **kw)
        crash = _crash(sched, prompts, arrivals, max_new, pkg)
        assert crash.step == crash_step
        states = {r.rid: r.state for r in sched.requests}
        pre = {r.rid: list(r.tokens_out) for r in sched.requests}
        restored = restore(path, c, np_params, plan)
        at_restore = {r.rid: (r.state, r.prefill_pos) for r in restored.requests}
        restored.run()
        out[name] = (sched, restored, states, pre, at_restore)
    (p_crashed, p_rest, states, pre, at_restore), (j_crashed, j_rest, j_states, _, j_at) = (
        out["port"], out["jax"])
    assert at_restore == j_at
    assert [(s, k) for s, k, _ in p_crashed.events] == [(s, k) for s, k, _ in j_crashed.events]
    assert states == j_states
    _same_run(p_rest, j_rest)
    res = p_rest.results()
    for rid, tokens in want.items():
        np.testing.assert_array_equal(res[rid][: len(pre[rid])], pre[rid])
        np.testing.assert_array_equal(res[rid], tokens)
    assert all(r.state == FINISHED for r in p_rest.requests)
    return p_rest, states, at_restore


def test_crash_restart_mid_stream(moe_np, tmp_path):
    """Request 3 admits the tick before the crash, request 4 is still
    queued: the crash catches DECODING and QUEUED requests alike, and the
    crash is not charged to a preemption budget."""
    restored, states, _ = _crash_case(
        moe_np, MOE, JMOE, tmp_path, 4, [5, 9, 4, 7, 6], [0, 1, 2, 3, 6], 6,
        dict(batch=2, pool_pages=10, alpha=0.1, **MOE_KW))
    assert {"DECODING", "QUEUED"} <= set(states.values())
    assert all(r.preemptions == 0 for r in restored.requests)


def test_crash_restart_with_chaos_and_pending_migrations(moe_np, tmp_path):
    """Seed 14's chaos plan with revival (pressure at 1, death at 2, NaN at
    4, revival at 7, ...) and a crash at 5, between the death and the
    revival: the snapshot carries a dead device; the revival re-fires after
    the restore."""
    restored, _, _ = _crash_case(
        moe_np, MOE, JMOE, tmp_path, 5, [5, 9, 4, 7, 6], [0, 1, 2, 3, 7], 6,
        dict(batch=2, pool_pages=10, alpha=0.1, **MOE_KW),
        chaos=dict(seed=14, n_steps=12, n_devices=4, pressure_pages=3, nan_slots=(0,),
                   revive=True))
    fired = {d[0] for _, k, d in restored.events if k == "fault"}
    assert "device_revival" in fired
    assert not restored.server.state.dead
    restored.server.table.check()


def test_crash_restart_mid_prefill(dense_np, tmp_path):
    """The reference's case: request 0's 20-token prompt takes 3 chunk ticks
    from its admission at tick 0, so a crash at tick 1 lands mid-prefill;
    the restore re-prefills it from chunk zero."""
    _, states, at_restore = _crash_case(
        dense_np, DENSE, JDENSE, tmp_path, 1, [20, 6], [0, 1], 5,
        dict(batch=2, pool_pages=16, prefill_chunk=8), seed=0)
    assert states[0] == PREFILLING
    assert at_restore[0] == ("PREEMPTED", 0)   # its chunk KV died: chunk zero


def test_periodic_snapshot_cadence(moe_np, tmp_path):
    """``snapshot_every=3`` snapshots tick boundaries into the file; both
    packages restore the last periodic snapshot and reproduce the
    uninterrupted streams, and the two files hold the same snapshot."""
    prompts = _prompts([5, 8, 6], seed=7)
    kw = dict(batch=2, pool_pages=10, alpha=0.1, **MOE_KW)
    ref = _port(MOE, moe_np, **kw)
    _submit(ref, prompts, [0, 1, 2], 5)
    want = ref.run()
    snaps = {}
    for name, make, cfg_cls in (("port", _port, SchedulerConfig),
                                ("jax", _jax, JSchedulerConfig)):
        path = str(tmp_path / f"{name}.npz")
        sched = make(MOE if name == "port" else JMOE, moe_np,
                     None, cfg_cls(snapshot_every=3, snapshot_path=path), **kw)
        _submit(sched, prompts, [0, 1, 2], 5)
        sched.run()
        assert sched.last_snapshot is not None
        snaps[name] = S.load_snapshot(path)
        assert snaps[name].step_no % 3 == 0
    assert snaps["port"].step_no == snaps["jax"].step_no
    assert snaps["port"].requests == snaps["jax"].requests
    assert snaps["port"].serve_cfg == snaps["jax"].serve_cfg
    ps = _restore_port(str(tmp_path / "jax.npz"), MOE, moe_np)
    js = _restore_jax(str(tmp_path / "port.npz"), JMOE, moe_np)
    ps.run()
    js.run()
    _same_run(ps, js)
    for rid, tokens in want.items():
        np.testing.assert_array_equal(ps.results()[rid], tokens)


# ---------------------------------------------------------------------------
# elastic glue
# ---------------------------------------------------------------------------

def test_step_timer_ratio_before_first_step():
    t = StepTimer()
    assert t.ema is None and t.ratio == 1.0 and not t.is_straggling


def test_step_timer_ema_and_straggler_threshold(monkeypatch):
    clock = iter([0.0, 1.0, 1.0, 2.0, 2.0, 4.0])
    monkeypatch.setattr("repro_torch.runtime.elastic.time.monotonic", lambda: next(clock))
    t = StepTimer(alpha=0.9, threshold=1.5)
    with t:
        pass
    assert t.ema == pytest.approx(1.0) and not t.is_straggling and t.ratio == pytest.approx(1.0)
    with t:
        pass
    assert t.ema == pytest.approx(1.0)
    with t:
        pass
    assert t.ema == pytest.approx(0.9 * 1.0 + 0.1 * 2.0)
    assert t.is_straggling
    assert t.ratio == pytest.approx(2.0 / 1.1, rel=1e-6)


def test_step_timer_zero_ema_ratio(monkeypatch):
    monkeypatch.setattr("repro_torch.runtime.elastic.time.monotonic", lambda: 5.0)
    t = StepTimer()
    with t:
        pass
    assert t.ema == 0.0 and t.ratio == 1.0 and not t.is_straggling


def test_drill_failure_matches_reference(moe_np):
    """Death, rebalance and revival through the stepped migrations: the
    same report, migration records and table as the reference's."""
    srv = _port(MOE, moe_np, batch=2, pool_pages=10, **MOE_KW).server
    jsrv = _jax(JMOE, moe_np, batch=2, pool_pages=10, **MOE_KW).server
    reports = []
    for s, drill in ((srv, drill_failure), (jsrv, JE.drill_failure)):
        s.state.load_ema = np.array([0.5, 0.3, 0.15, 0.05])
        reports.append(drill(s, device=2, revive=True))
    rep, jrep = reports
    assert rep == jrep
    assert rep["supported"] and rep["evacuated"] and rep["revival_recovery_ticks"] > 0
    assert srv.driver.history == jsrv.driver.history
    np.testing.assert_array_equal(srv.table.slot_of, jsrv.table.slot_of)
    assert srv.driver.pending == 0 and 2 in srv.table.committed_devices()
    srv.table.check()
    dense = Server(DENSE, ParallelCtx(), T.init_params(DENSE, device="cpu"),
                   ServeConfig(**_scfg(batch=2)), device="cpu")
    assert drill_failure(dense, 0) == {"supported": False}


def test_restore_elastic_onto_a_gloo_mesh(tmp_path):
    """A checkpoint written with no mesh restores onto a 1 x 1 mesh of a
    gloo world of one: each rank takes its slot rows (``sharding.
    slot_rows``) as tensors, bit for bit; with no mesh the host arrays come
    back as they are."""
    from repro_torch.parallel.mesh import make_mesh

    state = {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "b": np.ones(4, np.float32)}
    mgr = Ck.CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    mgr.save(7, state, extra={"data_step": 7})
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)

        def sharding_fn(mesh, template):
            rows = sharding.slot_rows(3, mesh.model, mesh.model_rank)
            return {"w": lambda a: torch.as_tensor(a[rows]), "b": torch.as_tensor}

        restored, meta = restore_elastic(mgr, state, mesh, sharding_fn)
    finally:
        dist.destroy_process_group()
    assert meta["step"] == 7 and meta["data_step"] == 7
    for k in state:
        assert isinstance(restored[k], torch.Tensor)
        np.testing.assert_array_equal(restored[k].numpy(), state[k])
    host, _ = restore_elastic(mgr, state, None, sharding_fn)
    np.testing.assert_array_equal(host["w"], state["w"])
