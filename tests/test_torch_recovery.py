"""Device death, revival and stragglers in the PyTorch port, against the
JAX package on the same seeded tables, loads and reports:

* the placement table's constructors, views and mutations;
* the balancer's heats, plans (Algorithm 1, the greedy baseline,
  evacuation, revival), pruning and replica shares;
* the migration driver under a device death (abort and requeue when the
  destination dies, fast-forward when the source dies);
* ``Server.mark_dead`` / ``revive`` / ``report_step_time`` on bridged
  weights: equal tables, balancer state and expert rows, blank rows at
  ``BLANK_WEIGHT``, committed orphans spared.

Plans, tables and records must be equal; fp32 weights bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget
from repro.configs import smoke as jsmoke
from repro.core import ni_balancer as JB
from repro.models import transformer as JT
from repro.parallel.ctx import ParallelCtx as JCtx
from repro.parallel.placement import PlacementTable as JTable
from repro.runtime.migration_driver import MigrationDriver as JDriver
from repro.runtime.serve import ServeConfig as JServeConfig
from repro.runtime.serve import Server as JServer
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke
from repro_torch.core import ni_balancer as B
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.mesh import make_mesh
from repro_torch.parallel.placement import PlacementError, PlacementTable
from repro_torch.runtime.migration_driver import MigrationDriver
from repro_torch.runtime.serve import BLANK_WEIGHT, ServeConfig, Server

torch.set_num_threads(1)
CFG = dataclasses.replace(smoke(get_config("dbrx-132b")), n_experts=4, experts_per_token=2)
JCFG = dataclasses.replace(jsmoke(jget("dbrx-132b")), n_experts=4, experts_per_token=2)
MOE = ("w_gate", "w_up", "w_down")


def _dist(a, b):
    return abs(a - b)


def _same_table(t, jt):
    np.testing.assert_array_equal(t.slot_of, jt.slot_of)
    np.testing.assert_array_equal(t.n_replicas, jt.n_replicas)
    assert t.pending == jt.pending and t.version == jt.version


def _states(seed, n_experts=8, n_devices=4, spd=4, n_moves=6):
    """A JAX and a port BalancerState on the same round-robin table, skewed
    loads and a few committed replicas."""
    rng = np.random.default_rng(seed)
    js = JB.BalancerState.initial(n_experts, n_devices, spd)
    ps = B.BalancerState.initial(n_experts, n_devices, spd)
    load = rng.dirichlet(np.full(n_experts, 0.5))
    js.load_ema, ps.load_ema = load.copy(), load.copy()
    for _ in range(n_moves):
        e = int(rng.integers(n_experts))
        src, dst = js.replicas[e][0], int(rng.integers(n_devices))
        if js.table.try_reserve(e, dst) is None:
            continue
        js.table.release_pending(e, js.table.pending[-1][1])
        js.apply((e, src, dst))
        ps.apply((e, src, dst))
    return js, ps


# ---------------------------------------------------------------------------
# the placement table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 4, 1), (8, 4, 3), (6, 2, 4), (16, 4, 5)])
def test_round_robin_views_match_reference(shape):
    n_experts, n_devices, spd = shape
    t = PlacementTable.round_robin(n_experts, n_devices, spd)
    jt = JTable.round_robin(n_experts, n_devices, spd)
    _same_table(t, jt)
    np.testing.assert_array_equal(t.owner_of_slots(), jt.owner_of_slots())
    assert t.committed_devices() == jt.committed_devices()
    with pytest.raises(PlacementError, match="slots"):
        PlacementTable.round_robin(n_devices * spd + 1, n_devices, spd)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_mutations_match_reference(seed):
    """A seeded sequence of apply / remove_replica / drop_device: equal
    returns, tables, owners and committed devices after every step."""
    rng = np.random.default_rng(seed)
    t = PlacementTable.uniform(6, 12, 3)
    jt = JTable.uniform(6, 12, 3)
    for _ in range(24):
        op = rng.integers(3)
        e = int(rng.integers(6))
        if op == 0:
            d = int(rng.integers(4))
            assert t.apply(e, d) == jt.apply(e, d)
        elif op == 1:
            r = int(rng.integers(jt.n_replicas[e]))
            if jt.n_replicas[e] == 1:
                with pytest.raises(PlacementError, match="only replica"):
                    t.remove_replica(e, r)
                continue
            assert t.remove_replica(e, r) == jt.remove_replica(e, r)
        else:
            d = int(rng.integers(4))
            assert t.drop_device(d) == jt.drop_device(d)
        _same_table(t, jt)
        np.testing.assert_array_equal(t.owner_of_slots(), jt.owner_of_slots())
        assert t.committed_devices() == jt.committed_devices()
        t.check()
    with pytest.raises(PlacementError, match="no replica column"):
        t.remove_replica(0, 4)


def test_drop_device_keeps_sole_copies():
    t = PlacementTable.uniform(4, 6, 2)
    assert t.apply(0, 2) == 4
    assert t.drop_device(1) == 0          # experts 2, 3 keep their only copy
    assert t.committed_devices() == {0, 1, 2}
    assert t.drop_device(0) == 1          # expert 0 still lives on device 2
    assert t.committed_slots(0) == [4] and (t.slot_of[0] == 4).all()
    assert t.committed_slots(1) == [1]    # expert 1's only copy stays


# ---------------------------------------------------------------------------
# the balancer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_balancer_views_and_plans_match_reference(seed):
    js, ps = _states(seed)
    slow = np.random.default_rng(seed + 100).uniform(0.5, 3.0, js.n_devices)
    for st in (js, ps):
        st.slowdown = slow.copy()
    np.testing.assert_array_equal(ps.num_replicas(), js.num_replicas())
    assert ps.device_experts() == js.device_experts()
    np.testing.assert_array_equal(ps.heats(), js.heats())
    np.testing.assert_array_equal(ps.device_token_share(), js.device_token_share())
    for a, b in zip(B.replica_shares(ps), JB.replica_shares(js)):
        np.testing.assert_array_equal(a, b)
    assert B.greedy_balance(ps) == JB.greedy_balance(js)
    assert B.greedy_balance(ps, max_migrations=1) == JB.greedy_balance(js, max_migrations=1)
    assert B.topology_aware_balance(ps, _dist) == JB.topology_aware_balance(js, _dist)
    # a dead device: infinite heat, never a destination, never the hottest
    for st in (js, ps):
        st.mark_dead(2)
    np.testing.assert_array_equal(ps.heats(), js.heats())
    assert np.isinf(ps.heats()[2])
    assert B.greedy_balance(ps) == JB.greedy_balance(js)
    assert B.topology_aware_balance(ps, _dist) == JB.topology_aware_balance(js, _dist)
    for st in (js, ps):
        st.revive(2)
    assert ps.dead == js.dead == set() and ps.slowdown[2] == 1.0
    np.testing.assert_array_equal(ps.slowdown, js.slowdown)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("frac", [0.5, 2.0])
def test_prune_replicas_matches_reference(seed, frac):
    js, ps = _states(seed, n_moves=10)
    assert B.prune_replicas(ps, frac) == JB.prune_replicas(js, frac)
    _same_table(ps.table, js.table)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_evacuate_and_revival_plan_match_reference(seed):
    """Death of a device with orphans: equal evacuation plans and tables;
    then drop, revive and seed it: equal revival plans, applied equally."""
    rng = np.random.default_rng(seed)
    js, ps = _states(seed, n_experts=8, n_devices=4, spd=3, n_moves=3)
    dev = int(rng.integers(1, 4))
    plan = B.evacuate(ps, dev, _dist)
    assert plan == JB.evacuate(js, dev, _dist)
    assert ps.dead == js.dead == {dev}
    _same_table(ps.table, js.table)
    assert ps.drop_device(dev) == js.drop_device(dev)
    _same_table(ps.table, js.table)
    with pytest.raises(PlacementError, match="still marked dead"):
        B.revival_plan(ps, dev, _dist)
    for st in (js, ps):
        st.revive(dev)
    for cap in (None, 1):
        rp = B.revival_plan(ps, dev, _dist, max_seed=cap)
        assert rp == JB.revival_plan(js, dev, _dist, max_seed=cap)
        assert all(d == dev for _, _, d in rp)
    for mig in rp:
        ps.apply(mig)
        js.apply(mig)
    _same_table(ps.table, js.table)
    np.testing.assert_array_equal(ps.heats(), js.heats())


def test_balancer_apply_raises_like_reference():
    ps = B.BalancerState.initial(4, 4, 1)
    with pytest.raises(PlacementError, match="hosts no replica"):
        ps.apply((0, 1, 2))
    with pytest.raises(PlacementError, match="cannot take a replica"):
        ps.apply((0, 0, 1))              # device 1's only slot is taken
    with pytest.raises(ValueError, match="not enough slots"):
        B.BalancerState.initial(5, 2, 2)


# ---------------------------------------------------------------------------
# the migration driver under a device death
# ---------------------------------------------------------------------------

def _weights(seed, n_slots=12):
    rng = np.random.default_rng(seed)
    return {w: rng.standard_normal((2, n_slots, 12, 5)).astype(np.float32) for w in MOE}


def test_handle_device_death_matches_reference():
    """Three in-flight migrations, one to the dying device (aborted and
    requeued through ``retarget``), one from it (fast-forwarded and
    committed), one elsewhere (untouched): equal records, tables, in-flight
    ledgers and weight rows."""
    w = _weights(0)
    moe = {k: torch.tensor(v) for k, v in w.items()}
    jmoe = {k: jnp.asarray(v) for k, v in w.items()}
    t, jt = PlacementTable.uniform(4, 12, 3), JTable.uniform(4, 12, 3)
    drv, jdrv = MigrationDriver(t, min_slices=4), JDriver(jt, min_slices=4)
    plan = [(1, 0, 2), (3, 1, 3), (0, 0, 3)]
    assert drv.submit(plan, moe, 0) == jdrv.submit(plan, jmoe, 0) == plan
    for tick in (1, 2):
        assert drv.tick(moe, tick) == jdrv.tick(jmoe, tick)
    # kill device 1 (the source of expert 3's copy), then device 3 (the
    # destination of expert 0's); retarget aims at device 2
    retarget = lambda mig: (mig[0], 0, 2)  # noqa: E731
    for dev, t_now in ((1, 3), (3, 4)):
        out = drv.handle_device_death(dev, moe, t_now, retarget=retarget)
        jout = jdrv.handle_device_death(dev, jmoe, t_now, retarget=retarget)
        assert out == jout
        _same_table(t, jt)
        assert drv.export_in_flight() == jdrv.export_in_flight()
    assert [r["mig"] for r in drv.aborted] == [(0, 0, 3)]
    assert [r["mig"] for r in drv.history] == [(3, 1, 3)]
    assert out["requeued"] == [(0, 0, 2)]
    assert drv.history == jdrv.history and drv.aborted == jdrv.aborted
    while drv.pending:
        drv.tick(moe, 9)
        jdrv.tick(jmoe, 9)
    _same_table(t, jt)
    for k in MOE:
        np.testing.assert_array_equal(moe[k].numpy(), np.asarray(jmoe[k]))
    for e in range(4):                 # every committed replica is an exact copy
        for s in t.committed_slots(e):
            for k in MOE:
                assert torch.equal(moe[k][:, s], moe[k][:, e])
    t.check()


def test_handle_device_death_requeues_from_slice_zero():
    w = _weights(1)
    moe = {k: torch.tensor(v) for k, v in w.items()}
    jmoe = {k: jnp.asarray(v) for k, v in w.items()}
    t, jt = PlacementTable.uniform(4, 12, 3), JTable.uniform(4, 12, 3)
    drv, jdrv = MigrationDriver(t, min_slices=4), JDriver(jt, min_slices=4)
    drv.submit([(2, 0, 3)], moe, 0)
    jdrv.submit([(2, 0, 3)], jmoe, 0)
    drv.tick(moe, 1)
    jdrv.tick(jmoe, 1)
    retarget = lambda mig: (mig[0], 0, 1)  # noqa: E731
    out = drv.handle_device_death(3, moe, 2, retarget=retarget)
    assert out == jdrv.handle_device_death(3, jmoe, 2, retarget=retarget)
    assert out["requeued"] == [(2, 0, 1)]
    assert drv.export_in_flight() == jdrv.export_in_flight() == [
        {"mig": [2, 0, 1], "next_slice": 0, "n_slices": 4, "submitted": 2}]
    assert t.pending == jt.pending == ((2, 4),)   # device 1's first free slot


# ---------------------------------------------------------------------------
# the Server on bridged weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), JCFG))


def _servers(np_params, **kw):
    scfg = dict(max_seq=32, batch=2, paged=True, page_size=8, alpha=0.1, **kw)
    js = JServer(JCFG, JCtx(capacity_factor=8.0), jax.tree.map(jnp.asarray, np_params),
                 JServeConfig(**scfg))
    ps = Server(CFG, ParallelCtx(capacity_factor=8.0), params_from_numpy(np_params),
                ServeConfig(**scfg), device="cpu")
    return ps, js


def _same_server(ps, js):
    _same_table(ps.table, js.table)
    assert ps.state.dead == js.state.dead
    np.testing.assert_array_equal(ps.state.load_ema, js.state.load_ema)
    if js.state.slowdown is None:
        assert ps.state.slowdown is None
    else:
        np.testing.assert_array_equal(ps.state.slowdown, js.state.slowdown)
    for k in MOE:
        np.testing.assert_array_equal(ps._moe()[k].numpy(), np.asarray(js._moe()[k]))
    assert ps.migrations == js.migrations
    if js.driver is not None:
        assert ps.driver.export_in_flight() == js.driver.export_in_flight()
        assert ps.driver.history == js.driver.history
        assert ps.driver.aborted == js.driver.aborted


@pytest.mark.parametrize("migration_slices", [4, 0])
def test_server_death_revival_straggler_match_reference(np_params, migration_slices):
    """Virtual EP over 4 devices x 3 slots with migrations in flight: the
    same death, straggler reports and revival give the same evacuation and
    revival plans, tables, balancer state and expert rows; the revived
    device's free rows read BLANK_WEIGHT until their copies land."""
    ps, js = _servers(np_params, slots_per_device=3, virtual_ep=4,
                      migration_slices=migration_slices)
    load = np.array([0.1, 0.2, 0.3, 0.4])
    for s in (ps, js):
        s.state.load_ema = load.copy()
    plan = [(0, 0, 1), (1, 0, 3), (2, 0, 2)]
    assert ps.apply_plan(plan) == js.apply_plan(plan)
    assert ps.drain_migrations() == js.drain_migrations()
    _same_server(ps, js)
    for s in (ps, js):
        s.report_step_time(1, 2.5)
        s.report_step_time(1, 4.0)
    evac = ps.mark_dead(1)
    assert evac == js.mark_dead(1) and evac    # expert 3's only copy moves
    _same_server(ps, js)
    assert ps.mark_dead(3) == js.mark_dead(3)
    _same_server(ps, js)
    assert ps.table.committed_devices() <= {0, 2}
    seeded = ps.revive(3)
    assert seeded == js.revive(3) and seeded
    _same_server(ps, js)
    used = ps.table.used_slots(include_pending=False)
    for s in range(9, 12):
        if not used[s] and all(s != d for _, d in ps.table.pending):
            for k in MOE:
                assert (ps._moe()[k][:, s] == BLANK_WEIGHT).all()
    while ps.driver is not None and ps.driver.pending:
        ps.drain_migrations()
        js.drain_migrations()
    _same_server(ps, js)
    ps.table.check()


def test_revive_spares_committed_orphans(np_params):
    """Every slot is taken by a native expert: device 1's experts cannot be
    evacuated, keep their only copy there, and revival spares those rows
    (nothing is scrubbed), as the reference does."""
    ps, js = _servers(np_params, slots_per_device=2, virtual_ep=2)
    before = {k: ps._moe()[k].clone() for k in MOE}
    assert ps.mark_dead(1) == js.mark_dead(1) == []
    assert ps.table.committed_devices() == {0, 1}
    assert ps.revive(1) == js.revive(1)
    _same_server(ps, js)
    for k in MOE:
        assert torch.equal(ps._moe()[k], before[k])


def test_server_fault_guards(np_params):
    ps, js = _servers(np_params, slots_per_device=3, virtual_ep=4)
    with pytest.raises(ValueError, match="not dead"):
        ps.revive(1)
    with pytest.raises(ValueError, match="EP axis"):
        ps.revive(99)
    with pytest.raises(ValueError, match="EP axis"):
        ps.report_step_time(4, 2.0)
    for bad in (0.0, -1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="finite positive"):
            ps.report_step_time(1, bad)
    assert ps.state.slowdown is None        # no bad report was folded in
    # ESP serves the experts' own weights: nothing to evacuate or revive
    esp = Server(CFG, ParallelCtx(moe_impl="esp"), params_from_numpy(np_params),
                 ServeConfig(max_seq=32, batch=2, paged=True, page_size=8), device="cpu")
    assert esp.mark_dead(1) == [] and esp.report_step_time(1, 2.0) is None
    with pytest.raises(ValueError, match="balancer"):
        esp.revive(1)


def test_death_and_revival_under_a_mesh_raise(np_params, tmp_path):
    """Once refused under a mesh, death and revival now serve there: on a 1
    x 1 gloo mesh with virtual EP over 4 devices (every slot row on the one
    rank), the same death, straggler report and revival as the reference
    Server's with no mesh give the same plans, tables, balancer state and
    expert rows, blank rows at ``BLANK_WEIGHT`` included. Four ranks:
    ``tests/test_torch_mesh_serve.py``."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        _, js = _servers(np_params, slots_per_device=3, virtual_ep=4)
        ps = Server(CFG, ParallelCtx(mesh=make_mesh(1, 1), capacity_factor=8.0),
                    params_from_numpy(np_params),
                    ServeConfig(max_seq=32, batch=2, paged=True, page_size=8, alpha=0.1,
                                slots_per_device=3, virtual_ep=4), device="cpu")
        assert ps.apply_plan([(0, 0, 2), (1, 0, 3)]) == js.apply_plan([(0, 0, 2), (1, 0, 3)])
        ps.drain_migrations()
        js.drain_migrations()
        plan = ps.mark_dead(2)
        assert plan == js.mark_dead(2)
        ps.report_step_time(1, 2.0)
        js.report_step_time(1, 2.0)
        _same_server(ps, js)
        seeded = ps.revive(2)
        assert seeded == js.revive(2) and seeded
        _same_server(ps, js)
        blank = [s for s in range(6, 9) if ps.table.owner_of_slots()[s] < 0]
        assert blank
        for k in MOE:
            assert (ps._moe()[k][:, blank] == BLANK_WEIGHT).all()
        while ps.driver.pending:
            ps.drain_migrations()
            js.drain_migrations()
        _same_server(ps, js)
        ps.table.check()
    finally:
        dist.destroy_process_group()
