"""The port's analytic model (``repro_torch.core``: topology, hardware,
ER/HER mappings, FTD statistics, the Eq. 1 communication model, the paper
models, load traces, the cold-link migration engine and the simulator)
against the JAX package's ``repro.core`` on the same inputs.

Both sides are numpy and run the same operations in the same order, so
every comparison is exact (``np.array_equal``, ``==``): a difference is a
fault of the copy, not rounding. The meshes and (dp, tp) pairs are the
ones the paper's figures use (one wafer of 4x4, 6x6 and 8x8, two wafers of
8x8)."""

import dataclasses

import numpy as np
import pytest

from repro.core import comm_model as JC
from repro.core import er_mapping as JE
from repro.core import ftd as JF
from repro.core import hardware as JH
from repro.core import migration as JM
from repro.core import simulator as JS
from repro.core import topology as JT
from repro.core import traces as JR
from repro.core import workloads as JW
from repro_torch.core import comm_model as C
from repro_torch.core import er_mapping as E
from repro_torch.core import ftd as F
from repro_torch.core import hardware as H
from repro_torch.core import migration as M
from repro_torch.core import simulator as S
from repro_torch.core import topology as T
from repro_torch.core import traces as R
from repro_torch.core import workloads as W

TOPOS = {"4x4": (4, 4, 1), "6x6": (6, 6, 1), "8x8": (8, 8, 1), "2x(8x8)": (8, 8, 2)}
# (topology, dp, tp) as fig06 and fig13a-d place them
PAIRS = [("4x4", 4, 4), ("4x4", 2, 8), ("6x6", 6, 6), ("6x6", 4, 9), ("6x6", 9, 4),
         ("8x8", 8, 8), ("8x8", 4, 16), ("8x8", 16, 4), ("2x(8x8)", 8, 16)]
PLACED = [(t, dp, tp, m) for t, dp, tp in PAIRS for m in ("baseline", "er", "her")]
IDS = [f"{t}-dp{dp}xtp{tp}-{m}" for t, dp, tp, m in PLACED]


def _topos(name):
    return T.MeshTopology(*TOPOS[name]), JT.MeshTopology(*TOPOS[name])


def _mappings(name, dp, tp, kind):
    t, jt = _topos(name)
    return E.MAPPINGS[kind](t, dp, tp), JE.MAPPINGS[kind](jt, dp, tp)


def _traffic(n, seed, density=0.3):
    rng = np.random.default_rng(seed)
    vol = rng.uniform(1e3, 1e6, size=(n, n)) * (rng.random((n, n)) < density)
    vol[0, 1] = 0.0
    return {(s, d): float(vol[s, d]) for s in range(n) for d in range(n)}


def _same_result(r, jr):
    assert (r.time, r.transfer, r.latency, r.max_link_bytes) == (
        jr.time, jr.transfer, jr.latency, jr.max_link_bytes)
    if jr.link_loads is None:
        assert r.link_loads is None
    else:
        assert np.array_equal(r.link_loads, jr.link_loads)


@pytest.mark.parametrize("name", list(TOPOS))
def test_topology_links_routes_loads(name):
    t, jt = _topos(name)
    assert (t.global_cols, t.n_devices, t.n_links) == (jt.global_cols, jt.n_devices, jt.n_links)
    assert t.links == jt.links and t.link_index == jt.link_index
    assert list(t.coords()) == list(jt.coords())
    assert [t.wafer_of(c) for c in t.coords()] == [jt.wafer_of(c) for c in jt.coords()]
    assert [t.is_cross_wafer(l) for l in t.links] == [jt.is_cross_wafer(l) for l in jt.links]
    if name == "2x(8x8)":
        assert sum(t.is_cross_wafer(l) for l in t.links) == 2 * t.rows
    for s in range(t.n_devices):
        for d in range(t.n_devices):
            a, b = t.coord(s), t.coord(d)
            assert t.route(a, b) == jt.route(a, b)
            assert t.hops(a, b) == jt.hops(a, b) == len(t.route(a, b))
    traffic = _traffic(t.n_devices, seed=len(name))
    loads = t.link_loads(traffic)
    assert np.array_equal(loads, jt.link_loads(traffic))
    assert t.max_hops(traffic) == jt.max_hops(traffic)
    assert t.load_grid(loads) == jt.load_grid(loads)


@pytest.mark.parametrize("name,dp,tp,kind", PLACED, ids=IDS)
def test_mapping_placement(name, dp, tp, kind):
    m, jm = _mappings(name, dp, tp, kind)
    assert (m.dp, m.tp, m.name) == (jm.dp, jm.tp, jm.name)
    assert m.tp_groups == jm.tp_groups and m.ftds == jm.ftds
    for a in ("group_of", "rank_of", "ftd_of"):
        assert np.array_equal(getattr(m, a), getattr(jm, a)), a
    assert np.array_equal(m.device_order(), jm.device_order())
    assert m.device_order().shape == (dp, tp)
    for g in range(dp):
        assert m.ring_hop_distances(g) == jm.ring_hop_distances(g)
    assert m.max_ring_hop() == jm.max_ring_hop()


def _outcome(ctor, topo, dp, tp):
    try:
        m = ctor(topo, dp, tp)
    except ValueError as e:
        return str(e)
    return m.tp_groups, m.ftds


@pytest.mark.parametrize("kind", ["baseline", "er", "her"])
def test_mapping_refusals(kind):
    """Off the figures' pairs the same inputs give the same placement or
    the same refusal: dp x tp not the device count (every kind), a tp that
    does not divide over the wafers (HER), three wafers."""
    cases = [((4, 4, 1), 4, 8), ((6, 6, 1), 12, 3), ((4, 4, 3), 12, 4),
             ((4, 4, 3), 3, 16), ((4, 4, 2), 2, 16)]
    outcomes = [(_outcome(E.MAPPINGS[kind], T.MeshTopology(*t), dp, tp),
                 _outcome(JE.MAPPINGS[kind], JT.MeshTopology(*t), dp, tp))
                for t, dp, tp in cases]
    for got, want in outcomes:
        assert got == want
    refused = [o for o, _ in outcomes if isinstance(o, str)]
    assert len(refused) == (3 if kind == "her" else 1), refused


@pytest.mark.parametrize("name,dp,tp,kind", PLACED, ids=IDS)
def test_ftd_stats(name, dp, tp, kind):
    m, jm = _mappings(name, dp, tp, kind)
    assert dataclasses.asdict(F.ftd_stats(m)) == dataclasses.asdict(JF.ftd_stats(jm))


@pytest.mark.parametrize("name,dp,tp,kind", PLACED, ids=IDS)
def test_comm_model_collectives(name, dp, tp, kind):
    m, jm = _mappings(name, dp, tp, kind)
    b = 256 * 4096 * 2.0
    for pl, jpl in ((H.WSC, JH.WSC), (H.DGX, JH.DGX)):
        for ag in (True, False):
            _same_result(C.mesh_allreduce(m, pl, b, ag), JC.mesh_allreduce(jm, jpl, b, ag))
        _same_result(C.mesh_allreduce(m, pl, b, groups=m.ftds),
                     JC.mesh_allreduce(jm, jpl, b, groups=jm.ftds))
        _same_result(C.hier_allreduce(m, pl, b), JC.hier_allreduce(jm, jpl, b))
    load = np.random.default_rng(dp * tp + tp).gamma(2.0, 0.5, m.topo.n_devices)
    for dl in (None, load):
        wl, jwl = C.A2AWorkload(256, 8192, 8, dl), JC.A2AWorkload(256, 8192, 8, dl)
        for ag in (True, False):
            _same_result(C.mesh_alltoall(m, H.WSC, wl, ag),
                         JC.mesh_alltoall(jm, JH.WSC, jwl, ag))
        ar, a2a = C.link_heatmaps(m, H.WSC, b, wl)
        jar, ja2a = JC.link_heatmaps(jm, JH.WSC, b, jwl)
        assert np.array_equal(ar, jar) and np.array_equal(a2a, ja2a)
        for frac in (0.05, 0.3):
            assert np.array_equal(C.cold_links(ar, frac), JC.cold_links(jar, frac))
            assert np.array_equal(C.cold_links(a2a, frac), JC.cold_links(ja2a, frac))
    assert np.array_equal(C.cold_links(np.zeros(4)), JC.cold_links(np.zeros(4)))
    traffic = _traffic(m.topo.n_devices, seed=dp)
    got, want = (C.route_traffic(m.topo, traffic, H.WSC),
                 JC.route_traffic(jm.topo, traffic, JH.WSC))
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    n = m.topo.n_devices
    for s, d in ((0, n - 1), (n - 1, 0), (dp, tp), (3, 3)):
        assert (C._route_time(m.topo, H.WSC, s, d, 42e6)
                == JC._route_time(jm.topo, JH.WSC, s, d, 42e6))


@pytest.mark.parametrize("name", ["WSC", "DGX", "NVL72"])
def test_platforms_and_cluster_models(name):
    assert set(H.PLATFORMS) == {"WSC", "DGX", "NVL72"}
    p, jp = H.PLATFORMS[name], JH.PLATFORMS[name]
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    for fl, by in ((1e12, 1e9), (1e9, 1e12), (0.0, 0.0)):
        assert p.device.compute_time(fl, by) == jp.device.compute_time(fl, by)
    for n in (8, 16, 32, 64, 72, 256):
        for b in (1.0, 3.5e6):
            _same_result(C.cluster_allreduce(p, n, b), JC.cluster_allreduce(jp, n, b))
            for imb, hf in ((1.0, 2.0), (2.7, 1.0), (1.3, 0.5)):
                _same_result(C.cluster_alltoall(p, n, b, imb, hf),
                             JC.cluster_alltoall(jp, n, b, imb, hf))


@pytest.mark.parametrize("name", list(JW.PAPER_MODELS))
def test_paper_models(name):
    assert list(W.PAPER_MODELS) == list(JW.PAPER_MODELS)
    m, jm = W.PAPER_MODELS[name], JW.PAPER_MODELS[name]
    assert dataclasses.asdict(m) == dataclasses.asdict(jm)
    for a in ("expert_bytes", "expert_flops_token", "token_bytes", "attn_flops_token"):
        assert getattr(m, a) == getattr(jm, a), a


@pytest.mark.parametrize("seed", [0, 3])
def test_traces(seed):
    assert R.SCENARIOS == JR.SCENARIOS
    for sc in R.SCENARIOS:
        assert np.array_equal(R.scenario_popularity(64, sc, seed),
                              JR.scenario_popularity(64, sc, seed))
        tr, jtr = (R.single_scenario_trace(64, 2048, 30, sc, seed),
                   JR.single_scenario_trace(64, 2048, 30, sc, seed))
        assert np.array_equal(tr.loads, jtr.loads) and tr.scenario == jtr.scenario
    tr, jtr = (R.mixed_scenario_trace(256, 8192, 40, period=20, seed=seed),
               JR.mixed_scenario_trace(256, 8192, 40, period=20, seed=seed))
    assert np.array_equal(tr.loads, jtr.loads)
    assert (tr.scenario, tr.n_iterations, tr.n_experts) == ("mixed", 40, 256)
    for n in (8, 64):
        assert np.array_equal(R.device_load_ratios(tr.loads, n),
                              JR.device_load_ratios(jtr.loads, n))


@pytest.mark.parametrize("kind", ["baseline", "er"])
@pytest.mark.parametrize("mode", ["noninvasive", "invasive"])
def test_migration_engine(kind, mode):
    from repro_torch.runtime import migration_driver

    assert migration_driver.decompose is M.decompose   # one decomposition
    m, jm = _mappings("8x8", 8, 8, kind)
    migs = [(0, 0, 63), (1, 9, 10), (2, 7, 56), (3, 27, 36), (4, 63, 0), (5, 18, 45)]
    eb = W.DEEPSEEK_V3.expert_bytes
    for mig in migs:
        assert ([dataclasses.asdict(s) for s in M.decompose(mig, m, eb)]
                == [dataclasses.asdict(s) for s in JM.decompose(mig, jm, eb)])
    wl, jwl = C.A2AWorkload(256, 14336, 8), JC.A2AWorkload(256, 14336, 8)
    ar, a2a = C.link_heatmaps(m, H.WSC, 256 * 14336, wl)
    jar, ja2a = JC.link_heatmaps(jm, JH.WSC, 256 * 14336, jwl)
    eng, jeng = M.MigrationEngine(m, H.WSC, eb, mode), JM.MigrationEngine(jm, JH.WSC, eb, mode)
    assert eng.submit(migs[:4]) == jeng.submit(migs[:4])
    for it, phase in enumerate((2e-6, 2e-5, 2e-5, 1e-4, 1e-3, 1e-3, 1e-2)):
        if it == 2:
            assert eng.submit(migs[4:]) == jeng.submit(migs[4:])
        loads = ((ar, a2a), (jar, ja2a)) if it % 2 else ((None, None), (None, None))
        done = eng.step_iteration(phase, 2 * phase, *loads[0])
        assert done == jeng.step_iteration(phase, 2 * phase, *loads[1])
        assert eng.pending == jeng.pending
        assert ([(f.step_idx, [s.sent for s in f.steps]) for f in eng.in_flight]
                == [(f.step_idx, [s.sent for s in f.steps]) for f in jeng.in_flight])
    assert eng.completed == jeng.completed and eng.total_exposed == jeng.total_exposed
    assert eng.pending == 0 and len(eng.completed) == len(migs)
    assert (eng.total_exposed > 0) == (mode == "invasive")


SYSTEMS = {
    "4x4-er": lambda P: P[0].WSCSystem(P[1].WSC, P[2].er_mapping(P[3].MeshTopology(4, 4), 4, 4)),
    "6x6-baseline": lambda P: P[0].WSCSystem(
        P[1].WSC, P[2].baseline_mapping(P[3].MeshTopology(6, 6), 6, 6)),
    "2x(8x8)-her": lambda P: P[0].WSCSystem(
        P[1].WSC, P[2].hierarchical_er_mapping(P[3].MeshTopology(8, 8, 2), 8, 16),
        hierarchical=True),
    "dgx32": lambda P: P[0].ClusterSystem(P[1].DGX, 32, tp=8),
    "nvl72": lambda P: P[0].ClusterSystem(P[1].NVL72, 72, tp=8),
}
TP = {"4x4-er": 4, "6x6-baseline": 6, "2x(8x8)-her": 16, "dgx32": 8, "nvl72": 8}
PORT, REF = (S, H, E, T), (JS, JH, JE, JT)


@pytest.mark.parametrize("system", list(SYSTEMS))
def test_simulate_iteration(system):
    """Every paper model (DBRX and Mixtral in the ESP regime on the larger
    systems) at two token counts and 1 or 4 pipeline stages, balanced."""
    sys_, jsys = SYSTEMS[system](PORT), SYSTEMS[system](REF)
    for name, model in W.PAPER_MODELS.items():
        for tokens in (32, 256):
            for stages in (1, 4):
                bd = S.simulate_iteration(model, sys_, tokens, TP[system], stages=stages)
                jbd = JS.simulate_iteration(JW.PAPER_MODELS[name], jsys, tokens,
                                            TP[system], stages=stages)
                assert dataclasses.asdict(bd) == dataclasses.asdict(jbd), (name, tokens)


@pytest.mark.parametrize("balancer", ["none", "greedy", "topo", "topo_ni"])
@pytest.mark.parametrize("system", ["4x4-er", "6x6-baseline", "dgx32"])
def test_run_serving_trace(system, balancer):
    """A short drifting trace through the Eq. 2 trigger, the port's own
    balancer and placement table, the migration engine and the layer
    times."""
    sys_, jsys = SYSTEMS[system](PORT), SYSTEMS[system](REF)
    trace = R.mixed_scenario_trace(64, 4096, 24, period=12, seed=1)
    jtrace = JR.mixed_scenario_trace(64, 4096, 24, period=12, seed=1)
    res = S.run_serving_trace(W.DEEPSEEK_V3, sys_, trace, 256, TP[system],
                              balancer=balancer, alpha=1.0)
    jres = JS.run_serving_trace(JW.DEEPSEEK_V3, jsys, jtrace, 256, TP[system],
                                balancer=balancer, alpha=1.0)
    assert np.array_equal(res.iteration_times, jres.iteration_times)
    assert np.array_equal(res.peak_over_mean, jres.peak_over_mean)
    assert (res.exposed_overhead, res.migrations) == (jres.exposed_overhead, jres.migrations)
    assert dataclasses.asdict(res.breakdown_last) == dataclasses.asdict(jres.breakdown_last)
    assert (res.migrations > 0) == (balancer != "none")


def test_run_serving_trace_refuses_unknown_balancer():
    sys_ = SYSTEMS["4x4-er"](PORT)
    trace = R.single_scenario_trace(16, 256, 2)
    with pytest.raises(ValueError, match="balancer"):
        S.run_serving_trace(W.DEEPSEEK_V3, sys_, trace, 256, 4, balancer="eplb")
