"""The port's tracer (``repro_torch.runtime.tracing``): the gate, the spans
of the serving path and their nesting read back from ``torch.profiler``'s
exported chrome trace, the counters against what the test computes itself,
and the served tokens with the profiler on and off. The MoE smoke model, 4
experts top-2, paged, over virtual EP 4 x 3 slots with the NI-Balancer
(a planned migration in flight, its slices stepped) and over ESP."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch.autograd.profiler as autograd_profiler
from repro_torch.configs import get_config, smoke
from repro_torch.models import transformer as T
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.runtime import tracing as TR
from repro_torch.runtime.scheduler import RequestScheduler
from repro_torch.runtime.serve import ServeConfig, Server

torch.set_num_threads(1)
CFG = dataclasses.replace(smoke(get_config("dbrx-132b")), n_experts=4, experts_per_token=2)
IMPLS = {
    "ep": dict(slots_per_device=3, virtual_ep=4, migration_slices=2),
    "esp": {},
}
PROMPT_LENS = (5, 11, 17, 9, 3, 20)
TICKS = 6

# the innermost program range around each span (None: none)
PARENTS = {
    TR.SCHED_FAULTS: {None},
    TR.SCHED_ADMIT: {None},
    TR.SERVER_PREFILL: {TR.SCHED_ADMIT},
    TR.SCHED_ADMIT_READ: {TR.SCHED_ADMIT},
    TR.SCHED_HEADROOM: {None},
    TR.SCHED_DRAIN: {None},
    TR.SCHED_DECODE: {None},
    TR.SERVER_STEP: {TR.SCHED_DECODE},
    TR.SCHED_SAMPLE: {None},
    TR.SCHED_LOGITS_READ: {TR.SCHED_SAMPLE},
    TR.SCHED_ARGMAX: {TR.SCHED_SAMPLE},
    TR.MODEL_ATTENTION: {TR.SERVER_PREFILL, TR.SERVER_STEP},
    TR.MODEL_MOE: {TR.SERVER_PREFILL, TR.SERVER_STEP},
    TR.MODEL_LOGITS: {TR.SERVER_PREFILL, TR.SERVER_STEP},
    TR.MOE_ROUTE: {TR.MODEL_MOE},
    TR.MOE_DISPATCH: {TR.MODEL_MOE},
    TR.MOE_FFN: {TR.MODEL_MOE},
    TR.MOE_COMBINE: {TR.MODEL_MOE},
}
BALANCER = {
    TR.BALANCE_DRAIN: {TR.SCHED_DECODE},
    TR.BALANCE_SLICE: {TR.BALANCE_DRAIN},
    TR.BALANCE_OBSERVE: {TR.SCHED_DECODE},
    TR.BALANCE_READ: {TR.BALANCE_OBSERVE},
}


def _sched(impl: str) -> RequestScheduler:
    params = T.init_params(CFG, seed=0, device="cpu")
    srv = Server(CFG, ParallelCtx(moe_impl=impl, capacity_factor=8.0), params,
                 ServeConfig(max_seq=64, paged=True, page_size=8, batch=4, **IMPLS[impl]),
                 device="cpu")
    if impl == "ep":
        # expert 0 replicated from EP device 0 onto 3, a slice a tick
        assert srv.apply_plan([(0, 0, 3)]) == 1
    sched = RequestScheduler(srv)
    rng = np.random.default_rng(3)
    for n in PROMPT_LENS:
        sched.submit(rng.integers(0, CFG.vocab_size, size=n), max_new_tokens=4)
    return sched


def _profiled_ticks(sched, ticks: int, path):
    """``ticks`` scheduler steps under a host-recording profiler; returns
    the live rows of each decode step, the counters and the program's
    ranges (name, start, end) from the exported trace."""
    live = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(ticks):
            finished = sched.step()
            live.append(len(sched._live()) + len(finished))
        counters = TR.counters()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events
              if e.get("ph") == "X" and str(e.get("name", "")).startswith("repro_torch.")]
    return live, counters, ranges


def _parent(ranges, r):
    """The innermost other program range holding ``r``."""
    name, a, b = r
    holders = [o for o in ranges if o is not r and o[1] <= a and b <= o[2]
               and (o[2] - o[1]) >= (b - a)]
    return min(holders, key=lambda o: o[2] - o[1])[0] if holders else None


def test_without_a_profiler_spans_are_the_shared_null_and_nothing_counts():
    assert TR.span(TR.MOE_FFN) is TR.NULL and TR.span(TR.SCHED_ADMIT) is TR.NULL
    before = TR.counters()
    TR.count(TR.ADMIT_REAL_TOKENS, 5)
    TR.count_ep_rows(torch.ones(8, dtype=torch.int32), 4)
    assert TR.counters() == before


def test_a_profiler_of_the_card_alone_keeps_the_ranges_closed():
    """A session whose activities leave out the CPU (here the CUDA activity
    alone, started as ``torch.autograd.profiler.profile`` starts one)."""
    config = torch._C._profiler.ProfilerConfig(
        torch._C._profiler.ProfilerState.KINETO, False, False, False, False, False,
        torch._C._profiler._ExperimentalConfig())
    activities = {ProfilerActivity.CUDA}
    autograd_profiler._prepare_profiler(config, activities)
    autograd_profiler._enable_profiler(config, activities)
    try:
        assert torch._C._autograd._profiler_enabled()
        assert TR.span(TR.MOE_FFN) is TR.NULL
        before = TR.counters()
        TR.count(TR.ADMIT_REAL_TOKENS, 5)
        assert TR.counters() == before
    finally:
        torch._C._autograd._disable_profiler()
    with profile(activities=[ProfilerActivity.CPU]):
        assert TR.span(TR.MOE_FFN) is not TR.NULL


@pytest.mark.cuda
def test_a_profiler_of_the_card_alone_keeps_the_ranges_closed_on_the_card():
    """``torch.profiler.profile`` with the CUDA activity alone, as the
    benchmark's card-only phase runs it: no range opens, nothing counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the session records the card's activity")
    with profile(activities=[ProfilerActivity.CUDA]):
        assert torch._C._autograd._profiler_enabled()
        assert TR.span(TR.MOE_FFN) is TR.NULL
        before = TR.counters()
        TR.count(TR.ADMIT_REAL_TOKENS, 5)
        assert TR.counters() == before
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        assert TR.span(TR.MOE_FFN) is not TR.NULL


def test_ep_rows_become_the_moe_counters_when_read():
    """Each EP decode call's kept rows per slot, grouped device by device
    when the set is read: the largest device's rows and the total."""
    with profile(activities=[ProfilerActivity.CPU]):
        TR.count_ep_rows(torch.arange(1, 9, dtype=torch.int32), 4)    # 3 7 11 15
        TR.count_ep_rows(torch.tensor([8, 0, 0, 0, 0, 0, 0, 1]), 2)  # 8 1
        TR.count_ep_rows(torch.tensor([2, 2, 0, 5, 1, 1]), 3)        # 4 5 2
        got = TR.counters()
    assert got == {TR.MOE_DECODE_CALLS: 3, TR.MOE_EP_DEVICES: 9,
                   TR.MOE_MAX_DEVICE_ROWS: 15 + 8 + 5, TR.MOE_ROUTED_ROWS: 36 + 9 + 11}


def test_each_host_session_starts_a_fresh_set():
    with profile(activities=[ProfilerActivity.CPU]):
        TR.count(TR.ADMIT_REAL_TOKENS, 5)
        TR.count(TR.ADMIT_REAL_TOKENS, 2)
        TR.count(TR.MOE_ROUTED_ROWS, torch.tensor(3))
        TR.count(TR.MOE_ROUTED_ROWS, torch.tensor(4))
        assert TR.counters() == {TR.ADMIT_REAL_TOKENS: 7, TR.MOE_ROUTED_ROWS: 7}
    assert TR.counters() == {TR.ADMIT_REAL_TOKENS: 7, TR.MOE_ROUTED_ROWS: 7}
    with profile(activities=[ProfilerActivity.CPU]):
        assert TR.counters() == {}
        TR.count_ep_rows(torch.ones(4, dtype=torch.int32), 2)
    with profile(activities=[ProfilerActivity.CPU]):
        assert TR.counters() == {}


@pytest.mark.parametrize("impl", ["ep", "esp"])
def test_ticks_emit_every_span_nested(impl, tmp_path):
    sched = _sched(impl)
    _, _, ranges = _profiled_ticks(sched, TICKS, tmp_path / "trace.json")
    want = dict(PARENTS, **(BALANCER if impl == "ep" else {}))
    seen = {}
    for r in ranges:
        seen.setdefault(r[0], set()).add(_parent(ranges, r))
    assert set(seen) == set(want)
    for name, parents in seen.items():
        assert parents <= want[name], (name, parents)
    # per tick: one sched.decode, one sched.sample; per decode step and
    # admission one model.attention and model.moe a layer
    assert sum(1 for r in ranges if r[0] == TR.SCHED_DECODE) == TICKS
    n_admit = sum(1 for r in ranges if r[0] == TR.SCHED_ADMIT)
    assert n_admit >= 4
    assert sum(1 for r in ranges if r[0] == TR.MODEL_MOE) == CFG.n_layers * (TICKS + n_admit)


@pytest.mark.parametrize("impl", ["ep", "esp"])
def test_counters_are_what_the_ticks_did(impl, tmp_path):
    sched = _sched(impl)
    live, got, _ = _profiled_ticks(sched, TICKS, tmp_path / "trace.json")
    admitted = [r for r in sched.requests if r.admitted_step is not None]
    assert got[TR.ADMIT_REAL_TOKENS] == sum(len(r.prompt) for r in admitted)
    assert got[TR.ADMIT_BUCKET_TOKENS] == sum(sched._bucket(len(r.prompt)) for r in admitted)
    if impl == "esp":
        assert set(got) == {TR.ADMIT_REAL_TOKENS, TR.ADMIT_BUCKET_TOKENS}
        return
    calls = CFG.n_layers * TICKS
    routed = CFG.n_layers * CFG.experts_per_token * sum(live)
    assert got[TR.MOE_DECODE_CALLS] == calls
    assert got[TR.MOE_EP_DEVICES] == 4 * calls
    assert got[TR.MOE_ROUTED_ROWS] == routed
    assert routed / 4 <= got[TR.MOE_MAX_DEVICE_ROWS] <= routed


@pytest.mark.parametrize("impl", ["ep", "esp"])
def test_tokens_are_the_same_with_the_profiler_on_and_off(impl, tmp_path):
    off = _sched(impl)
    for _ in range(TICKS):
        off.step()
    on = _sched(impl)
    _profiled_ticks(on, TICKS, tmp_path / "trace.json")
    assert on.server.migrations == off.server.migrations
    got, want = on.results(), off.results()
    assert got.keys() == want.keys()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    if impl == "ep":
        assert on.server.migrations >= 1
