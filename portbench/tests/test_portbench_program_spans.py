"""The readers of the program's own ranges and counters
(``portbench.program_spans``): the card's idle gaps put down to the
innermost ``repro_torch.*`` range on a synthetic trace, nothing read from a
program without the tracer, and every new metric reading a number in a
traced smoke run of each cell it names."""

import sys
import time
import types

import pytest
import torch

import portbench_smoke as S
from portbench import devtrace, harness, program_spans, spec

NEW = ("moe_idle_ms", "sample_idle_ms", "balancer_idle_ms", "ep_imbalance",
       "prefill_pad_share")


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def synthetic(program=True, device=True):
    """Two ticks in a 1000 us window; the card idles in [40, 90) under
    moe.dispatch, [150, 230) under model.moe, [305, 360) under balance.read,
    [415, 470) under sched.logits_read and [600, 700) under no program
    range."""
    events = [ev("user_annotation", devtrace.WINDOW, 0, 1000),
              ev("user_annotation", "portbench.tick", 0, 500),
              ev("user_annotation", "portbench.tick", 500, 500),
              ev("user_annotation", "portbench.moe", 25, 190)]
    if program:
        events += [ev("user_annotation", "repro_torch.sched.decode", 10, 380),
                   ev("user_annotation", "repro_torch.server.step", 15, 270),
                   ev("user_annotation", "repro_torch.model.moe", 20, 200),
                   ev("user_annotation", "repro_torch.moe.dispatch", 30, 50),
                   ev("user_annotation", "repro_torch.balance.observe", 300, 80),
                   ev("user_annotation", "repro_torch.balance.read", 310, 40),
                   ev("user_annotation", "repro_torch.sched.sample", 400, 90),
                   ev("user_annotation", "repro_torch.sched.logits_read", 410, 40)]
    events.append(ev("cuda_runtime", "cudaMemcpyAsync", 320, 20))
    if device:
        for a, b in ((0, 40), (90, 150), (230, 305), (360, 415), (470, 600), (700, 1000)):
            events.append(ev("kernel", "k", a, b - a, tid=7))
    return devtrace.Trace(events)


def test_idle_gaps_go_to_the_innermost_program_range():
    by = program_spans.idle_by_range(synthetic())
    assert by == pytest.approx({
        "repro_torch.moe.dispatch": 50e-6, "repro_torch.model.moe": 80e-6,
        "repro_torch.balance.read": 55e-6, "repro_torch.sched.logits_read": 55e-6,
        program_spans.NONE: 100e-6})


@pytest.mark.parametrize("name,ms", [
    ("moe_idle_ms", (50 + 80) / 2 / 1e3),
    ("sample_idle_ms", 55 / 2 / 1e3),
    ("balancer_idle_ms", 55 / 2 / 1e3),
])
def test_idle_readers_sum_their_ranges_over_the_ticks(name, ms):
    run = types.SimpleNamespace(trace=synthetic())
    assert spec.reader(name)(run) == pytest.approx(ms)


@pytest.mark.parametrize("harness_span,ms", [(True, 50 / 1e3), (False, (40 + 50) / 1e3)])
def test_moe_idle_leaves_out_what_the_harness_does_in_model_moe(harness_span, ms):
    """One tick: the card idles in [40, 80) under model.moe before the
    harness's portbench.moe opens (its own routing of an admission) and in
    [150, 200) under model.moe inside it. Only the second is the MoE
    layer's, where the trace has the harness span."""
    events = [ev("user_annotation", devtrace.WINDOW, 0, 1000),
              ev("user_annotation", "portbench.tick", 0, 1000),
              ev("user_annotation", "repro_torch.model.moe", 20, 280)]
    if harness_span:
        events.append(ev("user_annotation", "portbench.moe", 100, 190))
    for a, b in ((0, 40), (80, 150), (200, 1000)):
        events.append(ev("kernel", "k", a, b - a, tid=7))
    run = types.SimpleNamespace(trace=devtrace.Trace(events))
    assert spec.reader("moe_idle_ms")(run) == pytest.approx(ms)
    assert program_spans.idle_by_range(run.trace) == pytest.approx(
        {"repro_torch.model.moe": 90e-6})


@pytest.mark.parametrize("name", ["moe_idle_ms", "sample_idle_ms", "balancer_idle_ms"])
@pytest.mark.parametrize("trace", ["no program range", "no device activity", "untraced"])
def test_idle_readers_read_nothing_without_ranges_or_a_card(name, trace):
    t = {"no program range": synthetic(program=False),
         "no device activity": synthetic(device=False), "untraced": None}[trace]
    assert spec.reader(name)(types.SimpleNamespace(trace=t)) is None


def test_counter_readers(monkeypatch):
    c = {"moe.decode_calls": 8, "moe.ep_devices": 32, "moe.max_device_rows": 300,
         "moe.routed_rows": 1000, "admit.real_tokens": 300, "admit.bucket_tokens": 512}
    monkeypatch.setattr(program_spans, "counters", lambda: c)
    # 300 rows on the largest device a call against 1000 / 4 on the mean one
    assert spec.reader("ep_imbalance")(None) == pytest.approx(1.2)
    assert spec.reader("prefill_pad_share")(None) == pytest.approx(100 * (1 - 300 / 512))
    c.update({"moe.decode_calls": 0, "admit.bucket_tokens": 0})
    assert spec.reader("ep_imbalance")(None) is None
    assert spec.reader("prefill_pad_share")(None) is None


def test_counter_readers_without_the_tracer(monkeypatch):
    """A program without ``repro_torch.runtime.tracing`` (the import fails):
    nothing to read, no error."""
    import repro_torch.runtime
    monkeypatch.delattr(repro_torch.runtime, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.tracing", None)
    assert program_spans.counters() is None
    assert spec.reader("ep_imbalance")(None) is None
    assert spec.reader("prefill_pad_share")(None) is None


class CardOnCPU(devtrace.Trace):
    """A trace of the CPU run in which the matrix products stand in for
    the card's kernels, so the card has busy and idle stretches."""

    def __init__(self, events, window_s=None):
        kernels = [dict(e, cat="kernel", tid="card") for e in events
                   if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                   and e.get("name") in ("aten::mm", "aten::bmm", "aten::addmm")]
        super().__init__(events + kernels, window_s)


@pytest.mark.parametrize("workload", ["dbrx-ep.chat", "mixtral-esp.chat", "dbrx-ep.longprompt"])
def test_traced_smoke_run_reads_every_new_metric(workload, monkeypatch):
    monkeypatch.setattr(devtrace, "Trace", CardOnCPU)
    bench, config, mix = S.shrunk(workload)
    want = {m["name"] for m in spec.metrics(bench, workload, trace=True)} & set(NEW)
    assert want == (set(NEW) if workload.startswith("dbrx") else
                    {"moe_idle_ms", "sample_idle_ms", "prefill_pad_share"})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = harness.run_cell(workload, 2**31 + 5, 1.5, True, t_start=time.perf_counter(),
                               device="cpu", bench=bench, config=config, mix=mix,
                               limit={"mean_gap_sd": S.SMOKE_LIMIT}, trace_ticks=8)
    finally:
        torch.set_num_threads(threads)
    assert res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items() if k in NEW}
    assert set(got) == want
    assert all(v >= 0 for v in got.values())
    assert got["moe_idle_ms"] > 0
    assert 0 <= got["prefill_pad_share"] < 100
    if "ep_imbalance" in got:
        assert got["ep_imbalance"] >= 1
