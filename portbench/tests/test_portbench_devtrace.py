"""The reduction of a chrome trace: device activity in the window, kernels
launched inside a span, idle gaps by what the host was doing."""

import pytest

from portbench import devtrace


def ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    return devtrace.Trace([
        ev("user_annotation", devtrace.WINDOW, 0, 1000),
        ev("user_annotation", "portbench.moe", 100, 200),
        ev("cpu_op", "aten::mm", 110, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 115, 5, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 250, 5, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 400, 5, corr=3),
        ev("cpu_op", "aten::item", 600, 300),
        ev("kernel", "gmm", 120, 100, corr=1, tid=7),
        ev("kernel", "gmm", 260, 100, corr=2, tid=7),      # overlaps the next
        ev("kernel", "flash", 340, 60, corr=3, tid=7),
        ev("gpu_memcpy", "Memcpy DtoH", 950, 100, corr=None, tid=7),
    ])


def test_busy_is_the_union_clipped_to_the_window():
    t = synthetic()
    assert t.window_s == pytest.approx(1e-3)
    # [120, 220) + [260, 400) + [950, 1000) = 100 + 140 + 50 us
    assert t.busy_s == pytest.approx(290e-6)


def test_kernels_launched_inside_a_span():
    t = synthetic()
    assert t.span_device_s("portbench.moe") == pytest.approx(200e-6)
    assert t.span_device_s("portbench.nothing") == 0.0


def test_idle_gaps_by_host_call():
    gaps = dict(synthetic().idle_gaps())
    # 400 .. 950: the window span open at its middle; the launch at 400 open
    assert gaps["portbench.window: cudaLaunchKernel"] == pytest.approx(550e-6)
    assert gaps["portbench.window: portbench.window"] == pytest.approx(120e-6)  # 0 .. 120
    assert gaps["portbench.moe: portbench.moe"] == pytest.approx(40e-6)         # 220 .. 260
    ops = dict(synthetic().top_ops())
    assert ops["gmm"] == pytest.approx(200e-6)


def test_device_phase_window_is_host_seconds():
    t = devtrace.Trace([ev("kernel", "gmm", 5000, 100, corr=1, tid=7),
                        ev("kernel", "gmm", 5300, 200, corr=2, tid=7)], window_s=0.001)
    assert t.window_s == 0.001
    assert t.busy_s == pytest.approx(300e-6)
    assert t.top_ops() == [["gmm", pytest.approx(300e-6)]]
