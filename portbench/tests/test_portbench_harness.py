"""The harness end to end on the CPU at smoke size through the same code
as the card's runs, and the command's refusals."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import portbench_smoke as S
from portbench import spec

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("workload", ["dbrx-ep.chat", "mixtral-esp.chat", "dbrx-ep.longprompt"])
def test_cpu_run_prints_a_well_formed_result(workload):
    res = S.run(workload, 2**31 + 99)
    assert list(res)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0
    want = {m["name"] for m in spec.metrics(spec.load(), workload, trace=False)}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["check"]["dropped_rows"]["value"] == 0
    assert res["check"]["moe_dispatches_at_least"]["value"] >= 1
    json.dumps(res)


def test_cpu_traced_run_reads_the_host_metrics():
    res = S.run("dbrx-ep.chat", 7, seconds=2.5, trace=True)
    assert res["correct"] is True
    for name in ("batch_fill", "admit_tick_ms", "decode_tick_ms", "mfu"):
        assert res["metrics"][name]["value"] > 0
    # no device on the CPU: the device readers find nothing to read
    assert "moe_roofline" not in res["metrics"] and "device_idle" not in res["metrics"]
    assert res["device"]["window_s"] > 0


def command(cwd, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra_env or {})
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "dbrx-ep.chat",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_command_refuses_without_a_card():
    out = command(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "refused" in out.stderr


def test_command_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in spec.load()["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    out = command(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout
