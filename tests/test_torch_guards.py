"""Guards of the PyTorch port's boundaries.

* No file of ``src/repro_torch`` (nor ``chip_smoke.py``) imports JAX or the
  JAX package.
* The port imports and serves a step with ``jax`` made unimportable.
* Entry points default to the card and raise without one rather than run
  on the CPU; kernel requests for CPU tensors raise rather than quietly
  take the plain path; a Server given a mesh without an initialised
  process group raises rather than serve single-process.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke
from repro_torch.kernels import build
from repro_torch.models import transformer as T
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.runtime.serve import ServeConfig, Server

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_repro():
    offenders = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.relative_to(ROOT)}: {name}")
    assert not offenders, offenders
    assert len(_port_files()) > 20
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for mod in ("parallel/mesh.py", "parallel/sharding.py", "parallel/collectives.py",
                "kernels/gmm/ops.py", "kernels/gmm/gmm.py", "runtime/faults.py",
                "runtime/scheduler.py", "runtime/checkpoint.py", "runtime/snapshot.py",
                "runtime/elastic.py", "configs/llama3_2_1b.py", "models/ssm.py",
                "configs/deepseek_7b.py", "configs/qwen2_72b.py",
                "configs/tinyllama_1_1b.py", "configs/internvl2_76b.py",
                "configs/seamless_m4t_medium.py", "configs/zamba2_1_2b.py",
                "configs/xlstm_350m.py", "runtime/train.py", "runtime/optimizer.py",
                "runtime/data.py", "launch/train.py", "core/hardware.py",
                "core/comm_model.py", "core/ftd.py", "core/workloads.py", "core/traces.py",
                "core/simulator.py", "figures/run.py", "figures/common.py",
                "launch/mesh.py", "launch/dryrun.py", "benchmarks/bench_kernels.py",
                "figures/roofline.py", "parallel/grad_compress.py",
                "examples/__init__.py", "examples/balancer_demo.py",
                "examples/quickstart.py", "examples/continuous_serving.py",
                "examples/serve_moe.py", "examples/train_tiny_lm.py"):
        assert f"src/repro_torch/{mod}" in names


def test_port_states_no_tpu_platform():
    """The analytic model's platforms are the paper's (WSC, DGX, NVL72):
    the reference's TPU constants are not copied."""
    for path in _port_files():
        text = path.read_text()
        assert "TPU_V5E" not in text and "TPU_POD" not in text, path


def test_port_runs_with_jax_unimportable():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "import repro_torch\n"
        "from repro_torch.configs import get_config, smoke\n"
        "from repro_torch.models import transformer as T\n"
        "from repro_torch.parallel.ctx import ParallelCtx\n"
        "from repro_torch.runtime.serve import Server, ServeConfig\n"
        "cfg = smoke(get_config('dbrx-132b'))\n"
        "p = T.init_params(cfg, seed=0, device='cpu')\n"
        "s = Server(cfg, ParallelCtx(capacity_factor=8.0), p, ServeConfig("
        "max_seq=32, batch=2, slots_per_device=3, virtual_ep=4, paged=True, "
        "page_size=8), device='cpu')\n"
        "out = s.generate(torch.ones((2, 5), dtype=torch.long), 2)\n"
        "assert out.shape == (2, 2)\n"
        "assert 'jax' not in [m for m, v in sys.modules.items() if v is not None]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def _run_figures(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)


def test_figures_run_with_jax_unimportable():
    res = _run_figures(
        "import runpy, sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "sys.argv = ['run', 'fig06']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.figures.run', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "assert 'jax' not in [m for m, v in sys.modules.items() if v is not None]\n")
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert len(lines) == 9 and all(line.startswith("fig06/") for line in lines[1:])


def test_figures_runner_fails_on_a_failing_figure():
    """A figure that raises stops the runner with a non-zero exit and no
    row for it (the reference's runner prints an ERROR row and exits 0)."""
    res = _run_figures(
        "import sys\n"
        "from repro_torch.figures import fig13b_models, run\n"
        "def broken():\n"
        "    raise ZeroDivisionError('broken figure')\n"
        "fig13b_models.run = broken\n"
        "sys.exit(run.main(['fig13a', 'fig13b', 'fig13c']))\n")
    assert res.returncode != 0
    assert "ZeroDivisionError: broken figure" in res.stderr
    assert "fig13b" not in res.stdout and "ERROR" not in res.stdout
    assert "fig13a/" in res.stdout and "fig13c/" not in res.stdout


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke(get_config("dbrx-132b"))
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_cache(cfg, 2, 16)
    params = T.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Server(cfg, ParallelCtx(), params, ServeConfig(paged=True))
    from repro_torch.launch import serve as launch

    with pytest.raises(RuntimeError, match="cuda"):
        launch.main(["--arch", "dbrx-132b", "--smoke"])
    from repro_torch.launch import train as train_cli
    from repro_torch.runtime.train import init_state

    with pytest.raises(RuntimeError, match="cuda"):
        init_state(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--arch", "dbrx-132b", "--smoke", "--steps", "1"])
    from repro_torch.examples import (balancer_demo, continuous_serving, quickstart,
                                      serve_moe, train_tiny_lm)

    for example in (balancer_demo, quickstart, continuous_serving, serve_moe,
                    train_tiny_lm):
        with pytest.raises(RuntimeError, match="cuda"):
            example.main([])


def test_kernel_request_on_cpu_tensor_raises():
    x = torch.zeros((2, 8, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        ParallelCtx(use_kernels=True).kernels_on(x)
    assert ParallelCtx().kernels_on(x) is False
    assert ParallelCtx(use_kernels=False).kernels_on(x) is False
    # Model code asks the context before it calls a kernel, so a served
    # step that requests kernels for CPU tensors raises there.
    cfg = smoke(get_config("dbrx-132b"))
    srv = Server(cfg, ParallelCtx(capacity_factor=8.0, use_kernels=True),
                 T.init_params(cfg, seed=0, device="cpu"),
                 ServeConfig(max_seq=32, batch=2, slots_per_device=3, virtual_ep=4,
                             paged=True, page_size=8), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        srv.generate(torch.ones((2, 5), dtype=torch.long), 1)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises (no silent plain fallback)."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()
    assert build.lib_path("gmm_ragged").name.startswith("libgmm_ragged-")
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()


def test_request_stream_matches_reference_draws():
    from repro_torch.runtime.data import request_stream

    a = next(request_stream(256, 2, 5, seed=3))
    want = np.random.default_rng(3).integers(0, 256, size=(2, 5))
    np.testing.assert_array_equal(a, want)


def test_server_under_mesh_needs_a_process_group():
    """A mesh whose world is gone (or never was) is refused at once: the
    Server does not quietly serve single-process."""
    import torch.distributed as dist

    from repro_torch.parallel.mesh import Mesh

    assert not dist.is_initialized()
    cfg = smoke(get_config("dbrx-132b"))
    ctx = ParallelCtx(mesh=Mesh(1, 1, 0, None, None))
    with pytest.raises(RuntimeError, match="process group"):
        Server(cfg, ctx, T.init_params(cfg, seed=0, device="cpu"),
               ServeConfig(max_seq=32, batch=2), device="cpu")
    from repro_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="not initialised"):
        make_mesh(1, 1)
