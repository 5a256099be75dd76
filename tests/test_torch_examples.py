"""The port's examples (``repro_torch.examples``) against the reference's
scripts (``examples/``) on the CPU: ``balancer_demo``, ``quickstart``,
``continuous_serving`` and ``serve_moe``'s no-mesh fallback.

The reference scripts run in one JAX subprocess (one host device); each
port example then runs in this process with the script's own parameters
(``bridge.params_from_numpy``). Every printed line must equal the
reference's, wall-clock fields aside: the core figures, the forward's
shape and aux loss, the generated tokens, the chaos run's fault plan,
events, preemptions, stats, migrations and ``PARITY HELD``. Besides:
tokens equal, the forward's logits and aux within 1e-5 (fp32).

Each example also runs as ``python -m repro_torch.examples.<name>
--device cpu`` with ``jax`` and the JAX package made unimportable.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.examples import balancer_demo, continuous_serving, quickstart, serve_moe
from torch_examples_ref import ROOT, finish, lines, run_port, start_reference, tree

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = ["--device", "cpu"]
SPECS = {
    "balancer_demo": {},
    "quickstart": {"params": "params", "logits": "logits", "aux": "float(aux['loss'])",
                   "out": "out"},
    "continuous_serving": {"params": "params", "ref": "ref",
                           "tokens": "[list(r.tokens_out) for r in reqs]",
                           "migrations": "sched.server.migrations"},
    "serve_moe": {"params": "params", "out": "out", "migrations": "server.migrations"},
}
PORT = {"balancer_demo": balancer_demo, "quickstart": quickstart,
        "continuous_serving": continuous_serving, "serve_moe": serve_moe}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> (reference arrays, port result, port stdout)."""
    out = tmp_path_factory.mktemp("examples") / "ref.npz"
    ref = finish(start_reference(SPECS, out), out)
    res = {}
    for name, mod in PORT.items():
        params = tree(ref, f"{name}/params/") or None
        if params is not None:
            params = params_from_numpy(params)
        port, text = run_port(mod.main, CPU, params=params)
        res[name] = ({k[len(name) + 1:]: v for k, v in ref.items()
                      if k.startswith(name + "/")}, port, text)
    return res


@pytest.mark.parametrize("name", list(SPECS))
def test_prints_the_reference_lines(runs, name):
    """Every line as the reference prints it, wall-clock fields aside."""
    ref, _, text = runs[name]
    want = lines(str(ref["stdout"]))
    assert want, "the reference printed nothing"
    assert lines(text) == want


def test_balancer_demo_figures(runs):
    _, port, _ = runs["balancer_demo"]
    assert port["idle_links"] == 16 and port["n_links"] == 48
    assert port["steps"] == [("local", 0, 5), ("global", 5, 10), ("local", 10, 15)]
    assert port["policies"]["topo_ni"]["migrations"] == 400
    assert port["policies"]["none"]["migrations"] == 0


def test_quickstart_forward_and_tokens(runs):
    ref, port, _ = runs["quickstart"]
    np.testing.assert_allclose(port["logits"].numpy(), ref["logits"], **TOL)
    np.testing.assert_allclose(port["aux"], float(ref["aux"]), **TOL)
    np.testing.assert_array_equal(port["tokens"].numpy(), ref["out"])
    assert port["core"]["er"]["intersections"] == 0


def test_continuous_serving_streams_and_events(runs):
    """Both runs' tokens, the migrations and parity equal the reference's;
    the event list and its fault reprs are held through the printed
    lines."""
    ref, port, text = runs["continuous_serving"]
    assert port["ref"] == ref["ref"].tolist()
    assert port["tokens"] == ref["tokens"].tolist()
    assert port["migrations"] == int(ref["migrations"]) > 0
    assert port["parity"] and port["n_preempted"] >= 1 and port["n_faults"] == 5
    assert text.splitlines()[-1].startswith("PARITY HELD under 5 faults")
    kinds = [k for _, k, _ in port["events"]]
    assert "preempt" in kinds and "evacuated" in kinds


def test_serve_moe_fallback(runs):
    """One process: the dense fallback, no balancer, so no drill."""
    ref, port, text = runs["serve_moe"]
    assert text.splitlines()[0] == "only 1 device(s) — running the dense fallback"
    np.testing.assert_array_equal(port["out"].numpy(), ref["out"])
    assert port["migrations"] == int(ref["migrations"]) == 0
    assert port["drill"] is None and port["mesh"] is None
    assert [tuple(o.shape) for o in port["outs"]] == [(4, 24)] * 3


@pytest.mark.parametrize("name", list(SPECS))
def test_runs_as_module_without_jax(name):
    code = (
        "import runpy, sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        f"sys.argv = ['{name}', '--device', 'cpu']\n"
        f"runpy.run_module('repro_torch.examples.{name}', run_name='__main__')\n"
        "assert 'jax' not in [m for m, v in sys.modules.items() if v is not None]\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip()
