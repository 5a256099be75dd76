"""Nothing portbench runs on the card loads JAX or the JAX package, and the
reference loads nothing of the program: each import in a fresh
interpreter, top-level module names compared whole (``repro_torch`` begins
with ``repro`` but is not it)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PROBE = ("import importlib, json, sys; importlib.import_module(sys.argv[1]); "
         "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")


def top_level(module: str) -> set:
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}"}
    out = subprocess.run([sys.executable, "-c", PROBE, module], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("module", ["portbench.run", "portbench.harness",
                                    "portbench.calibrate"])
def test_runner_loads_no_jax(module):
    names = top_level(module)
    assert not names & {"jax", "jaxlib", "flax", "repro"}
    if module == "portbench.harness":
        assert "repro_torch" in names     # the program under test, by whole name


def test_reference_loads_nothing_of_the_program():
    names = top_level("portbench.reference")
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
    assert "torch" in names
