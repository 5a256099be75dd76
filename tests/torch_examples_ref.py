"""Helpers of the example tests (``tests/test_torch_examples*.py``): run the
reference's example scripts (``examples/<name>.py``) in a JAX subprocess,
run the port's counterparts (``repro_torch.examples``) in process, and
compare what they print.

``start_reference`` runs each script with ``runpy.run_path(...,
run_name="__main__")`` and saves, per script, its standard output and
the values of the expressions asked for, evaluated over the script's
globals: a dict (the parameters) flattened to ``<name>/<expr key>/<path>``
numpy arrays, anything else as one array.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"

RUNNER = """
import contextlib, io, json, runpy, sys
import numpy as np
import jax

specs = json.loads(sys.argv[1])
out = {}


def put(key, value):
    if isinstance(value, dict):
        for k, v in value.items():
            put(f"{key}/{k}", v)
    elif value is not None:
        out[key] = np.asarray(value)


for name, exprs in specs.items():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g = runpy.run_path(f"{sys.argv[2]}/{name}.py", run_name="__main__")
    out[f"{name}/stdout"] = np.asarray(buf.getvalue())
    for key, expr in exprs.items():
        put(f"{name}/{key}", eval(expr, g))
np.savez(sys.argv[3], **out)
"""

# wall-clock fields, the only ones a port line may print differently
WALL = (re.compile(r"in \d+\.\d+s \(\d+\.\d+ tok/s\)"), re.compile(r"\d+\.\d+s/step"))


def start_reference(specs: dict, out: Path, devices: int = 1) -> subprocess.Popen:
    """Start the JAX subprocess running ``specs`` (script name -> {key:
    expression}) on ``devices`` forced host devices; it writes ``out``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    if devices > 1:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(RUNNER), json.dumps(specs), str(EXAMPLES),
         str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT,
    )


def finish(proc: subprocess.Popen, out: Path, timeout: int = 300) -> dict:
    """Wait for the reference run; its saved arrays."""
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(out))


def tree(arrays: dict, prefix: str) -> dict:
    """The nested dict of numpy arrays saved under ``prefix``."""
    t: dict = {}
    for key, val in arrays.items():
        if not key.startswith(prefix):
            continue
        node = t
        *path, leaf = key[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return t


def run_port(main, argv, **kw) -> tuple[dict, str]:
    """A port example's ``main`` with its standard output captured."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(argv, **kw)
    return res, buf.getvalue()


def lines(text: str) -> list[str]:
    """Printed lines with the wall-clock fields masked."""
    for pat in WALL:
        text = pat.sub("<wall>", text)
    return text.splitlines()
