"""``train_tiny_lm`` resumed from a JAX checkpoint, on the CPU.

A JAX subprocess writes the train state ``init_state(PRNGKey(0), cfg)``
gives for the example's narrowed llama3.2-1b (62.9M parameters) with the
reference's ``CheckpointManager``, at step 0 with ``data_step`` 0. The
directory is copied twice; the reference's script (a second JAX
subprocess) and the port's example each resume one copy with ``--steps 3
--batch 2 --seq 32``:

* the printed ``model:``, ``resumed from step 0`` and step lines agree,
  the losses within 1e-5 relative (the reference's as its script waits
  for them), the lr exact;
* the two final checkpoints agree under ``tests/test_torch_train.py``'s
  rule (``_state_close``): elements whose gradients the packages round
  apart by over ``APART`` of their value at some step are held at 2 x
  sum(lr). The reference's subprocess takes its gradients along its own
  steps, the test the port's along the port's;
* a second port run, ``python -m`` with JAX unimportable, resumes its
  own final checkpoint: ``resumed from step 3``.
"""

import os
import re
import shutil
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.runtime.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.examples import train_tiny_lm
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.runtime import optimizer as O
from repro_torch.runtime import train as TR
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.data import DataConfig, SyntheticLM
from test_torch_train import APART, _state_close, _unflatten
from torch_examples_ref import EXAMPLES, ROOT, run_port, tree

torch.set_num_threads(1)
ARGS = ["--steps", "3", "--batch", "2", "--seq", "32"]
STEP = re.compile(r"step +(\d+)  loss (\S+)  lr (\S+)  \S+s/step$")

CFG = """
import dataclasses
from repro.configs import get_config
cfg = dataclasses.replace(
    get_config("llama3.2-1b"), n_layers=8, d_model=768, n_heads=12, n_kv_heads=4,
    head_dim=64, d_ff=2048, vocab_size=8192, tie_embeddings=False)
"""

WRITE = CFG + """
import sys, jax
from repro.runtime.checkpoint import CheckpointManager
from repro.runtime.train import init_state
CheckpointManager(sys.argv[1]).save(0, init_state(jax.random.PRNGKey(0), cfg),
                                    extra={"data_step": 0})
"""

# the reference's script on its copy, the losses as the script waits for
# them; then its gradients along the same steps from the same init
RUN = CFG + """
import contextlib, io, runpy, sys
import jax, numpy as np
from repro.parallel.ctx import NO_MESH
from repro.runtime.data import DataConfig, SyntheticLM
from repro.runtime.optimizer import AdamWConfig
from repro.runtime.train import init_state, loss_fn, make_train_step

script, ckpt, out = sys.argv[1:4]
losses = []
wait = jax.block_until_ready


def record(x):
    x = wait(x)
    losses.append(float(x))
    return x


jax.block_until_ready = record
sys.argv = [script, *sys.argv[4:], "--ckpt", ckpt]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    runpy.run_path(script, run_name="__main__")
jax.block_until_ready = wait
arrays = {"stdout": np.asarray(buf.getvalue()), "losses": np.asarray(losses)}
steps = int(sys.argv[sys.argv.index("--steps") + 1])
opt = AdamWConfig(lr=1e-3, warmup_steps=30, total_steps=steps)
step = jax.jit(make_train_step(cfg, NO_MESH, opt))
grad = jax.jit(jax.grad(lambda p, b: loss_fn(p, b, cfg, NO_MESH)[0]))
data = SyntheticLM(DataConfig(cfg.vocab_size, int(sys.argv[sys.argv.index("--batch") + 1]),
                              int(sys.argv[sys.argv.index("--seq") + 1])))
state = init_state(jax.random.PRNGKey(0), cfg)
for i in range(steps):
    for path, g in jax.tree_util.tree_leaves_with_path(grad(state["params"],
                                                            data.batch_at(i))):
        arrays[f"grad{i}/" + "/".join(k.key for k in path)] = np.asarray(g)
    state, _ = step(state, data.batch_at(i))
np.savez(out, **arrays)
"""


def _jax(code: str, *args) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), *map(str, args)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)


def _wait(proc: subprocess.Popen) -> None:
    try:
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("examples_train")
    init = base / "init"
    _wait(_jax(WRITE, init))
    jdir, tdir = base / "jax", base / "port"
    shutil.copytree(init, jdir)
    shutil.copytree(init, tdir)
    ref = _jax(RUN, EXAMPLES / "train_tiny_lm.py", jdir, base / "ref.npz", *ARGS)
    try:
        port, text = run_port(train_tiny_lm.main, [*ARGS, "--device", "cpu", "--ckpt",
                                                   str(tdir)])
    finally:
        _wait(ref)
    yield {"base": base, "jdir": jdir, "tdir": tdir, "ref": dict(np.load(base / "ref.npz")),
           "port": port, "text": text}
    shutil.rmtree(base, ignore_errors=True)   # about 5 GB of checkpoints and gradients


def _masked(text: str, ckpt) -> list[str]:
    """Lines with the loss and wall-clock fields and the directory masked."""
    out = []
    for line in text.replace(str(ckpt), "<ckpt>").splitlines():
        m = STEP.match(line)
        out.append(f"step {m.group(1)} lr {m.group(3)}" if m else line)
    return out


def test_resumes_jax_checkpoint_and_prints_reference_lines(runs):
    ref, port = runs["ref"], runs["port"]
    text, want = runs["text"], str(ref["stdout"])
    assert text.splitlines()[:2] == want.splitlines()[:2] == [
        "model: 62.9M params", "resumed from step 0"]
    assert _masked(text, runs["tdir"]) == _masked(want, runs["jdir"])
    assert port["start"] == 0 and [h["step"] for h in port["history"]] == [0, 1, 2]
    np.testing.assert_allclose([h["loss"] for h in port["history"]], ref["losses"],
                               rtol=1e-5, atol=0)
    printed = [float(STEP.match(x).group(2)) for x in text.splitlines() if STEP.match(x)]
    assert printed == [round(port["history"][i]["loss"], 4) for i in (0, 2)]


def test_final_checkpoints_agree(runs):
    """The port's final checkpoint against the reference's under
    ``_state_close``; the elements that loosen are under 1% of all."""
    ref, state = runs["ref"], runs["port"]["state"]
    mgr = CheckpointManager(str(runs["tdir"]))
    got, meta = mgr.restore(state)
    assert meta["data_step"] == 3 and meta["step"] == 3
    want, jmeta = JCheckpointManager(str(runs["jdir"])).restore(
        O.tree_map(lambda t: t.numpy(), state))
    assert jmeta["data_step"] == 3

    # the port's gradients along its own steps, from the same init
    s, _ = mgr.restore(state, step=0)
    cfg, ctx = train_tiny_lm.model_config(), ParallelCtx()
    step = TR.make_train_step(cfg, ctx, O.AdamWConfig(lr=1e-3, warmup_steps=30,
                                                      total_steps=3))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 2, 32))
    loose = [np.zeros(p.shape, bool) for p in O.leaves(s["params"])]
    moved = 0.0
    for i in range(3):
        gt, _ = TR.grads_of(s["params"], data.batch_at(i), cfg, ctx)
        gj = jax.tree.leaves(tree(ref, f"grad{i}/"))
        for m, a, b in zip(loose, O.leaves(gt), gj, strict=True):
            m |= np.abs(a.numpy() - b) > APART * np.abs(b)
        s, met = step(s, data.batch_at(i))
        moved += 2 * float(met["lr"])
    _state_close(got, jax.tree.map(np.asarray, want),
                 O.tree_map(torch.from_numpy, _unflatten(got["params"], loose)), moved)
    assert sum(int(m.sum()) for m in loose) < sum(m.size for m in loose) // 100


def test_resumes_its_own_checkpoint(runs):
    code = (
        "import runpy, sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        f"sys.argv = ['train_tiny_lm', *{ARGS!r}, '--device', 'cpu', '--ckpt', "
        f"{str(runs['tdir'])!r}]\n"
        "runpy.run_module('repro_torch.examples.train_tiny_lm', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.splitlines() == ["model: 62.9M params", "resumed from step 3",
                                       f"done; checkpoints in {runs['tdir']}"]
