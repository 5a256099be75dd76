"""Crash-safe snapshots under a mesh (``runtime.snapshot``,
``Server.restore_snapshot``): four gloo processes on 2 x 2 and 1 x 4,
fp32, the kernels' plain versions, dbrx-132b's ``smoke()`` with the
NI-Balancer live and chunked admission, under seed 5's chaos plan.

* A ``crash_restart`` mid-stream fires on every rank at the same tick;
  the ranks' snapshots agree, rank 0 writes the one file, and every rank
  restores from it under its mesh: every stream equals the uninterrupted
  run's, bit for bit, and every request finishes.
* Across packages (1 x 4): a file the port writes restores in the JAX
  Server under its (1, 4) mesh of forced host devices, and a file the JAX
  package writes there restores in the port, the streams equal to the
  uninterrupted runs' (which equal each other).
* Across layouts: a 1 x 4 file restores on one process with ``virtual_ep``
  4, and a file written there restores on 1 x 4. A model axis that is not
  the table's device count raises ``ValueError`` (the 1 x 4 file on 2 x
  2); a rank whose snapshot differs raises ``RuntimeError`` on every rank,
  naming it.

Two rounds: the first writes every file (the port's ranks, one JAX
subprocess and the one-process run beside them), the second restores the
other package's and the other layout's files. The ranks meet through a
file in the test's temporary directory, and every group has a 120 s
timeout.
"""

import dataclasses
import datetime
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from repro_torch.configs import get_config, smoke
from repro_torch.models import transformer as T

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((2, 2), (1, 4))
CFG = smoke(get_config("dbrx-132b"))
SCHED = dict(max_seq=64, paged=True, page_size=8, pool_pages=10, alpha=0.1,
             slots_per_device=3, prefill_chunk=8, virtual_ep=4)
N_NEW = 7
CRASH = 4


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


def _batch(shape):
    return 3 if shape[0] == 1 else 4


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def _unflatten(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = val
    return tree


def _inputs(path: Path) -> dict:
    rng = np.random.default_rng(0)
    arr = {f"params/{k}": v for k, v in _flatten(T.init_params(CFG, seed=0,
                                                                device="cpu")).items()}
    lens = np.random.default_rng(5).integers(3, 14, size=4)
    for i, n in enumerate(lens):
        arr[f"prompt{i}"] = rng.integers(0, CFG.vocab_size, n).astype(np.int32)
    np.savez(path, **arr)
    return arr


JAX_SCRIPT = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config, smoke
from repro.launch.mesh import make_mesh_compat
from repro.parallel.ctx import ParallelCtx
from repro.runtime import faults as F
from repro.runtime import snapshot as S
from repro.runtime.scheduler import RequestScheduler
from repro.runtime.serve import ServeConfig, Server

SCHED, N_NEW, CRASH, ROUND = {consts}
inp = dict(np.load(sys.argv[1]))
base = sys.argv[2]
out = {{}}
cfg = smoke(get_config("dbrx-132b"))


def params():
    t = {{}}
    for key, val in inp.items():
        if key.startswith("params/"):
            node = t
            *path, leaf = key[len("params/"):].split("/")
            for p in path:
                node = node.setdefault(p, {{}})
            node[leaf] = jnp.asarray(val)
    return t


def plan(crash):
    faults = list(F.FaultPlan.chaos(5, n_steps=8, n_devices=4, pressure_pages=5,
                                    nan_slots=(0, 1, 2)))
    if crash:
        faults.append(F.Fault(step=CRASH, kind=F.CRASH_RESTART, path=crash))
    return F.FaultPlan(faults)


mesh = make_mesh_compat((1, 4), ("data", "model"))
ctx = ParallelCtx(mesh=mesh, capacity_factor=8.0)
with mesh:
    if ROUND == 1:
        for name, crash in (("free", ""), ("crashed", base + "/jax14.npz")):
            s = RequestScheduler(Server(cfg, ctx, params(), ServeConfig(batch=3, **SCHED)),
                                 None, faults=plan(crash))
            for i in range(4):
                s.submit(inp[f"prompt{{i}}"], N_NEW, arrival=i)
            try:
                res = s.run()
            except F.SimulatedCrash:
                continue
            for rid, toks in res.items():
                out[f"{{name}}/stream{{rid}}"] = np.asarray(toks)
    else:
        s = S.restore_scheduler(base + "/port14.npz", cfg, ctx, params(), faults=plan(""))
        for rid, toks in s.run().items():
            out[f"restored/stream{{rid}}"] = np.asarray(toks)
np.savez(sys.argv[3], **out)
"""


def _start_jax(inputs: Path, base: Path, out: Path, rnd: int) -> subprocess.Popen:
    consts = repr((SCHED, N_NEW, CRASH, rnd))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT.format(consts=consts)),
         str(inputs), str(base), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _plan(n_dev: int, crash: str = ""):
    from repro_torch.runtime import faults as F

    faults = list(F.FaultPlan.chaos(5, n_steps=8, n_devices=n_dev, pressure_pages=5,
                                    nan_slots=(0, 1, 2)))
    if crash:
        faults.append(F.Fault(step=CRASH, kind=F.CRASH_RESTART, path=crash))
    return F.FaultPlan(faults)


def _params(inp):
    from repro_torch.bridge import params_from_numpy

    return params_from_numpy(_unflatten(inp, "params/"), device="cpu")


def _run(inp, ctx, scfg: dict, plan, out: dict, key: str):
    """A scheduler over a fresh Server: its streams under ``key``, or
    ``key/crash`` = the tick of the crash that stopped it."""
    from repro_torch.runtime import faults as F
    from repro_torch.runtime.scheduler import RequestScheduler
    from repro_torch.runtime.serve import ServeConfig, Server

    s = RequestScheduler(Server(CFG, ctx, _params(inp), ServeConfig(**scfg), device="cpu"),
                         None, faults=plan)
    for i in range(4):
        s.submit(inp[f"prompt{i}"], N_NEW, arrival=i)
    try:
        res = s.run()
    except F.SimulatedCrash as exc:
        out[f"{key}/crash"] = np.asarray(exc.step)
        return exc
    for rid, toks in res.items():
        out[f"{key}/stream{rid}"] = np.asarray(toks)
    return None


def _restore(inp, path, ctx, plan, out: dict, key: str):
    from repro_torch.runtime import snapshot as S
    from repro_torch.runtime.scheduler import FINISHED

    s = S.restore_scheduler(path, CFG, ctx, _params(inp), faults=plan, device="cpu")
    for rid, toks in s.run().items():
        out[f"{key}/stream{rid}"] = np.asarray(toks)
    out[f"{key}/finished"] = np.asarray(all(r.state == FINISHED for r in s.requests))


def _rank_main(rank, rnd, init_file, inputs, base):
    """One port rank. Round 1: on 1 x 4 then 2 x 2, the uninterrupted run,
    the crashed run (its file) and its restore, the agreement refusal,
    and on 2 x 2 the 1 x 4 file's refusal. Round 2 (1 x 4): the JAX
    package's file and the one-process file restored."""
    import torch.distributed as dist

    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.runtime import snapshot as S

    torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=120)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=4,
                            rank=rank, timeout=timeout)
    inp = dict(np.load(inputs))
    out = {}
    for shape in ((1, 4), (2, 2)) if rnd == 1 else ((1, 4),):
        tag = _tag(shape)
        ctx = ParallelCtx(mesh=make_mesh(*shape, timeout=timeout), capacity_factor=8.0)
        scfg = dict(SCHED, batch=_batch(shape))
        if rnd == 2:
            for name in ("jax14", "single"):
                _restore(inp, f"{base}/{name}.npz", ctx, _plan(4), out, f"{tag}/{name}")
            continue
        _run(inp, ctx, scfg, _plan(shape[1]), out, f"{tag}/free")
        path = f"{base}/port{shape[0]}{shape[1]}.npz"
        crash = _run(inp, ctx, scfg, _plan(shape[1], path), out, f"{tag}/crashed")
        _restore(inp, path, ctx, _plan(shape[1]), out, f"{tag}/restored")
        # one rank's snapshot differs: every rank refuses, naming it
        snap = crash.snapshot
        if rank == 1:
            snap = dataclasses.replace(snap, t=snap.t + 1)
        try:
            S.check_agreement(snap, "cpu")
        except RuntimeError as exc:
            out[f"{tag}/disagree"] = np.asarray(str(exc))
        if shape == (2, 2):
            try:
                _restore(inp, f"{base}/port14.npz", ctx, _plan(2), out, "refused")
            except ValueError as exc:
                out[f"{tag}/axis"] = np.asarray(str(exc))
    np.savez(Path(base) / f"round{rnd}_rank{rank}.npz", **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Round 1 writes the files (the port's ranks, the JAX subprocess and
    this process's one-process run), round 2 restores the other side's."""
    from repro_torch.parallel.ctx import ParallelCtx

    base = tmp_path_factory.mktemp("mesh_snapshot")
    inputs = base / "inputs.npz"
    inp = _inputs(inputs)
    single = {}
    procs = []
    try:
        for rnd in (1, 2):
            procs.append(_start_jax(inputs, base, base / f"jax{rnd}.npz", rnd))
            if rnd == 1:
                ctx = ParallelCtx(capacity_factor=8.0)
                scfg = dict(SCHED, batch=3)
                _run(inp, ctx, scfg, _plan(4), single, "free")
                _run(inp, ctx, scfg, _plan(4, str(base / "single.npz")), single, "crashed")
            else:
                _restore(inp, str(base / "port14.npz"), ParallelCtx(capacity_factor=8.0),
                         _plan(4), single, "restored")
            tmp.spawn(_rank_main, args=(rnd, str(base / f"pg{rnd}"), str(inputs), str(base)),
                      nprocs=4, join=True)
            _, err = procs[-1].communicate(timeout=600)
            assert procs[-1].returncode == 0, err[-4000:]
    finally:
        for proc in procs:
            proc.kill()
    port = {rnd: [dict(np.load(base / f"round{rnd}_rank{r}.npz")) for r in range(4)]
            for rnd in (1, 2)}
    ref = {**dict(np.load(base / "jax1.npz")),
           **{f"jax2/{k}": v for k, v in np.load(base / "jax2.npz").items()}}
    return port, ref, single


def _streams(d: dict, key: str) -> dict:
    return {k[len(key) + 1:]: v for k, v in d.items() if k.startswith(key + "/stream")}


def _same(got: dict, want: dict, what: str):
    assert got.keys() == want.keys() and len(want) == 4, what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_crash_restart_under_mesh_resumes(runs, shape):
    """The crash fires on every rank at tick 4; each rank restored from the
    one file serves every stream to the uninterrupted run's tokens, bit
    for bit, and finishes every request."""
    port, _, _ = runs
    tag = _tag(shape)
    for rank, r in enumerate(port[1]):
        assert int(r[f"{tag}/crashed/crash"]) == CRASH
        assert bool(r[f"{tag}/restored/finished"])
        _same(_streams(r, f"{tag}/restored"), _streams(r, f"{tag}/free"), f"{tag} rank {rank}")
        _same(_streams(r, f"{tag}/free"), _streams(port[1][0], f"{tag}/free"), f"rank {rank}")


def test_snapshot_files_cross_packages(runs):
    """On 1 x 4 the uninterrupted streams of both packages are equal; the
    port's file restored in the JAX Server, and the JAX package's file
    restored in the port on every rank, serve them on."""
    port, ref, _ = runs
    want = _streams(port[1][0], "1x4/free")
    _same(_streams(ref, "free"), want, "reference")
    _same(_streams(ref, "jax2/restored"), want, "the port's file in the reference")
    for rank, r in enumerate(port[2]):
        _same(_streams(r, "1x4/jax14"), want, f"the reference's file on rank {rank}")
        assert bool(r["1x4/jax14/finished"])


def test_snapshot_files_cross_layouts(runs):
    """The 1 x 4 file restored on one process with ``virtual_ep=4``, and
    that process's file restored on 1 x 4, serve the uninterrupted
    streams (one process's equal the mesh's)."""
    port, _, single = runs
    want = _streams(port[1][0], "1x4/free")
    _same(_streams(single, "free"), want, "one process")
    assert int(single["crashed/crash"]) == CRASH
    _same(_streams(single, "restored"), want, "the 1 x 4 file on one process")
    for rank, r in enumerate(port[2]):
        _same(_streams(r, "1x4/single"), want, f"the one-process file on rank {rank}")


def test_snapshot_refusals_under_mesh(runs):
    """The 1 x 4 file (4 EP devices) on 2 x 2 raises ``ValueError`` naming
    both device counts; a snapshot that differs on rank 1 raises
    ``RuntimeError`` on every rank, naming rank 1."""
    port, _, _ = runs
    for r in port[1]:
        msg = str(r["2x2/axis"])
        assert "spans 4 EP devices" in msg and "has 2" in msg, msg
        for tag in ("1x4", "2x2"):
            msg = str(r[f"{tag}/disagree"])
            assert "ranks [1]" in msg, msg
