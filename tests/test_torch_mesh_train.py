"""Training under a mesh: the port on four gloo processes against the JAX
package's ``jax.jit(make_train_step)`` with the state placed by
``state_specs`` on four forced host devices, on the same numpy inputs
and parameters (the port's seeded init, as numpy to both packages),
fp32.

One spawn of four ranks serves three meshes in turn (2 x 2, 1 x 4 and
the pod mesh 2 x 1 x 2); one JAX subprocess runs the reference on the
same shapes beside it. The model is dbrx-132b's ``smoke()`` (4 experts,
top-2, d 64, 2 layers) at capacity factor 8.0 (no copy dropped), on a
global batch of 4 x 8 tokens. Cases:

* EP, the fused branch (the kernels' plain versions) and the padded
  branch;
* ESP forced, at hidden dims 96 (the kernel branch: reduce-scatter onto
  d) and 90 (on 1 x 4 the einsum branch on whole experts, 90 not
  dividing 4; on the model axes of two, the kernel branch).

The reference runs its einsum branches (the same functions: its kernel
branches differ in the forward's rounding only), and on 2 x 2 its EP
kernel branch too, in interpret mode, against the port's fused branch:
the interpret mode costs most of the reference's time, which bounds this
file's.

After 2 steps: ``loss``, ``ce``, ``aux`` and ``grad_norm`` within 1e-5 of
the reference's; each rank's slices of the parameters, ``mu`` and
``sqrt(nu)`` within 2e-5 of the reference's global arrays; the step-0
gradients of the leaves replicated over the model group equal bit for
bit on every rank of it. On 2 x 2: remat equal to no remat, bit for bit,
and 2 microbatches against the reference's. On the pod mesh:
``compressed_pod_mean`` within 0.03 of the exact mean relative to its
largest value (the reference's bound, ``tests/test_multidevice.py``),
equal on both pods, int8 on the wire, and the tree itself returned on a
mesh of one pod. The CLI: a checkpoint from 2 steps on 2 x 2, restored on
1 x 4 for 2 more, against 4 uninterrupted steps on 1 x 4.

The ranks meet through a file in the test's temporary directory, and
every group has a 120 s timeout, so that a collective one rank skips
fails instead of hanging.
"""

import dataclasses
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
from repro_torch.parallel import sharding
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.mesh import Mesh

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
# tag -> (shape, axes); the port's make_mesh(data, model, pod=)
MESHES = {"2x2": ((2, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
# case -> (moe_impl, the port's use_kernels, hidden dim)
CASES = {"ep_fused": ("ep", "auto", 96), "ep_padded": ("ep", False, 96),
         "esp96": ("esp", "auto", 96), "esp90": ("esp", "auto", 90)}
REF_KERNELS = ("2x2", "ep_fused")     # held against the reference's kernel branch
MICRO = ("2x2", "ep_padded")          # also run as 2 microbatches
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
CF = 8.0
BATCH, SEQ = 4, 8
METRICS = ("loss", "ce", "aux", "grad_norm")
TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=2e-5, atol=2e-5)
POD_BOUND = 0.03


def _cfg(f: int):
    return dataclasses.replace(smoke(get_config("dbrx-132b")), moe_d_ff=f)


def _shape(tag):
    shape = MESHES[tag][0]
    return (1, *shape) if len(shape) == 2 else shape          # (pod, data, model)


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
        if not key.startswith(prefix):
            continue
        node = tree
        *path, leaf = key[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def _ref_key(tag: str, case: str, mb: int = 1) -> str:
    """The reference run a port cell is held against."""
    impl, _, f = CASES[case]
    return f"{tag}/{impl}/{f}/{(tag, case) == REF_KERNELS}/{mb}"


def _ref_runs() -> list:
    """``(key, tag, moe_impl, use_kernels, hidden dim, microbatches)`` of
    every distinct reference run."""
    runs = {}
    for tag in MESHES:
        for case, (impl, _, f) in CASES.items():
            for mb in (1, 2) if (tag, case) == MICRO else (1,):
                key = _ref_key(tag, case, mb)
                runs[key] = (key, tag, impl, (tag, case) == REF_KERNELS, f, mb)
    return list(runs.values())


def _inputs(path: Path) -> dict:
    rng = np.random.default_rng(7)
    arr = {k: rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32) for k in ("tokens", "labels")}
    for f in sorted({c[2] for c in CASES.values()}):
        params = T.init_params(_cfg(f), seed=0, device="cpu")
        arr.update({f"init/{f}/{k}": v for k, v in _flatten(
            {n: t.numpy() for n, t in _items(params)}).items()})
    np.savez(path, **arr)
    return arr


JAX_SCRIPT = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config, smoke
from repro.launch.mesh import make_mesh_compat
from repro.parallel.ctx import ParallelCtx
from repro.parallel.sharding import state_specs, to_shardings
from repro.runtime.optimizer import AdamWConfig, adamw_init
from repro.runtime.train import make_train_step

MESHES, RUNS, OPT, CF, METRICS = {consts}
inp = dict(np.load(sys.argv[1]))
out = {{}}
opt = AdamWConfig(**OPT)

def init(f):
    tree = {{}}
    for key, val in inp.items():
        if key.startswith(f"init/{{f}}/"):
            node = tree
            *path, leaf = key[len(f"init/{{f}}/"):].split("/")
            for p in path:
                node = node.setdefault(p, {{}})
            node[leaf] = jnp.asarray(val)
    return {{"params": tree, "opt": adamw_init(tree)}}

batch = {{k: jnp.asarray(inp[k]) for k in ("tokens", "labels")}}
micro = {{k: v.reshape(2, v.shape[0] // 2, v.shape[1]) for k, v in batch.items()}}
meshes = {{}}
for key, tag, impl, uk, f, mb in RUNS:
    shape, axes = MESHES[tag]
    mesh = meshes.setdefault(tag, make_mesh_compat(shape, axes))
    cfg = dataclasses.replace(smoke(get_config("dbrx-132b")), moe_d_ff=f)
    ctx = ParallelCtx(mesh=mesh, batch_axes=tuple(a for a in axes if a != "model"),
                      moe_impl=impl, use_kernels=uk, capacity_factor=CF)
    state = init(f)
    with mesh:
        state = jax.device_put(state, to_shardings(mesh, state_specs(cfg, state, ctx)))
        fn = jax.jit(make_train_step(cfg, ctx, opt, microbatches=mb))
        for i in range(2):
            state, met = fn(state, batch if mb == 1 else micro)
            for k in METRICS:
                out[f"{{key}}/met/{{i}}/{{k}}"] = np.asarray(met[k])
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        out[f"{{key}}/state/{{name}}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
"""


def _start_jax(inputs: Path, out: Path) -> subprocess.Popen:
    consts = repr((MESHES, _ref_runs(), OPT, CF, METRICS))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT.format(consts=consts)),
         str(inputs), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _rank_main(rank, init_file, inputs, out_dir):
    """One port rank: every mesh and case, the pod sync and the CLI's
    elastic restore; saved as ``rank<r>.npz``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch import train as cli
    from repro_torch.parallel import grad_compress
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.runtime.optimizer import AdamWConfig, adamw_init
    from repro_torch.runtime.train import grads_of, make_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=4,
                            rank=rank)
    timeout = datetime.timedelta(seconds=120)
    inp = dict(np.load(inputs))
    out = {}
    opt = AdamWConfig(**OPT)
    for tag in MESHES:
        pod, data, model = _shape(tag)
        mesh = make_mesh(data, model, pod=pod, timeout=timeout)
        rows = sharding.batch_rows(BATCH, mesh.n_batch, mesh.batch_rank)
        batch = {k: torch.tensor(inp[k][rows]) for k in ("tokens", "labels")}
        for case, (impl, uk, f) in CASES.items():
            cfg = _cfg(f)
            runs = [(1, False)] + [(1, True)] * (tag == "2x2") + [(2, False)] * (
                (tag, case) == MICRO)
            for mb, remat in runs:
                ctx = ParallelCtx(mesh=mesh, moe_impl=impl, use_kernels=uk,
                                  capacity_factor=CF, remat=remat)
                full = params_from_numpy(_unflatten(inp, f"init/{f}/"), device="cpu")
                params = sharding.rank_params(full, cfg, ctx)
                state = {"params": params, "opt": adamw_init(params)}
                key = f"{tag}/{case}/{mb}/{remat}"
                if mb == 1:
                    g0, _ = grads_of(params, batch, cfg, ctx)
                    out.update({f"{key}/grad/{k}": v for k, v in _flatten(
                        {n: t.numpy() for n, t in _items(g0)}).items()})
                    b = batch
                else:
                    mrows = sharding.batch_rows(BATCH // mb, mesh.n_batch, mesh.batch_rank)
                    b = {k: torch.tensor(inp[k]).reshape(mb, BATCH // mb, SEQ)[:, mrows]
                         for k in ("tokens", "labels")}
                step = make_train_step(cfg, ctx, opt, microbatches=mb)
                for i in range(2):
                    state, met = step(state, b)
                    for k in METRICS:
                        out[f"{key}/met/{i}/{k}"] = met[k].numpy()
                out.update({f"{key}/state/{k}": v for k, v in _flatten(
                    {n: t.numpy() for n, t in _items(state)}).items()})
        # the cross-pod sync: each rank's leaves drawn from (pod, data, model)
        tree = _pod_tree(mesh.pod_rank, mesh.data_rank, mesh.model_rank)
        if mesh.pod == 1:
            out[f"{tag}/pod/same_object"] = np.asarray(
                grad_compress.compressed_pod_mean(tree, mesh) is tree)
            continue
        seen = []
        a2a, gather = dist.all_to_all_single, dist.all_gather_into_tensor
        dist.all_to_all_single = lambda o, i, **kw: (seen.append(("a2a", i.dtype, i.numel())),
                                                     a2a(o, i, **kw))[1]
        dist.all_gather_into_tensor = lambda o, i, **kw: (
            seen.append(("gather", i.dtype, i.numel())), gather(o, i, **kw))[1]
        try:
            got = grad_compress.compressed_pod_mean(tree, mesh, seed=3)
        finally:
            dist.all_to_all_single, dist.all_gather_into_tensor = a2a, gather
        out.update({f"{tag}/pod/got/{k}": v for k, v in _flatten(
            {"w": got["w"].numpy(), "b": {"v": got["b"]["v"].float().numpy()}}).items()})
        out[f"{tag}/pod/wire"] = np.array([f"{w} {str(d)} {n}" for w, d, n in seen])
    # the CLI: 2 steps on 2 x 2 and 2 more on 1 x 4 from the checkpoint,
    # against 4 steps on 1 x 4
    base = ["--arch", "dbrx-132b", "--smoke", "--device", "cpu", "--batch", str(BATCH),
            "--seq", str(SEQ), "--log-every", "100"]
    part, whole = Path(out_dir) / "ckpt_part", Path(out_dir) / "ckpt_whole"
    cli.main([*base, "--mesh", "2x2", "--steps", "2", "--ckpt-dir", str(part)])
    for name, d in (("resumed", part), ("whole", whole)):
        state, hist = cli.main([*base, "--mesh", "1x4", "--steps", "4", "--ckpt-dir", str(d)])
        out.update({f"cli/{name}/state/{k}": v for k, v in _flatten(
            {n: t.numpy() for n, t in _items(state)}).items()})
        out[f"cli/{name}/steps"] = np.asarray([r["step"] for r in hist])
        for k in METRICS:
            out[f"cli/{name}/{k}"] = np.asarray([r[k] for r in hist])
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def _items(tree, prefix=""):
    """(path, tensor) pairs of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def _pod_tree(pod_rank: int, data_rank: int, model_rank: int) -> dict:
    gen = torch.Generator().manual_seed(1000 * pod_rank + 10 * data_rank + model_rank)
    return {"w": torch.randn((64, 33), generator=gen),
            "b": {"v": (torch.randn((17,), generator=gen) * 3).to(torch.bfloat16)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_train")
    inputs = base / "inputs.npz"
    _inputs(inputs)
    jax_out = base / "jax.npz"
    proc = _start_jax(inputs, jax_out)
    try:
        tmp.spawn(_rank_main, args=(str(base / "pg"), str(inputs), str(base)), nprocs=4,
                  join=True)
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    port = [dict(np.load(base / f"rank{r}.npz")) for r in range(4)]
    return dict(np.load(jax_out)), port


def _ctx(tag, rank, case) -> ParallelCtx:
    pod, data, model = _shape(tag)
    return ParallelCtx(mesh=Mesh(data, model, rank, None, None, pod), moe_impl=CASES[case][0])


def _model_groups(tag):
    pod, data, model = _shape(tag)
    return [list(range(g * model, (g + 1) * model)) for g in range(pod * data)]


@pytest.mark.parametrize("case", tuple(CASES))
@pytest.mark.parametrize("tag", tuple(MESHES))
def test_metrics_match_reference(runs, tag, case):
    """Every rank reports the global loss, ce, aux and grad norm of each
    step, the reference's within 1e-5."""
    ref, port = runs
    for rank in range(4):
        for i in range(2):
            for k in METRICS:
                np.testing.assert_allclose(
                    port[rank][f"{tag}/{case}/1/False/met/{i}/{k}"],
                    ref[f"{_ref_key(tag, case)}/met/{i}/{k}"],
                    err_msg=f"rank {rank} step {i} {k}", **TOL)


def _hold_state(got: dict, ref: dict, prefix: str, layout: dict, what: str):
    """A rank's state (``got``, flat keys after ``prefix``) against the
    reference's global arrays cut to the rank's slices: the step equal,
    the params and ``mu`` at 2e-5, ``nu`` through its square root."""
    n = 0
    for key, want in ref.items():
        if not key.startswith(prefix):
            continue
        path = key[len(prefix):]
        spec = layout.get(path.split("/", 1)[1] if path.startswith("params/") else
                          path.split("/", 2)[-1] if path.startswith("opt/") else None)
        if spec is not None and path != "opt/step":
            want = sharding.take(torch.from_numpy(want), *spec).numpy()
        have = got[f"{what}/{path}"]
        if path.startswith("opt/nu/"):
            have, want = np.sqrt(have), np.sqrt(want)
        tol = dict(rtol=0, atol=0) if path == "opt/step" else STATE_TOL
        np.testing.assert_allclose(have, want, err_msg=f"{what} {path}", **tol)
        n += 1
    assert n > 10


@pytest.mark.parametrize("case", tuple(CASES))
@pytest.mark.parametrize("tag", tuple(MESHES))
def test_state_slices_match_reference(runs, tag, case):
    """Each rank's slices of the parameters and the moments after 2 steps
    against the reference's global arrays; the sharded leaves are the
    rank's own (EP slot rows, ESP hidden shards, the tensor-parallel
    leaves: its query heads, its KV heads or a copy of one, its vocab
    rows and columns)."""
    ref, port = runs
    for rank in range(4):
        ctx = _ctx(tag, rank, case)
        impl, _, f = CASES[case]
        layout = sharding.param_layout(_cfg(f), ctx)
        moe = [k for k in layout if "/moe/" in k]
        assert bool(moe) == sharding.is_split(4 if impl == "ep" else f, ctx.n_model)
        tp = sharding.tp_layout(_cfg(f), ctx)
        assert len(tp) == 6 and set(tp) <= set(layout)
        _hold_state(port[rank], ref, f"{_ref_key(tag, case)}/state/", layout,
                    f"{tag}/{case}/1/False/state")


@pytest.mark.parametrize("case", tuple(CASES))
@pytest.mark.parametrize("tag", tuple(MESHES))
def test_replicated_gradients_bitwise_equal_in_model_group(runs, tag, case):
    """The step-0 gradient of every leaf replicated over the model group
    (all but the sharded expert weights and the tensor-parallel leaves)
    is the same, bit for bit, on every rank of the group: replicated
    parameters cannot drift apart."""
    _, port = runs
    prefix = f"{tag}/{case}/1/False/grad/"
    for group in _model_groups(tag):
        ctx = _ctx(tag, group[0], case)
        layout = sharding.param_layout(_cfg(CASES[case][2]), ctx)
        keys = [k for k in port[group[0]] if k.startswith(prefix)]
        rep = [k for k in keys if k[len(prefix):] not in layout]
        assert len(rep) >= len(keys) - 3 - len(sharding.tp_layout(_cfg(CASES[case][2]), ctx))
        assert rep
        for rank in group[1:]:
            for k in rep:
                np.testing.assert_array_equal(port[rank][k], port[group[0]][k], err_msg=k)


@pytest.mark.parametrize("case", tuple(CASES))
def test_remat_equals_no_remat(runs, case):
    """On 2 x 2 the recompute re-issues each layer's collectives in the
    same order on every rank: gradients, metrics and states bit for bit."""
    _, port = runs
    for rank in range(4):
        on = {k.split("/True/", 1)[1]: v for k, v in port[rank].items()
              if k.startswith(f"2x2/{case}/1/True/")}
        assert on
        for k, v in on.items():
            np.testing.assert_array_equal(v, port[rank][f"2x2/{case}/1/False/{k}"], err_msg=k)


def test_microbatches_match_reference(runs):
    """2 microbatches of 2 rows on 2 x 2 (one row a data rank each)
    against the reference's ``microbatches=2``."""
    ref, port = runs
    tag, case = MICRO
    for rank in range(4):
        for i in range(2):
            for k in METRICS:
                np.testing.assert_allclose(port[rank][f"{tag}/{case}/2/False/met/{i}/{k}"],
                                           ref[f"{_ref_key(tag, case, 2)}/met/{i}/{k}"],
                                           err_msg=f"rank {rank} step {i} {k}", **TOL)
        layout = sharding.param_layout(_cfg(CASES[case][2]), _ctx(tag, rank, case))
        _hold_state(port[rank], ref, f"{_ref_key(tag, case, 2)}/state/", layout,
                    f"{tag}/{case}/2/False/state")


@pytest.mark.parametrize("leaf", ("w", "b/v"))
def test_compressed_pod_mean_on_the_pod_mesh(runs, leaf):
    """Within 0.03 of the exact mean relative to its largest value, the
    same on both pods (ranks r and r + 2 share a (data, model)
    coordinate), int8 operands on the wire but the per-tensor scales; the
    tree itself on the meshes of one pod."""
    _, port = runs
    for rank in range(4):
        pod_rank, model_rank = rank // 2, rank % 2
        vals = [_pod_tree(p, 0, model_rank) for p in range(2)]
        node = [v["w"] if leaf == "w" else v["b"]["v"] for v in vals]
        exact = sum(t.double() for t in node).numpy() / 2
        got = port[rank][f"2x1x2/pod/got/{leaf}"]
        rel = np.abs(got - exact).max() / np.abs(exact).max()
        assert rel < POD_BOUND, (rank, rel)
        np.testing.assert_array_equal(got, port[(rank + 2) % 4][f"2x1x2/pod/got/{leaf}"])
        wire = [w.split() for w in port[rank]["2x1x2/pod/wire"]]
        assert [w for w in wire if w[0] == "a2a"] and all(
            w[1] == "torch.int8" for w in wire if w[0] == "a2a")
        assert all(w[1] == "torch.int8" or w[2] == "1" for w in wire)
        assert sum(w[1] == "torch.int8" for w in wire) == 4          # 2 leaves x 2 legs
        for tag in ("2x2", "1x4"):
            assert bool(port[rank][f"{tag}/pod/same_object"])


def test_checkpoint_resumes_on_another_mesh(runs):
    """The CLI's checkpoint after 2 steps on 2 x 2 (global arrays, the
    reference's format), restored on 1 x 4 and run 2 more steps, equals 4
    uninterrupted steps on 1 x 4: the logged metrics of steps 2 and 3 and
    each rank's final slices."""
    _, port = runs
    for rank in range(4):
        r = port[rank]
        assert list(r["cli/resumed/steps"]) == [2, 3]
        assert list(r["cli/whole/steps"]) == [0, 1, 2, 3]
        for k in METRICS:
            np.testing.assert_allclose(r[f"cli/resumed/{k}"], r[f"cli/whole/{k}"][2:],
                                       err_msg=k, **TOL)
        keys = [k for k in r if k.startswith("cli/resumed/state/")]
        assert len(keys) > 10
        for k in keys:
            np.testing.assert_allclose(r[k], r[k.replace("/resumed/", "/whole/")],
                                       err_msg=k, **STATE_TOL)
