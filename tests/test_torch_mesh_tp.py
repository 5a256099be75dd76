"""Tensor parallelism of the ``attn`` decoders under a mesh
(``parallel.sharding.tp_layout``): the port on four gloo processes
against the JAX package on four forced host devices (2 x 2 and 1 x 4),
fp32, the kernels' plain versions, on the same numpy parameters (the
port's seeded init) and prompts. The smoke configs have 4 query heads
and 2 KV heads, so 2 x 2 splits the KV heads and 1 x 4 copies each over
two ranks (``sharding.Copy``).

* Serving: dbrx-132b (EP, the balancer live; paged and dense cache),
  mixtral-8x22b (ESP, dense; held to the reference's EP Server, whose
  ESP expands slot rows it cannot read), llama3.2-1b (a dense MLP, tied embeddings;
  paged and dense) and qwen2-72b (QKV biases; paged), each rank holding
  its slices (the Server cuts them): greedy tokens equal to the
  reference Server's on the same mesh, the prefill's and every decode
  step's logits within 1e-5.
* Training, llama3.2-1b and qwen2-72b: one step against the reference's
  ``jax.jit(make_train_step)`` under ``state_specs``; the step-0
  gradients against the reference's ``jax.grad`` of its ``loss_fn``, the
  metrics and the parameters after the step, each within 1e-5 on the
  rank's slices; each rank's tensor-parallel slice is the reference's
  ``param_spec`` shard, but for a copied KV head, which holds the whole
  head whose half the reference's even split gives the rank; replicated
  gradients and the copies of a KV head bitwise equal across their
  ranks.
* A config with 6 query heads on 1 x 4: the attention stays replicated
  (the MLP and the vocab split), tokens and logits as with no mesh.
* The train CLI: a checkpoint of 2 steps on 1 x 4 resumed on 2 x 2 and
  with no mesh for 2 more, against 4 uninterrupted steps on 2 x 2.

One spawn of four ranks serves both meshes in turn, beside one JAX
subprocess; they meet through a file in the test's temporary directory,
and every group has a 120 s timeout.
"""

import dataclasses
import datetime
import os
import shutil
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
SHAPES = ((2, 2), (1, 4))
TOL = dict(rtol=1e-5, atol=1e-5)
CKPT_TOL = dict(rtol=2e-5, atol=2e-5)
# name -> (arch, the port's moe_impl, the reference's): the reference's ESP
# Server expands slot rows its ESP branch cannot read, so the port's ESP
# is held to the reference's EP (no copy dropped at capacity factor 8)
ARCHS = {"dbrx": ("dbrx-132b", "ep", "ep"), "mixtral": ("mixtral-8x22b", "esp", "ep"),
         "llama": ("llama3.2-1b", "auto", "auto"), "qwen2": ("qwen2-72b", "auto", "auto")}
SERVED = (("dbrx", True), ("dbrx", False), ("mixtral", False), ("llama", True),
          ("llama", False), ("qwen2", True))
TRAINED = ("llama", "qwen2")
SERVE = dict(max_seq=32, batch=4, slots_per_device=3, alpha=0.1, page_size=8)
N_NEW = 4
BATCH, SEQ = 4, 8
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
METRICS = ("loss", "ce", "aux", "grad_norm")


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


def _cfg(name):
    return smoke(get_config(ARCHS[name][0]))


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
    rng = np.random.default_rng(3)
    arr = {"prompt": rng.integers(0, 256, (SERVE["batch"], 8)).astype(np.int32),
           "tokens": rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32),
           "labels": rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32)}
    for name in ARCHS:
        params = T.init_params(_cfg(name), seed=0, device="cpu")
        arr.update({f"init/{name}/{k}": v for k, v in _flatten(params).items()})
    np.savez(path, **arr)
    return arr


JAX_SCRIPT = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import get_config, smoke
from repro.launch.mesh import make_mesh_compat
from repro.parallel.ctx import ParallelCtx
from repro.parallel.sharding import param_spec, state_specs, to_shardings
from repro.runtime.optimizer import AdamWConfig, adamw_init
from repro.runtime.serve import ServeConfig, Server
from repro.runtime.train import loss_fn, make_train_step

SHAPES, ARCHS, SERVED, TRAINED, SERVE, N_NEW, OPT, METRICS = {consts}
inp = dict(np.load(sys.argv[1]))
out = {{}}


def tree(prefix):
    t = {{}}
    for key, val in inp.items():
        if key.startswith(prefix):
            node = t
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {{}})
            node[leaf] = jnp.asarray(val)
    return t


def flat(t, prefix=""):
    if isinstance(t, dict):
        o = {{}}
        for k, v in t.items():
            o.update(flat(v, prefix + k + "/"))
        return o
    return {{prefix.rstrip("/"): t}}


def shards(mesh, shape, spec):
    idx = NamedSharding(mesh, spec).devices_indices_map(shape)
    return np.array([[[s.start or 0, shape[i] if s.stop is None else s.stop]
                      for i, s in enumerate(idx[d])] for d in mesh.devices.reshape(-1)])


prompt = jnp.asarray(inp["prompt"])
batch = {{k: jnp.asarray(inp[k]) for k in ("tokens", "labels")}}
for shape in SHAPES:
    tag = f"{{shape[0]}}x{{shape[1]}}"
    mesh = make_mesh_compat(shape, ("data", "model"))
    with mesh:
        for name, paged in SERVED:
            arch, _, impl = ARCHS[name]
            cfg = smoke(get_config(arch))
            ctx = ParallelCtx(mesh=mesh, moe_impl=impl, capacity_factor=8.0)
            srv = Server(cfg, ctx, tree(f"init/{{name}}/"), ServeConfig(paged=paged, **SERVE))
            logits, cache = srv.prefill(prompt)
            key = f"{{tag}}/serve/{{name}}/{{paged}}"
            out[f"{{key}}/logits/0"] = np.asarray(logits)
            toks = []
            tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
            for i in range(N_NEW):
                toks.append(np.asarray(tok))
                logits, cache = srv.decode(tok, cache)
                out[f"{{key}}/logits/{{i + 1}}"] = np.asarray(logits)
                tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
            out[f"{{key}}/tokens"] = np.concatenate(toks, 1)
        for name in TRAINED:
            cfg = smoke(get_config(ARCHS[name][0]))
            ctx = ParallelCtx(mesh=mesh, capacity_factor=8.0)
            params = tree(f"init/{{name}}/")
            state = {{"params": params, "opt": adamw_init(params)}}
            specs = state_specs(cfg, state, ctx)
            state = jax.device_put(state, to_shardings(mesh, specs))
            grads = jax.jit(jax.grad(lambda p: loss_fn(p, batch, cfg, ctx)[0]))(
                state["params"])
            state, met = jax.jit(make_train_step(cfg, ctx, AdamWConfig(**OPT)))(state, batch)
            key = f"{{tag}}/train/{{name}}"
            for k in METRICS:
                out[f"{{key}}/met/{{k}}"] = np.asarray(met[k])
            for path, leaf in flat(grads).items():
                out[f"{{key}}/grad/{{path}}"] = np.asarray(leaf)
            for path, leaf in flat(state["params"]).items():
                out[f"{{key}}/params/{{path}}"] = np.asarray(leaf)
                out[f"{{key}}/shards/{{path}}"] = shards(
                    mesh, leaf.shape, param_spec(path, leaf.shape, cfg, shape[1]))
np.savez(sys.argv[2], **out)
"""


def _start_jax(inputs: Path, out: Path) -> subprocess.Popen:
    consts = repr((SHAPES, ARCHS, SERVED, TRAINED, SERVE, N_NEW, OPT, METRICS))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT.format(consts=consts)),
         str(inputs), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _rank_main(rank, init_file, inputs, out_dir):
    """One port rank: both meshes' serving and training cells, the
    6-head fallback and the train CLI's checkpoints; ``rank<r>.npz``."""
    import torch.distributed as dist

    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch import train as cli
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.runtime.optimizer import AdamWConfig, adamw_init
    from repro_torch.runtime.serve import ServeConfig, Server
    from repro_torch.runtime.train import grads_of, make_train_step

    torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=120)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=4,
                            rank=rank, timeout=timeout)
    inp = dict(np.load(inputs))
    out = {}
    prompt = torch.tensor(inp["prompt"]).long()

    def params(name):
        return params_from_numpy(_unflatten(inp, f"init/{name}/"), device="cpu")

    def serve(cfg, ctx, p, paged, key):
        srv = Server(cfg, ctx, p, ServeConfig(paged=paged, **SERVE), device="cpu")
        logits, cache = srv.prefill(prompt)
        out[f"{key}/logits/0"] = logits.numpy()
        toks = []
        tok = torch.argmax(logits[:, -1:], dim=-1)
        for i in range(N_NEW):
            toks.append(tok)
            logits, cache = srv.decode(tok, cache)
            out[f"{key}/logits/{i + 1}"] = logits.numpy()
            tok = torch.argmax(logits[:, -1:], dim=-1)
        out[f"{key}/tokens"] = torch.cat(toks, 1).numpy()

    for shape in SHAPES:
        tag = _tag(shape)
        mesh = make_mesh(*shape, timeout=timeout)
        for name, paged in SERVED:
            ctx = ParallelCtx(mesh=mesh, moe_impl=ARCHS[name][1], capacity_factor=8.0)
            serve(_cfg(name), ctx, params(name), paged, f"{tag}/serve/{name}/{paged}")
        rows = sharding.batch_rows(BATCH, mesh.n_batch, mesh.batch_rank)
        batch = {k: torch.tensor(inp[k][rows]) for k in ("tokens", "labels")}
        for name in TRAINED:
            cfg, ctx = _cfg(name), ParallelCtx(mesh=mesh, capacity_factor=8.0)
            p = sharding.rank_params(params(name), cfg, ctx)
            key = f"{tag}/train/{name}"
            g0, _ = grads_of(p, batch, cfg, ctx)
            out.update({f"{key}/grad/{k}": v for k, v in _flatten(g0).items()})
            state, met = make_train_step(cfg, ctx, AdamWConfig(**OPT))(
                {"params": p, "opt": adamw_init(p)}, batch)
            out.update({f"{key}/met/{k}": met[k].numpy() for k in METRICS})
            out.update({f"{key}/params/{k}": v for k, v in _flatten(state["params"]).items()})
        if shape == (1, 4):
            # 6 query heads do not divide the model axis: attention replicated
            cfg = dataclasses.replace(_cfg("llama"), n_heads=6)
            full = T.init_params(cfg, seed=1, device="cpu")
            ctx = ParallelCtx(mesh=mesh)
            out["six/layout"] = np.asarray(sorted(sharding.tp_layout(cfg, ctx)))
            serve(cfg, ctx, T.init_params(cfg, seed=1, device="cpu"), True, "six/mesh")
            serve(cfg, ParallelCtx(), full, True, "six/none")
    # the CLI: 2 steps on 1 x 4, resumed on 2 x 2 (and, in the test, with
    # no mesh) for 2 more, against 4 uninterrupted steps on 2 x 2
    base = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--batch", str(BATCH),
            "--seq", str(SEQ), "--log-every", "100"]
    part, whole = Path(out_dir) / "ckpt_part", Path(out_dir) / "ckpt_whole"
    cli.main([*base, "--mesh", "1x4", "--steps", "2", "--ckpt-dir", str(part)])
    if rank == 0:
        shutil.copytree(part, Path(out_dir) / "ckpt_nomesh")
    dist.barrier()
    for name, d in (("resumed", part), ("whole", whole)):
        state, hist = cli.main([*base, "--mesh", "2x2", "--steps", "4", "--ckpt-dir", str(d)])
        out[f"cli/{name}/steps"] = np.asarray([r["step"] for r in hist])
        for k in METRICS:
            out[f"cli/{name}/{k}"] = np.asarray([r[k] for r in hist])
        out.update({f"cli/{name}/state/{k}": v for k, v in _flatten(state).items()})
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_tp")
    inputs = base / "inputs.npz"
    _inputs(inputs)
    proc = _start_jax(inputs, base / "jax.npz")
    try:
        tmp.spawn(_rank_main, args=(str(base / "pg"), str(inputs), str(base)), nprocs=4,
                  join=True)
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    port = [dict(np.load(base / f"rank{r}.npz")) for r in range(4)]
    return dict(np.load(base / "jax.npz")), port, base


def _ctx(shape, rank) -> ParallelCtx:
    return ParallelCtx(mesh=Mesh(shape[0], shape[1], rank, None, None))


@pytest.mark.parametrize("case", SERVED, ids=[f"{n}-{'paged' if p else 'dense'}"
                                               for n, p in SERVED])
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_tp_serving_matches_reference(runs, shape, case):
    """Every rank's greedy tokens equal the reference Server's on the same
    mesh; the prefill's and each decode step's logits within 1e-5."""
    ref, port, _ = runs
    key = f"{_tag(shape)}/serve/{case[0]}/{case[1]}"
    for rank in range(4):
        np.testing.assert_array_equal(port[rank][f"{key}/tokens"], ref[f"{key}/tokens"],
                                      err_msg=f"rank {rank}")
        for i in range(N_NEW + 1):
            np.testing.assert_allclose(port[rank][f"{key}/logits/{i}"],
                                       ref[f"{key}/logits/{i}"],
                                       err_msg=f"rank {rank} step {i}", **TOL)


@pytest.mark.parametrize("name", TRAINED)
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_tp_train_step_matches_reference(runs, shape, name):
    """One train step: the metrics, and on each rank's slices the step-0
    gradients and the parameters after the step, within 1e-5 of the
    reference's GSPMD step under ``state_specs``."""
    ref, port, _ = runs
    key = f"{_tag(shape)}/train/{name}"
    cfg = _cfg(name)
    for rank in range(4):
        got = port[rank]
        for k in METRICS:
            np.testing.assert_allclose(got[f"{key}/met/{k}"], ref[f"{key}/met/{k}"],
                                       err_msg=f"rank {rank} {k}", **TOL)
        layout = sharding.param_layout(cfg, _ctx(shape, rank))
        assert len(layout) == 8 + 3 * cfg.qkv_bias + (not cfg.tie_embeddings)
        for what in ("grad", "params"):
            keys = [k for k in ref if k.startswith(f"{key}/{what}/")]
            assert len(keys) > 10
            for k in keys:
                path = k[len(f"{key}/{what}/"):]
                want = ref[k]
                spec = layout.get(path)
                if spec is not None:
                    want = sharding.take(torch.from_numpy(want), *spec).numpy()
                np.testing.assert_allclose(got[k], want, err_msg=f"rank {rank} {k}", **TOL)


@pytest.mark.parametrize("name", TRAINED)
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_tp_slices_are_reference_shards(runs, shape, name):
    """Each tensor-parallel leaf a rank holds is the reference's
    ``param_spec`` shard of its device, the same range of the same dim;
    a copied KV head (1 x 4: 2 KV heads of 16 columns on 4 ranks) holds
    the whole head, of which the reference's even split gives the rank
    half."""
    ref, _, _ = runs
    key = f"{_tag(shape)}/train/{name}"
    cfg = _cfg(name)
    copies = 0
    for rank in range(4):
        for path, (dim, part) in sharding.tp_layout(cfg, _ctx(shape, rank)).items():
            lo, hi = ref[f"{key}/shards/{path}"][rank][dim]
            if isinstance(part, sharding.Copy):
                copies += 1
                assert part.block.start <= lo < hi <= part.block.stop, path
                assert hi - lo == (part.block.stop - part.block.start) // part.copies
            else:
                assert (lo, hi) == (part.start, part.stop), path
    assert copies == (0 if shape == (2, 2) else 4 * (4 if cfg.qkv_bias else 2))


@pytest.mark.parametrize("name", TRAINED)
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_tp_gradients_bitwise_across_model_group(runs, shape, name):
    """The step-0 gradient of every leaf replicated over the model group
    is the same, bit for bit, on every rank of the group, and so is a
    copied KV head's on the ranks that hold it."""
    _, port, _ = runs
    data, model = shape
    prefix = f"{_tag(shape)}/train/{name}/grad/"
    cfg = _cfg(name)
    n_copied = 0
    for g in range(data):
        group = list(range(g * model, (g + 1) * model))
        layouts = {r: sharding.param_layout(cfg, _ctx(shape, r)) for r in group}
        keys = [k[len(prefix):] for k in port[group[0]] if k.startswith(prefix)]
        for path in keys:
            spec = layouts[group[0]].get(path)
            if spec is None:
                for r in group[1:]:
                    np.testing.assert_array_equal(port[r][prefix + path],
                                                  port[group[0]][prefix + path], err_msg=path)
            elif isinstance(spec[1], sharding.Copy):
                for r in group:
                    same = [q for q in group
                            if layouts[q][path][1].block == layouts[r][path][1].block]
                    for q in same:
                        np.testing.assert_array_equal(port[q][prefix + path],
                                                      port[r][prefix + path], err_msg=path)
                    n_copied += len(same) > 1
    assert n_copied == (0 if shape == (2, 2) else 4 * (4 if cfg.qkv_bias else 2))


def test_tp_falls_back_where_heads_do_not_divide(runs):
    """6 query heads on 1 x 4: no attention leaf splits (the MLP and the
    vocab do), and every rank's tokens and logits are the no-mesh run's."""
    _, port, _ = runs
    for rank in range(4):
        got = port[rank]
        assert list(got["six/layout"]) == ["embed", "layers/mlp/w_down", "layers/mlp/w_gate",
                                           "layers/mlp/w_up"]
        np.testing.assert_array_equal(got["six/mesh/tokens"], got["six/none/tokens"])
        for i in range(N_NEW + 1):
            np.testing.assert_allclose(got[f"six/mesh/logits/{i}"], got[f"six/none/logits/{i}"],
                                       err_msg=f"rank {rank} step {i}", **TOL)


def test_tp_checkpoint_moves_between_meshes(runs):
    """The CLI's checkpoint of 2 steps on 1 x 4 (global arrays: one copy
    of each KV head), resumed on 2 x 2 and with no mesh for 2 more steps,
    equals 4 uninterrupted steps on 2 x 2 within 2e-5: the logged metrics
    of steps 2 and 3 and each rank's final slices."""
    from repro_torch.launch import train as cli

    _, port, base = runs
    for rank in range(4):
        r = port[rank]
        assert list(r["cli/resumed/steps"]) == [2, 3]
        for k in METRICS:
            np.testing.assert_allclose(r[f"cli/resumed/{k}"], r[f"cli/whole/{k}"][2:],
                                       err_msg=k, **CKPT_TOL)
        keys = [k for k in r if k.startswith("cli/resumed/state/")]
        assert len(keys) > 10
        for k in keys:
            np.testing.assert_allclose(r[k], r[k.replace("/resumed/", "/whole/")],
                                       err_msg=k, **CKPT_TOL)
    _, hist = cli.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--batch",
                        str(BATCH), "--seq", str(SEQ), "--log-every", "100", "--steps", "4",
                        "--ckpt-dir", str(base / "ckpt_nomesh")])
    assert [h["step"] for h in hist] == [2, 3]
    for k in METRICS:
        np.testing.assert_allclose([h[k] for h in hist], port[0][f"cli/whole/{k}"][2:],
                                   err_msg=k, **CKPT_TOL)
