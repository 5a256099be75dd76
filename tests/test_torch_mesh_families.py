"""The zamba, xlstm and encoder-decoder families under a ``("data",
"model")`` mesh of four gloo processes on the CPU (2 x 2 and 1 x 4),
against the JAX package on the same mesh shapes (four forced host devices
in one subprocess a shape, run beside the port's ranks), fp32, the
kernels' plain versions, the same numpy parameters (the port's seeded
init with the leaves the reference initialises to constants made random,
as ``tests/test_torch_families.py`` does) and inputs.

Models (``smoke()`` reductions):

* ``zamba128``: zamba at d_model 128 and 5 layers: 4 Mamba2 heads, which
  split over both model axes, and a trailing Mamba2 layer;
* ``zamba``: the stock smoke model's 2 heads, split on 2 x 2 and
  replicated on 1 x 4 (the layout's fallback);
* ``xlstm``: every parameter replicated, the states split by rows;
* ``seamless``: 8 frontend tokens, ``cross_kv`` split by sequence on both
  meshes; ``seamless6``: 6 tokens, split by sequence on 2 x 2 and by KV
  heads on 1 x 4.

Tensor parallelism (``sharding.tp_layout``): zamba's shared attention and
MLP and the encoder-decoder's encoder, decoder self-attention,
cross-attention and MLPs split their 4 query and KV heads (2 a rank on
2 x 2, 1 on 1 x 4) and their hidden dim, and both models their vocab;
each rank's slice is the reference's ``param_spec`` shard. xLSTM stays
replicated, as in the reference. A config with 6 query heads on 1 x 4
keeps its attention whole (the MLPs and the vocab split), with tokens
and logits as with no mesh.

Serving (the ``Server``): the greedy tokens equal, the prefill and every
decode step's logits within 1e-5, and each rank's shard of every cache
leaf after prefill and ``N_NEW`` decode steps (the Mamba2 SSM heads and
conv channels, ``shared_kv``, the xLSTM states, the decoder's dense cache,
``cross_kv``) within 1e-5 of the reference's global cache at the rank's
slice. Training (all but ``seamless6``, whose cross-attention trains as
``seamless``'s): two steps of ``make_train_step`` against the reference's
``jax.jit(make_train_step)`` under ``state_specs``: each step's
gradients (against the reference's ``jax.grad`` of its ``loss_fn``) and
metrics within 1e-5, each rank's slices of the parameters and the
moments within 1e-5 (``sqrt(nu)``; the parameters whose gradients the
packages round apart, Adam's ill-conditioned elements, at ``2 *
sum(lr)``), and the first step's gradients of every leaf replicated over
the model group (the B/C columns of the mixed Mamba2 leaves too) equal
bit for bit on every rank of it.

The train CLI: a checkpoint of the smoke zamba written on 1 x 4 (the
shared block split 4 ways) and resumed on 2 x 2, where its Mamba2 leaves
split and the shared block 2 ways, and with no mesh, against an
uninterrupted run. Plus the layout functions of ``parallel.sharding`` on
one process.

The ranks meet through a file in the test's temporary directory and
every group has a 120 s timeout, so that a collective one rank skips
fails instead of hanging.
"""

import dataclasses
import datetime
import os
import shutil
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from repro_torch.configs import get_config, smoke
from repro_torch.models import attention as A
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.mesh import Mesh

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((2, 2), (1, 4))
TOL = dict(rtol=1e-5, atol=1e-5)
APART = 1e-3                      # a gradient rounded apart by this share of itself
# name -> (arch, config overrides)
MODELS = {"zamba128": ("zamba2-1.2b", {"d_model": 128, "n_layers": 5}),
          "zamba": ("zamba2-1.2b", {}),
          "xlstm": ("xlstm-350m", {}),
          "seamless": ("seamless-m4t-medium", {}),
          "seamless6": ("seamless-m4t-medium", {"frontend_tokens": 6})}
TRAINED = ("zamba128", "zamba", "xlstm", "seamless")
SERVE = dict(max_seq=16, batch=4)
PROMPT, N_NEW = 6, 4
SIX = ("zamba", "seamless")       # served again with 6 query heads and 2 KV heads
SEQ = 8
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
METRICS = ("loss", "ce", "aux", "grad_norm")
# the reference's parameters after its first train step, which its
# subprocess writing ``out`` leaves for the port's ranks
P1_FILE = "{out}.{name}.p1.npz"
# leaves the reference initialises to constants: ones get 1 + noise, the
# rest noise (a_log small, so that the Mamba2 decay stays in (0, 1))
CONSTANT_LEAVES = {"ln1": 1, "ln2": 1, "ln_x": 1, "ln": 1, "final_norm": 1, "enc_norm": 1,
                   "norm_w": 1, "d_skip": 1, "bq": 0, "bk": 0, "bv": 0, "conv_b": 0,
                   "a_log": 0, "dt_bias": 0, "b_gates": 0, "b_in": 0}


def _cfg(name: str):
    arch, kw = MODELS[name]
    return dataclasses.replace(smoke(get_config(arch)), **kw)


def _tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def _flatten(tree, prefix=""):
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    if tree is None or isinstance(tree, int):
        return {}
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


def _inputs(path: Path) -> dict:
    rng = np.random.default_rng(28)
    arr = {}
    for name in MODELS:
        cfg = _cfg(name)
        params = _flatten({k: v for k, v in T.init_params(cfg, seed=0, device="cpu").items()})
        for key, a in params.items():
            leaf = key.rsplit("/", 1)[-1]
            if leaf in CONSTANT_LEAVES:
                a = (CONSTANT_LEAVES[leaf] + rng.normal(0, 0.1, a.shape)).astype(a.dtype)
            arr[f"{name}/params/{key}"] = a
        b = SERVE["batch"]
        arr[f"{name}/prompt"] = rng.integers(0, cfg.vocab_size, (b, PROMPT)).astype(np.int32)
        for k in ("tokens", "labels"):
            arr[f"{name}/{k}"] = rng.integers(0, cfg.vocab_size, (b, SEQ)).astype(np.int32)
        if cfg.frontend_stub:
            arr[f"{name}/embeds"] = rng.normal(
                0, 0.5, (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    np.savez(path, **arr)
    return arr


JAX_SCRIPT = """
import dataclasses, os, sys
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

SHAPE, MODELS, TRAINED, SERVE, N_NEW, OPT, METRICS, P1_FILE = {consts}
inp = dict(np.load(sys.argv[1]))
out = {{}}
mesh = make_mesh_compat(SHAPE, ("data", "model"))
ctx = ParallelCtx(mesh=mesh)


def tree(prefix):
    t = {{}}
    for key, val in inp.items():
        if key.startswith(prefix):
            node = t
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {{}})
            node[leaf] = jnp.asarray(val)
    if "units" in t and "shared" in t:
        t.setdefault("trailing", None)       # zamba with no trailing layer
    return t


def paths(t):
    for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
        yield "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path), leaf


def flat(t, prefix):
    for name, leaf in paths(t):
        out[f"{{prefix}}/{{name}}"] = np.asarray(leaf)


def shards(shape, spec):
    idx = NamedSharding(mesh, spec).devices_indices_map(shape)
    return np.array([[[s.start or 0, shape[i] if s.stop is None else s.stop]
                      for i, s in enumerate(idx[d])] for d in mesh.devices.reshape(-1)])


for name, (arch, kw) in MODELS.items():
    cfg = dataclasses.replace(smoke(get_config(arch)), **kw)
    for path, leaf in paths(tree(f"{{name}}/params/")):
        out[f"{{name}}/shards/{{path}}"] = shards(leaf.shape,
                                                  param_spec(path, leaf.shape, cfg, SHAPE[1]))
    embeds = jnp.asarray(inp[f"{{name}}/embeds"]) if cfg.frontend_stub else None
    with mesh:
        srv = Server(cfg, ctx, tree(f"{{name}}/params/"), ServeConfig(**SERVE))
        logits, cache = srv.prefill(jnp.asarray(inp[f"{{name}}/prompt"]), embeds=embeds)
        out[f"{{name}}/logits/0"] = np.asarray(logits)
        toks = []
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        for i in range(N_NEW):
            toks.append(np.asarray(tok))
            logits, cache = srv.decode(tok, cache)
            out[f"{{name}}/logits/{{i + 1}}"] = np.asarray(logits)
            tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        out[f"{{name}}/tokens"] = np.concatenate(toks, 1)
        flat({{k: v for k, v in cache.items() if k != "pos"}}, f"{{name}}/cache")
    if name not in TRAINED:
        continue
    params = tree(f"{{name}}/params/")
    state = {{"params": params, "opt": adamw_init(params)}}
    batch = {{k: jnp.asarray(inp[f"{{name}}/{{k}}"]) for k in ("tokens", "labels")}}
    if embeds is not None:
        batch["embeds"] = embeds
    with mesh:
        state = jax.device_put(state, to_shardings(mesh, state_specs(cfg, state, ctx)))
        grad = jax.jit(jax.grad(lambda p, b: loss_fn(p, b, cfg, ctx)[0]))
        fn = jax.jit(make_train_step(cfg, ctx, AdamWConfig(**OPT)))
        for i in range(2):
            flat(grad(state["params"], batch), f"{{name}}/grad/{{i}}")
            state, met = fn(state, batch)
            for k in METRICS:
                out[f"{{name}}/met/{{i}}/{{k}}"] = np.asarray(met[k])
            if i == 0:
                # the parameters of the second gradient, for the port's ranks
                tmp = f"{{sys.argv[2]}}.{{name}}.tmp.npz"
                np.savez(tmp, **{{p: np.asarray(leaf) for p, leaf in paths(state["params"])}})
                os.replace(tmp, P1_FILE.format(out=sys.argv[2], name=name))
    flat(state, f"{{name}}/state")
np.savez(sys.argv[2], **out)
"""


def _wait_for(path: str, failed: str, timeout: float = 600.0) -> dict:
    """The arrays of ``path`` once the reference's subprocess has written
    it (it renames a finished file into place); raises at once with the
    reference's log tail if it exited with an error first (``failed``,
    :func:`_mark_failure`)."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if os.path.exists(failed):
            raise RuntimeError(f"the reference exited before writing {path}:\n"
                               + Path(failed).read_text())
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"the reference did not write {path} in {timeout} s")
        time.sleep(0.2)
    return dict(np.load(path))


def _mark_failure(proc: subprocess.Popen, out: Path) -> None:
    """Once ``proc`` exits with an error, writes ``{out}.failed`` with its
    log's tail, for the ranks that wait on its files."""
    if proc.wait() != 0:
        Path(f"{out}.failed").write_text(Path(f"{out}.log").read_text()[-4000:])


def _start_jax(inputs: Path, out: Path, shape) -> subprocess.Popen:
    consts = repr((shape, MODELS, TRAINED, SERVE, N_NEW, OPT, METRICS, P1_FILE))
    script = textwrap.dedent(JAX_SCRIPT.format(consts=consts))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    # its output goes to a file: the port's ranks wait on it mid-run, so a
    # full pipe nobody reads yet must not stall it
    with open(f"{out}.log", "w") as log:
        return subprocess.Popen([sys.executable, "-c", script, str(inputs), str(out)],
                                stdout=log, stderr=subprocess.STDOUT, env=env)


def _rank_main(rank, shape, init_file, inputs, out_dir):
    """One port rank: every model's serving and training cells on this
    rank's rows and shards, saved as ``rank<r>.npz``."""
    import torch.distributed as dist

    from repro_torch.bridge import params_from_numpy
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.runtime.optimizer import AdamWConfig, adamw_init
    from repro_torch.runtime.serve import ServeConfig, Server
    from repro_torch.runtime.train import grads_of, make_train_step

    torch.set_num_threads(1)
    data, model = shape
    timeout = datetime.timedelta(seconds=120)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=data * model, rank=rank, timeout=timeout)
    mesh = make_mesh(data, model, timeout=timeout)
    ctx = ParallelCtx(mesh=mesh)
    inp = dict(np.load(inputs))
    rows = sharding.batch_rows(SERVE["batch"], data, mesh.data_rank)
    out = {}

    def serve(cfg, ctx, params, name, key):
        """Prefill and ``N_NEW`` greedy steps of ``name``'s prompt (and
        embeds); the logits and tokens under ``key``; the cache."""
        embeds = torch.tensor(inp[f"{name}/embeds"]) if cfg.frontend_stub else None
        srv = Server(cfg, ctx, params, ServeConfig(**SERVE), device="cpu")
        logits, cache = srv.prefill(torch.tensor(inp[f"{name}/prompt"]).long(), embeds=embeds)
        out[f"{key}/logits/0"] = logits.numpy()
        toks = []
        tok = torch.argmax(logits[:, -1:], dim=-1)
        for i in range(N_NEW):
            toks.append(tok)
            logits, cache = srv.decode(tok, cache)
            out[f"{key}/logits/{i + 1}"] = logits.numpy()
            tok = torch.argmax(logits[:, -1:], dim=-1)
        out[f"{key}/tokens"] = torch.cat(toks, 1).numpy()
        return cache

    for name in MODELS:
        cfg = _cfg(name)
        np_params = _unflatten(inp, f"{name}/params/")
        if cfg.block_pattern == "zamba":
            np_params.setdefault("trailing", None)
        embeds = torch.tensor(inp[f"{name}/embeds"]) if cfg.frontend_stub else None
        cache = serve(cfg, ctx, params_from_numpy(np_params, device="cpu"), name, name)
        out.update({f"{name}/cache/{k}": v for k, v in _flatten(
            {k: v for k, v in cache.items() if k not in ("pos", "len")}).items()})
        if name not in TRAINED:
            continue
        params = sharding.rank_params(params_from_numpy(np_params, device="cpu"), cfg, ctx)
        batch = {k: torch.tensor(inp[f"{name}/{k}"][rows]) for k in ("tokens", "labels")}
        if embeds is not None:
            batch["embeds"] = embeds[rows]
        state = {"params": params, "opt": adamw_init(params)}
        step = make_train_step(cfg, ctx, AdamWConfig(**OPT))
        for i in range(2):
            at = state["params"]
            if i == 1:
                # the second gradient at the reference's parameters after
                # its first step, cut to the rank's slices
                ref = Path(inputs).parent / f"jax{_tag(shape)}.npz"
                ref_p1 = _unflatten(_wait_for(P1_FILE.format(out=ref, name=name),
                                              f"{ref}.failed"), "")
                if cfg.block_pattern == "zamba":
                    ref_p1.setdefault("trailing", None)
                at = sharding.rank_params(params_from_numpy(ref_p1, device="cpu"), cfg, ctx)
            g, _ = grads_of(at, batch, cfg, ctx)
            out.update({f"{name}/grad/{i}/{k}": v for k, v in _flatten(g).items()})
            state, met = step(state, batch)
            for k in METRICS:
                out[f"{name}/met/{i}/{k}"] = met[k].numpy()
        out.update({f"{name}/state/{k}": v for k, v in _flatten(state).items()})
    if shape == (1, 4):
        # 6 query heads do not divide the model axis: attention replicated
        for name in SIX:
            cfg = dataclasses.replace(_cfg(name), n_heads=6, n_kv_heads=2)
            out[f"six/{name}/layout"] = np.asarray(sorted(sharding.tp_layout(cfg, ctx)))
            for key, c in (("mesh", ctx), ("none", ParallelCtx())):
                serve(cfg, c, T.init_params(cfg, seed=1, device="cpu"), name,
                      f"six/{name}/{key}")
        # the train CLI: 2 steps of the smoke zamba on 1 x 4 (its 2 Mamba2
        # heads whole on every rank, the shared block split 4 ways), resumed
        # on 2 x 2 (split: the checkpoint's global Mamba2 leaves and shared
        # block cut to each rank's part) and, in the test, with no mesh for
        # 2 more, against 4 steps on 2 x 2 (its checkpoint gathered from the
        # parts)
        from repro_torch.launch import train as cli

        base = ["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu", "--batch",
                str(SERVE["batch"]), "--seq", str(SEQ), "--log-every", "100"]
        part, whole = Path(out_dir) / "ckpt_part", Path(out_dir) / "ckpt_whole"
        cli.main([*base, "--mesh", "1x4", "--steps", "2", "--ckpt-dir", str(part)])
        if rank == 0:
            shutil.copytree(part, Path(out_dir) / "ckpt_nomesh")
        dist.barrier()
        for tag, d in (("resumed", part), ("whole", whole)):
            state, hist = cli.main([*base, "--mesh", "2x2", "--steps", "4",
                                    "--ckpt-dir", str(d)])
            out.update({f"cli/{tag}/state/{k}": v for k, v in _flatten(state).items()})
            out[f"cli/{tag}/steps"] = np.asarray([r["step"] for r in hist])
            for k in METRICS:
                out[f"cli/{tag}/{k}"] = np.asarray([r[k] for r in hist])
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results (one subprocess a mesh shape, run beside
    the port's ranks), the port's, one spawn of four ranks a shape, and
    their directory."""
    base = tmp_path_factory.mktemp("mesh_families")
    inputs = base / "inputs.npz"
    _inputs(inputs)
    procs = {shape: _start_jax(inputs, base / f"jax{_tag(shape)}.npz", shape)
             for shape in SHAPES}
    for shape, proc in procs.items():
        threading.Thread(target=_mark_failure, args=(proc, base / f"jax{_tag(shape)}.npz"),
                         daemon=True).start()
    try:
        port = {}
        for shape in SHAPES:
            out_dir = base / _tag(shape)
            out_dir.mkdir()
            tmp.spawn(_rank_main, args=(shape, str(out_dir / "pg"), str(inputs),
                                        str(out_dir)), nprocs=4, join=True)
            port[shape] = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(4)]
        ref = {}
        for shape, proc in procs.items():
            out = base / f"jax{_tag(shape)}.npz"
            proc.wait(timeout=600)
            assert proc.returncode == 0, Path(f"{out}.log").read_text()[-4000:]
            ref[shape] = dict(np.load(out))
    finally:
        for proc in procs.values():
            proc.kill()
    return ref, port, base


def _ctx(shape, rank: int) -> ParallelCtx:
    return ParallelCtx(mesh=Mesh(*shape, rank, None, None))


def _cache_slice(key: str, want: np.ndarray, cfg, ctx) -> np.ndarray:
    """The reference's global cache leaf ``key`` cut to the rank's part:
    its batch rows and, by leaf, its Mamba2 heads and conv channels or its
    dense K/V shard (slots, KV heads)."""
    stack, leaf = key.split("/", 1)
    lead = {"units_ssm": 2, "trailing_ssm": 1, "shared_kv": 1, "layers": 1, "cross_kv": 1,
            "m": 2, "s": 1}[stack]
    rows = sharding.batch_rows(SERVE["batch"], ctx.n_batch, ctx.batch_rank)
    want = np.take(want, range(rows.start, rows.stop), axis=lead)
    if stack.endswith("_ssm"):
        _, head, n_heads, n = S.mamba_dims(cfg)
        hs = sharding.mamba_heads(n_heads, ctx.n_model, ctx.model_rank)
        if leaf == "ssm":
            return np.take(want, range(hs.start, hs.stop), axis=lead + 1)
        part = sharding.Part(slice(hs.start * head, hs.stop * head), 2 * n)
        return np.take(want, part.index(want.shape[-1]), axis=-1)
    if stack in ("shared_kv", "layers", "cross_kv"):
        length = cfg.frontend_tokens if stack == "cross_kv" else A.cache_len(
            cfg, SERVE["max_seq"])
        slots, heads = A.dense_shard(cfg, length, ctx)
        want = np.take(want, range(slots.start, slots.stop), axis=lead + 1)
        return np.take(want, range(heads.start, heads.stop), axis=lead + 2)
    return want


@pytest.mark.parametrize("name", tuple(MODELS))
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_serving_matches_reference(runs, shape, name):
    """Greedy tokens equal; prefill and decode logits within 1e-5 on
    every rank (every request's, gathered over the data group)."""
    ref, port, _ = runs
    for rank in range(4):
        got = port[shape][rank]
        np.testing.assert_array_equal(got[f"{name}/tokens"], ref[shape][f"{name}/tokens"],
                                      err_msg=f"rank {rank}")
        for i in range(N_NEW + 1):
            np.testing.assert_allclose(got[f"{name}/logits/{i}"],
                                       ref[shape][f"{name}/logits/{i}"],
                                       err_msg=f"rank {rank} step {i}", **TOL)


@pytest.mark.parametrize("name", tuple(MODELS))
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_cache_shards_match_reference(runs, shape, name):
    """Each rank's shard of every cache leaf after prefill and the decode
    steps against the reference's global cache at the rank's slice."""
    ref, port, _ = runs
    cfg = _cfg(name)
    prefix = f"{name}/cache/"
    keys = sorted(k[len(prefix):] for k in ref[shape] if k.startswith(prefix))
    assert keys
    for rank in range(4):
        ctx = _ctx(shape, rank)
        for key in keys:
            want = _cache_slice(key, ref[shape][prefix + key], cfg, ctx)
            np.testing.assert_allclose(port[shape][rank][prefix + key], want,
                                       err_msg=f"rank {rank} {key}", **TOL)


def _rank_part(path: str, want: np.ndarray, layout: dict) -> np.ndarray:
    spec = layout.get(path)
    if spec is None:
        return want
    return sharding.take(torch.from_numpy(want), *spec).numpy()


@pytest.mark.parametrize("name", TRAINED)
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_train_steps_match_reference(runs, shape, name):
    """Two steps. Before each, the gradients (each rank's slices) within
    1e-5 of the reference's ``jax.grad`` of its ``loss_fn`` on the same
    mesh, at the same parameters: the initial ones, then the reference's
    after its first step (cut to the rank's slices); the metrics within
    1e-5; then each rank's slices of the parameters and moments (``nu``
    through its square root) within 1e-5, the step equal.

    Why the second gradient is taken at the reference's parameters: after
    one step the two trajectories' parameters differ where Adam turned a
    gradient's last-bit rounding into part of a step (below), and the
    second gradients inherit that: the reference's own 1 x 4 and 2 x 2
    runs of seamless part by 8.4e-6 at step 1, and the port's 1 x 4 tensor
    parallelism (its sums in gloo's order) by 1.4e-5 against the
    reference's, where both agree within 4e-8 at step 0.

    Which elements loosen, as in ``test_torch_train.py``: Adam moves an
    element by ``lr * m / (sqrt(v) + eps)``, near +-1 whatever the
    gradient's size, so a gradient the packages round apart by a large
    share of its value (a near-zero one) can move its parameter by a
    different part of ``lr``. The parameters whose gradients part by more
    than ``APART`` of their value at either step (1.1% of seamless's on
    1 x 4, the most; the test requires fewer than 2%) are held at ``2 *
    sum(lr)``, the most two steps can part."""
    ref, port, _ = runs
    cfg = _cfg(name)
    prefix = f"{name}/state/"
    moved = 2 * (OPT["lr"] / OPT["warmup_steps"] + OPT["lr"])
    n_loose = n_all = 0
    for rank in range(4):
        got = port[shape][rank]
        layout = sharding.param_layout(cfg, _ctx(shape, rank))
        loose = {}
        for i in range(2):
            for k in METRICS:
                np.testing.assert_allclose(got[f"{name}/met/{i}/{k}"],
                                           ref[shape][f"{name}/met/{i}/{k}"],
                                           err_msg=f"rank {rank} step {i} {k}", **TOL)
            gp = f"{name}/grad/{i}/"
            grads = [k[len(gp):] for k in ref[shape] if k.startswith(gp)]
            assert grads
            for path in grads:
                want = _rank_part(path, ref[shape][gp + path], layout)
                have = got[gp + path]
                np.testing.assert_allclose(have, want, err_msg=f"rank {rank} step {i} {path}",
                                           **TOL)
                apart = np.abs(have - want) > APART * np.abs(want)
                loose[path] = loose.get(path, False) | apart
        n = 0
        for key, want in ref[shape].items():
            if not key.startswith(prefix):
                continue
            path = key[len(prefix):]
            have = got[key]
            if path == "opt/step":
                np.testing.assert_array_equal(have, want)
                continue
            leaf = path.split("/", 2)[-1] if path.startswith("opt/") else \
                path.split("/", 1)[-1]
            want = _rank_part(leaf, want, layout)
            if path.startswith("opt/nu/"):
                have, want = np.sqrt(have), np.sqrt(want)
            if path.startswith("params/"):
                mask = loose[leaf]
                n_loose += int(mask.sum())
                n_all += mask.size
                np.testing.assert_allclose(have[mask], want[mask], rtol=0, atol=moved,
                                           err_msg=f"rank {rank} {path} (loose)")
                have, want = have[~mask], want[~mask]
            np.testing.assert_allclose(have, want, err_msg=f"rank {rank} {path}", **TOL)
            n += 1
        assert n > 20
    assert n_loose < n_all // 50


@pytest.mark.parametrize("name", TRAINED)
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_replicated_gradients_bitwise_equal_in_model_group(runs, shape, name):
    """The first step's gradient of every leaf replicated over the model
    group, and the B/C columns of the mixed Mamba2 leaves, bit for bit on
    every rank of the group."""
    _, port, _ = runs
    cfg = _cfg(name)
    data, model = shape
    prefix = f"{name}/grad/0/"
    for g in range(data):
        group = list(range(g * model, (g + 1) * model))
        layout = sharding.param_layout(cfg, _ctx(shape, group[0]))
        keys = [k for k in port[shape][group[0]] if k.startswith(prefix)]
        assert keys
        for key in keys:
            spec = layout.get(key[len(prefix):])
            first = port[shape][group[0]][key]
            for rank in group[1:]:
                have = port[shape][rank][key]
                if spec is None:
                    np.testing.assert_array_equal(have, first, err_msg=key)
                elif isinstance(spec[1], sharding.Part):
                    every = [sharding.split_entries(torch.from_numpy(a), *spec)[1].numpy()
                             for a in (have, first)]
                    np.testing.assert_array_equal(*every, err_msg=key)


def test_checkpoint_resumes_on_another_mesh(runs):
    """The train CLI's checkpoint of the smoke zamba after 2 steps on
    1 x 4 (the shared block split 4 ways), restored on 2 x 2 (each rank's
    Mamba2 parts and shared-block slices cut from the global leaves) and
    with no mesh for 2 more steps, against 4 uninterrupted steps on 2 x 2:
    the logged metrics of steps 2 and 3 within 1e-5 on the mesh and 2e-5
    with none, and each rank's final slices within 2e-5 (the tolerance of
    ``test_torch_mesh_train.py``'s same check)."""
    from repro_torch.launch import train as cli

    _, port, base = runs
    cfg = _cfg("zamba")
    for shape in ((1, 4), (2, 2)):
        layout = sharding.tp_layout(cfg, _ctx(shape, 0))
        assert layout["shared/attn/wq"][1] == slice(0, cfg.n_heads * cfg.head_dim_ // shape[1])
    for rank in range(4):
        r = port[(1, 4)][rank]
        assert list(r["cli/resumed/steps"]) == [2, 3]
        assert list(r["cli/whole/steps"]) == [0, 1, 2, 3]
        for k in METRICS:
            np.testing.assert_allclose(r[f"cli/resumed/{k}"], r[f"cli/whole/{k}"][2:],
                                       err_msg=k, **TOL)
        keys = [k for k in r if k.startswith("cli/resumed/state/")]
        assert any("mamba/w_xbc" in k for k in keys) and len(keys) > 20
        assert r["cli/resumed/state/params/shared/attn/wq"].shape == (
            cfg.d_model, cfg.n_heads * cfg.head_dim_ // 2)
        for k in keys:
            np.testing.assert_allclose(r[k], r[k.replace("/resumed/", "/whole/")],
                                       err_msg=k, rtol=2e-5, atol=2e-5)
    _, hist = cli.main(["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu", "--batch",
                        str(SERVE["batch"]), "--seq", str(SEQ), "--log-every", "100",
                        "--steps", "4", "--ckpt-dir", str(base / "1x4" / "ckpt_nomesh")])
    assert [h["step"] for h in hist] == [2, 3]
    for k in METRICS:
        np.testing.assert_allclose([h[k] for h in hist], port[(1, 4)][0][f"cli/whole/{k}"][2:],
                                   err_msg=k, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# tensor parallelism of the shared block and the encoder-decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", tuple(MODELS))
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_tp_slices_are_reference_shards(runs, shape, name):
    """Each tensor-parallel leaf a rank holds (``tp_layout``: zamba's 9,
    the encoder-decoder's 20, xLSTM's none) is the reference's
    ``param_spec`` shard of its device, the same range of the same dim,
    and every other leaf the reference splits is a Mamba2 leaf (the
    port's head-aligned layout, ``mamba_layout``)."""
    ref, _, _ = runs
    cfg = _cfg(name)
    prefix = f"{name}/shards/"
    paths = [k[len(prefix):] for k in ref[shape] if k.startswith(prefix)]
    assert len(paths) > 10
    n_split = {"zamba": 9, "encdec": 20, "xlstm": 0}[cfg.block_pattern]
    for rank in range(4):
        layout = sharding.tp_layout(cfg, _ctx(shape, rank))
        assert len(layout) == n_split
        assert set(layout) <= set(paths)
        for path in paths:
            ranges = ref[shape][prefix + path]
            split = [i for i in range(ranges.shape[1])
                     if any((ranges[q][i] != ranges[rank][i]).any() for q in range(4))]
            if path not in layout:
                assert not split or "/mamba/" in path, path
                continue
            dim, part = layout[path]
            assert split == [dim], path
            assert not isinstance(part, sharding.Copy)
            assert tuple(ranges[rank][dim]) == (part.start, part.stop), path


@pytest.mark.parametrize("name", SIX)
def test_tp_falls_back_where_heads_do_not_divide(runs, name):
    """6 query heads (2 KV heads) on 1 x 4: no attention leaf splits (the
    MLPs and the vocab do), and every rank's tokens and logits are the
    no-mesh run's."""
    _, port, _ = runs
    want = {"zamba": ["embed", "lm_head", "shared/mlp/w_down", "shared/mlp/w_gate",
                      "shared/mlp/w_up"],
            "seamless": ["embed", *(f"{s}/mlp/{w}" for s in ("encoder", "layers")
                                    for w in ("w_down", "w_gate", "w_up")), "lm_head"]}[name]
    for rank in range(4):
        got = port[(1, 4)][rank]
        assert list(got[f"six/{name}/layout"]) == want
        np.testing.assert_array_equal(got[f"six/{name}/mesh/tokens"],
                                      got[f"six/{name}/none/tokens"])
        for i in range(N_NEW + 1):
            np.testing.assert_allclose(got[f"six/{name}/mesh/logits/{i}"],
                                       got[f"six/{name}/none/logits/{i}"],
                                       err_msg=f"rank {rank} step {i}", **TOL)


# ---------------------------------------------------------------------------
# the layout functions, one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_model", (1, 2, 4, 16))
def test_mamba_heads_split_or_replicate(n_model):
    """zamba2-1.2b's 64 heads split ``64 / n_model`` a rank (4 a rank on
    16); the smoke model's 2 heads split over 2 and stay whole on 4; a
    model axis of 1 keeps every head."""
    for d_model, n_heads in ((2048, 64), (64, 2), (128, 4)):
        head, nh = sharding.mamba_head_dims(d_model)
        assert (head, nh) == (64, n_heads)
        blocks = [sharding.mamba_heads(nh, n_model, r) for r in range(n_model)]
        if n_model > 1 and nh % n_model == 0:
            assert [(b.start, b.stop) for b in blocks] == [
                (r * nh // n_model, (r + 1) * nh // n_model) for r in range(n_model)]
            assert sharding.mamba_channels(head, nh, n_model, 1) == slice(
                nh // n_model * head, 2 * nh // n_model * head)
        else:
            assert all(b == slice(0, nh) for b in blocks)
    assert sharding.mamba_head_dims(16) == (32, 1)         # d_inner 32: one head


@pytest.mark.parametrize("shape", SHAPES + ((1, 1), (1, 2)), ids=_tag)
def test_mamba_layout_and_rank_params(shape):
    """``mamba_layout`` names the six split leaves of both stacks; each
    rank's part of ``w_xbc`` is its heads' x columns, then the 2N B/C
    columns; the parts of the x columns tile the whole and every rank's
    B/C columns are the same; the state shapes follow the heads."""
    cfg = _cfg("zamba128")
    _, head, n_heads, n = S.mamba_dims(cfg)
    params = T.init_params(cfg, seed=1, device="cpu")
    d_inner = 2 * cfg.d_model
    xs = []
    for rank in range(shape[0] * shape[1]):
        ctx = _ctx(shape, rank)
        layout = sharding.mamba_layout(cfg, ctx)
        split = sharding.is_split(n_heads, shape[1])
        assert bool(layout) == split
        if not split:
            continue
        assert sorted(layout) == sorted(f"{s}/mamba/{w}" for s in ("units", "trailing")
                                        for w in ("w_z", "norm_w", "w_out", "w_xbc",
                                                  "conv_w", "conv_b"))
        assert layout["units/mamba/w_xbc"][0] == 3 and layout["trailing/mamba/w_out"][0] == 1
        mine = sharding.rank_params(params, cfg, ctx)
        w = params["units"]["mamba"]["w_xbc"]
        got = mine["units"]["mamba"]["w_xbc"]
        cs = sharding.mamba_channels(head, n_heads, shape[1], ctx.model_rank)
        assert torch.equal(got[..., : cs.stop - cs.start], w[..., cs])
        assert torch.equal(got[..., cs.stop - cs.start:], w[..., d_inner:])
        assert mine["units"]["mamba"]["w_dt"] is params["units"]["mamba"]["w_dt"]
        xs.append(got[..., : cs.stop - cs.start])
        st = S.mamba_state_init(cfg, 2, ctx=ctx)
        assert st["ssm"].shape == (2, n_heads // shape[1], head, n)
        assert st["conv"].shape == (2, S.CONV_W - 1, (cs.stop - cs.start) + 2 * n)
    if xs:
        whole = params["units"]["mamba"]["w_xbc"][..., :d_inner]
        assert torch.equal(torch.cat(xs[: shape[1]], dim=-1), whole)


@pytest.mark.parametrize("frontend,n_kv,n_model,want", (
    (8, 4, 4, ("seq", 2)), (6, 4, 4, ("heads", 1)), (6, 2, 4, ("whole", None)),
    (6, 4, 2, ("seq", 3)), (1024, 16, 16, ("seq", 64))))
def test_cross_kv_shard(frontend, n_kv, n_model, want):
    """``cross_kv`` takes the dense KV layout over the frontend length:
    its sequence when it divides the model axis, else its KV heads when
    they divide, else whole; ``init_cache`` shapes it so."""
    cfg = dataclasses.replace(_cfg("seamless"), frontend_tokens=frontend, n_kv_heads=n_kv)
    for rank in range(n_model):
        ctx = _ctx((1, n_model), rank)
        slots, heads = A.cross_shard(cfg, ctx)
        kind, size = want
        if kind == "seq":
            assert (slots, heads) == (slice(rank * size, (rank + 1) * size), slice(0, n_kv))
        elif kind == "heads":
            assert (slots, heads) == (slice(0, frontend), slice(rank, rank + 1))
        else:
            assert (slots, heads) == (slice(0, frontend), slice(0, n_kv))
    if frontend < 100:
        import torch.distributed as dist

        assert not dist.is_initialized()
        shape = T.init_cache(cfg, 2, 16, device="cpu", ctx=ctx)["cross_kv"][0].shape
        assert shape == (cfg.n_layers, 2, slots.stop - slots.start,
                         heads.stop - heads.start, cfg.head_dim_)


@pytest.mark.parametrize("name", ("zamba", "seamless", "xlstm"))
@pytest.mark.parametrize("shape", ((1, 1), (1, 2), (2, 2), (1, 4)), ids=_tag)
def test_tp_layout_of_the_families(shape, name):
    """``tp_layout`` of zamba (the unstacked shared block) and the
    encoder-decoder (stacked encoder and decoder layers), at 4 and at 2 KV
    heads: empty on a model axis of 1 and for xLSTM; else the attention,
    the MLPs, ``embed`` and ``lm_head``, each at its dim. The ranks'
    slices (``rank_params``) rebuild every leaf, a copied KV head (2 KV
    heads on 1 x 4) taken once; ``param_layout`` adds zamba's Mamba2
    leaves where their 2 heads split."""
    data, model = shape
    for n_kv in (4, 2):
        cfg = dataclasses.replace(_cfg(name), n_kv_heads=n_kv)
        full = _flatten(T.init_params(cfg, seed=2, device="cpu"))
        attns, mlps, lead = {"zamba": (("shared/attn",), ("shared/mlp",), 0),
                             "seamless": (("encoder/attn", "layers/attn", "layers/xattn"),
                                          ("encoder/mlp", "layers/mlp"), 1),
                             "xlstm": ((), (), 0)}[name]
        want = {"embed": 0, "lm_head": 1} if attns and model > 1 else {}
        for a in attns:
            want.update({f"{a}/wq": lead + 1, f"{a}/wk": lead + 1, f"{a}/wv": lead + 1,
                         f"{a}/wo": lead} if model > 1 else {})
        for f in mlps:
            want.update({f"{f}/w_gate": lead + 1, f"{f}/w_up": lead + 1,
                         f"{f}/w_down": lead} if model > 1 else {})
        parts = {}
        for rank in range(data * model):
            ctx = _ctx(shape, rank)
            layout = sharding.tp_layout(cfg, ctx)
            assert {p: dim for p, (dim, _) in layout.items()} == want
            mamba = sharding.mamba_layout(cfg, ctx)
            assert sharding.param_layout(cfg, ctx) == {**mamba, **layout}
            assert bool(mamba) == (name == "zamba" and model == 2)
            copy = n_kv == 2 and model == 4
            for path, (dim, part) in layout.items():
                assert isinstance(part, sharding.Copy) == (copy and path[-2:] in ("wk", "wv"))
                if isinstance(part, sharding.Copy):
                    assert part.copies == 2 and part.lead == (ctx.model_rank % 2 == 0)
            mine = _flatten(sharding.rank_params(
                params=T.init_params(cfg, seed=2, device="cpu"), cfg=cfg, ctx=ctx))
            if ctx.batch_rank == 0:
                for path in layout:
                    parts.setdefault(path, []).append(torch.from_numpy(mine[path]))
        for path, (dim, part) in sharding.tp_layout(cfg, _ctx(shape, 0)).items():
            got = sharding.whole(parts[path][0], dim, part,
                                 lambda own, d, p=path: torch.cat(parts[p], d))
            np.testing.assert_array_equal(got.numpy(), full[path], err_msg=path)
