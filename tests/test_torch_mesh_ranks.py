"""The port under a ``("data", "model")`` mesh of four gloo processes on the
CPU, against the JAX package on the same mesh shapes (2 x 2 and 1 x 4,
four forced host devices in one subprocess, so this process keeps its
single device), on the same numpy inputs, fp32:

* ``ep_moe_shardmap`` prefill and decode, fused branch (kernels' plain
  versions, ``ep_chunks`` 1 and 2) and padded branch, against the
  reference's kernel and einsum branches: outputs within 1e-5, the fused
  branch's integer dispatch metadata exact, ``ep_chunks=2`` bit-identical
  to 1;
* ``seq_parallel_decode_attend``, partials body and einsum body, with
  slices that hold no valid key, within 2e-5 (the reference's own bound);
* ``Server.generate`` with the NI-Balancer live: greedy tokens and the
  migration count equal to the reference's, migrations > 0, tokens equal
  to a run with the balancer off; the ESP and the paged Servers under the
  mesh give the same tokens;
* what each rank holds (``parallel.sharding``) against the reference's
  ``param_spec`` / ``cache_specs`` / ``batch_spec_for`` shards.

The four port processes start with ``torch.multiprocessing`` (spawn) and
meet through a file in the test's temporary directory.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from repro.parallel.collectives import choose_slots as j_choose_slots
from repro.parallel.collectives import dispatch_metadata as j_dispatch_metadata
from repro_torch.parallel import sharding
from repro_torch.parallel.collectives import bucket_capacity

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((2, 2), (1, 4))
TOL = dict(rtol=1e-5, atol=1e-5)
MERGE_ATOL = 2e-5
# EP dispatch cells: 8 experts over the model axis, top-2, skewed routing
# (3/4 of the copies to expert 0) at capacity factor 1.0, so buckets drop
E, D, F, K, CF = 8, 8, 16, 2, 1.0
EP_CASES = {"prefill": ((4, 8), False), "decode": ((8, 1), True)}
# sequence-parallel decode: 16 cache slots; the second mask leaves the
# slices of all but the first model rank without a valid key
SP_MASKS = {"prefix10": 10, "prefix3": 3}
SERVE = dict(max_seq=32, batch=4, slots_per_device=3)
N_NEW = 8


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


def _inputs(path):
    rng = np.random.default_rng(0)
    arr = {
        "ep_w_gate": rng.standard_normal((E, D, F)) * 0.1,
        "ep_w_up": rng.standard_normal((E, D, F)) * 0.1,
        "ep_w_down": rng.standard_normal((E, F, D)) * 0.1,
        "sp_q": rng.standard_normal((4, 1, 8, 16)),
        "sp_k": rng.standard_normal((4, 16, 4, 16)),
        "sp_v": rng.standard_normal((4, 16, 4, 16)),
    }
    for case, ((b, s), _) in EP_CASES.items():
        arr[f"ep_{case}_x"] = rng.standard_normal((b, s, D)) * 0.5
        hot = rng.random((b, s, K)) < 0.75
        arr[f"ep_{case}_ids"] = np.where(hot, 0, rng.integers(0, E, (b, s, K)))
        w = rng.random((b, s, K)) + 0.1
        arr[f"ep_{case}_w"] = w / w.sum(-1, keepdims=True)
    arr = {k: (v.astype(np.float32) if v.dtype == np.float64 else v.astype(np.int32))
           for k, v in arr.items()}
    arr["prompt"] = rng.integers(0, 256, (SERVE["batch"], 8)).astype(np.int32)
    np.savez(path, **arr)
    return arr


JAX_SCRIPT = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, smoke
from repro.launch.mesh import make_mesh_compat
from repro.models import transformer as T
from repro.parallel.collectives import (
    ep_moe_shardmap, seq_parallel_decode_attend, uniform_placement)
from repro.parallel.ctx import ParallelCtx
from repro.parallel.sharding import batch_spec_for, cache_specs, param_spec
from repro.runtime.serve import ServeConfig, Server

SHAPES, E, CF, EP_CASES, SP_MASKS, SERVE, N_NEW = {consts}
inp = dict(np.load(sys.argv[1]))
out = {{}}
cfg = smoke(get_config("dbrx-132b"))
params = T.init_params(jax.random.PRNGKey(0), cfg)
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["params/" + "/".join(p.key for p in path)] = np.asarray(leaf)
sw = {{n: jnp.asarray(inp["ep_" + n]) for n in ("w_gate", "w_up", "w_down")}}
slot_of, n_rep = uniform_placement(E, E)
for shape in SHAPES:
    tag = f"{{shape[0]}}x{{shape[1]}}"
    mesh = make_mesh_compat(shape, ("data", "model"))
    ep = shape[1]
    for case, (_, decode) in EP_CASES.items():
        x, ids, w = (jnp.asarray(inp[f"ep_{{case}}_{{n}}"]) for n in ("x", "ids", "w"))
        for uk in (True, False):
            for kc in (1, 2):
                ctx = ParallelCtx(mesh=mesh, use_kernels=uk, ep_chunks=kc)
                with mesh:
                    o = jax.jit(lambda x_, i_, w_: ep_moe_shardmap(
                        x_, i_, w_, sw, slot_of, n_rep, ctx, CF, E // ep,
                        decode=decode))(x, ids, w)
                out[f"{{tag}}/ep/{{case}}/{{uk}}/{{kc}}"] = np.asarray(o)
    q, k, v = (jnp.asarray(inp["sp_" + n]) for n in "qkv")
    for name, n_valid in SP_MASKS.items():
        mask = jnp.arange(k.shape[1]) < n_valid
        for uk in (True, False):
            ctx = ParallelCtx(mesh=mesh, use_kernels=uk)
            with mesh:
                o = jax.jit(lambda q_, k_, v_, m_: seq_parallel_decode_attend(
                    q_, k_, v_, m_, ctx))(q, k, v, mask)
            out[f"{{tag}}/sp/{{name}}/{{uk}}"] = np.asarray(o)
    ctx = ParallelCtx(mesh=mesh)
    L = cfg.n_layers
    n_slots = ep * SERVE["slots_per_device"]
    cache_len, batch = SERVE["max_seq"], SERVE["batch"]
    kv = jax.ShapeDtypeStruct((L, batch, cache_len, cfg.n_kv_heads, cfg.head_dim_), jnp.float32)
    specs = {{
        "slot": ((L, n_slots, cfg.d_model, cfg.moe_d_ff_),
                 param_spec("layers/moe/w_gate", (L, n_slots, cfg.d_model, cfg.moe_d_ff_),
                            cfg, ep)),
        "cache": (kv.shape, cache_specs(cfg, {{"layers": {{"k": kv, "v": kv}}}}, ctx,
                                        batch)["layers"]["k"]),
        "batch": ((batch,), P(batch_spec_for(batch, ctx))),
    }}
    for name, (shp, spec) in specs.items():
        idx = NamedSharding(mesh, spec).devices_indices_map(shp)
        out[f"{{tag}}/shard/{{name}}"] = np.array([
            [[s.start or 0, shp[i] if s.stop is None else s.stop]
             for i, s in enumerate(idx[mesh.devices[dr, mr]])]
            for dr in range(shape[0]) for mr in range(shape[1])])
    prompt = jnp.asarray(inp["prompt"])
    for alpha in (0.1, 1e9):
        with mesh:
            srv = Server(cfg, ParallelCtx(mesh=mesh, capacity_factor=8.0),
                         jax.tree.map(jnp.copy, params),
                         ServeConfig(alpha=alpha, **SERVE))
            toks = srv.generate(prompt, N_NEW)
        out[f"{{tag}}/server/{{alpha}}/tokens"] = np.asarray(toks)
        out[f"{{tag}}/server/{{alpha}}/migrations"] = np.asarray(srv.migrations)
np.savez(sys.argv[2], **out)
"""


def _run_jax(inputs: Path, out: Path) -> dict:
    consts = repr((SHAPES, E, CF, {k: (list(v[0]), v[1]) for k, v in EP_CASES.items()},
                   SP_MASKS, SERVE, N_NEW))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT.format(consts=consts)),
         str(inputs), str(out)],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(out))


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


def _rank_main(rank, shape, init_file, inputs, jax_out, out_dir):
    """One port rank: every cell of the file on this rank's blocks, saved
    as ``rank<r>.npz``."""
    import torch.distributed as dist

    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config, smoke
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.runtime.serve import ServeConfig, Server

    torch.set_num_threads(1)
    data, model = shape
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=data * model, rank=rank)
    mesh = make_mesh(data, model)
    inp = dict(np.load(inputs))
    out = {}
    ep = model
    spd = E // ep
    mine = sharding.slot_rows(E, ep, mesh.model_rank)
    sw = {n: torch.tensor(inp["ep_" + n][mine]) for n in ("w_gate", "w_up", "w_down")}
    slot_of, n_rep = C.uniform_placement(E, E)

    seen = []
    fused = C.dispatch_fused

    def spy(xt, slots, *args):
        res = fused(xt, slots, *args)
        seen.append([slots] + [t for t in res[1:]])
        return res

    C.dispatch_fused = spy
    for case, ((b, _), decode) in EP_CASES.items():
        rows = sharding.batch_rows(b, data, mesh.data_rank)
        x, ids, w = (torch.tensor(inp[f"ep_{case}_{n}"][rows]) for n in ("x", "ids", "w"))
        for uk in ("auto", False):
            for kc in (1, 2):
                seen.clear()
                ctx = ParallelCtx(mesh=mesh, use_kernels=uk, ep_chunks=kc)
                o = C.ep_moe_shardmap(x, ids, w, sw, slot_of, n_rep, ctx, CF, spd, decode)
                out[f"ep/{case}/{uk}/{kc}"] = o.numpy()
                if uk == "auto":
                    for name, t in zip(("slots", "kept_ck", "keep", "chunk_of", "dest",
                                        "posr"), seen[0]):
                        out[f"meta/{case}/{kc}/{name}"] = t.numpy()
    C.dispatch_fused = fused

    q = torch.tensor(inp["sp_q"])
    t_loc = sharding.cache_slots(inp["sp_k"].shape[1], model, mesh.model_rank)
    brows = sharding.batch_rows(q.shape[0], data, mesh.data_rank)
    k, v = (torch.tensor(inp["sp_" + n][brows, t_loc]) for n in "kv")
    for name, n_valid in SP_MASKS.items():
        mask = torch.arange(t_loc.start, t_loc.stop) < n_valid
        for uk in ("auto", False):
            ctx = ParallelCtx(mesh=mesh, use_kernels=uk)
            out[f"sp/{name}/{uk}"] = C.seq_parallel_decode_attend(
                q[brows], k, v, mask, ctx).numpy()

    cfg = smoke(get_config("dbrx-132b"))
    jparams = _unflatten(dict(np.load(jax_out)), "params/")
    prompt = torch.tensor(inp["prompt"]).long()
    send = dist.send
    sent = []
    dist.send = lambda t, *a, **kw: (sent.append(t.numel()), send(t, *a, **kw))
    for uk in ("auto", False):
        for alpha in (0.1, 1e9):
            sent.clear()
            srv = Server(cfg, ParallelCtx(mesh=mesh, capacity_factor=8.0, use_kernels=uk),
                         params_from_numpy(jparams), ServeConfig(alpha=alpha, **SERVE),
                         device="cpu")
            out[f"server/{uk}/{alpha}/tokens"] = srv.generate(prompt, N_NEW).numpy()
            out[f"server/{uk}/{alpha}/migrations"] = np.asarray(srv.migrations)
            out[f"server/{uk}/{alpha}/slices_sent"] = np.asarray(len(sent))
    dist.send = send
    for name, ctx, scfg in (
        ("esp", ParallelCtx(mesh=mesh, moe_impl="esp", capacity_factor=8.0),
         ServeConfig(**SERVE)),
        ("paged", ParallelCtx(mesh=mesh, capacity_factor=8.0),
         ServeConfig(paged=True, page_size=8, alpha=0.1, **SERVE)),
    ):
        srv = Server(cfg, ctx, params_from_numpy(jparams), scfg, device="cpu")
        out[f"served/{name}/tokens"] = srv.generate(prompt, N_NEW).numpy()
        out[f"served/{name}/migrations"] = np.asarray(srv.migrations)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results for both mesh shapes (one subprocess) and
    the port's, one spawn of four ranks per shape."""
    base = tmp_path_factory.mktemp("mesh_ranks")
    inputs = base / "inputs.npz"
    inp = _inputs(inputs)
    jax_out = base / "jax.npz"
    ref = _run_jax(inputs, jax_out)
    port = {}
    for shape in SHAPES:
        out_dir = base / _tag(shape)
        out_dir.mkdir()
        tmp.spawn(_rank_main, args=(shape, str(out_dir / "pg"), str(inputs), str(jax_out),
                                    str(out_dir)),
                  nprocs=shape[0] * shape[1], join=True)
        port[shape] = [dict(np.load(out_dir / f"rank{r}.npz"))
                       for r in range(shape[0] * shape[1])]
    return inp, ref, port


def _coords(shape):
    return [(r, r // shape[1], r % shape[1]) for r in range(shape[0] * shape[1])]


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
@pytest.mark.parametrize("case", tuple(EP_CASES))
def test_ep_moe_shardmap_matches_reference(runs, shape, case):
    """Fused branch (``auto``: the kernels' plain versions here) against the
    reference's kernel branch, padded branch against its einsum branch;
    ``ep_chunks=2`` bit-identical to 1 in both."""
    _, ref, port = runs
    (b, _), _ = EP_CASES[case]
    for rank, dr, _ in _coords(shape):
        rows = sharding.batch_rows(b, shape[0], dr)
        for uk, juk in (("auto", True), ("False", False)):
            want = ref[f"{_tag(shape)}/ep/{case}/{juk}/1"][rows]
            one = port[shape][rank][f"ep/{case}/{uk}/1"]
            np.testing.assert_allclose(one, want, **TOL)
            np.testing.assert_array_equal(port[shape][rank][f"ep/{case}/{uk}/2"], one)


def _jax_dispatch_meta(inp, case, shape, dr, mr, kc):
    """The reference's fused-dispatch metadata for one rank, from its own
    ``choose_slots`` and ``dispatch_metadata`` and the index math of its
    ``dispatch_fused`` closure."""
    (b, s), decode = EP_CASES[case]
    data, ep = shape
    rows = sharding.batch_rows(b, data, dr)
    ids = inp[f"ep_{case}_ids"][rows]
    if not decode:
        ids = ids[:, mr * (s // ep) : (mr + 1) * (s // ep)]
    n = ids.shape[0] * ids.shape[1]
    total = E
    spd, spc = E // ep, E // ep // kc
    cap = bucket_capacity(n, K, CF, total)
    slot_of = jnp.arange(E, dtype=jnp.int32)[:, None] * jnp.ones((1, 4), jnp.int32)
    slots = j_choose_slots(jnp.asarray(ids.reshape(n, K)), slot_of,
                           jnp.ones(E, jnp.int32), sentinel=total + 1)
    if decode:
        owned = (jnp.arange(n) % ep) == mr
        slots = jnp.where(owned[:, None], slots, total + 1)
    _, _, kept, pos, keep = j_dispatch_metadata(slots, total, cap)
    kept_ck = kept.reshape(ep, kc, spc)
    wro = jnp.cumsum(kept_ck, axis=2) - kept_ck
    flat_b = slots.reshape(-1)
    safe_b = jnp.minimum(flat_b, total - 1)
    posr = wro.reshape(-1)[safe_b] + pos.reshape(-1)
    return {
        "slots": slots, "kept_ck": kept_ck, "keep": keep,
        "chunk_of": (safe_b % spd) // spc, "dest": flat_b // spd,
        "posr": jnp.where(keep.reshape(-1), posr, spc * cap),
    }


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_ep_dispatch_metadata_exact(runs, shape):
    """Slots, bucket fills, keep masks, owning chunks, destination ranks
    and rows: equal to the reference's on every rank, prefill and decode,
    one and two chunks; the skewed cells do drop copies."""
    inp, _, port = runs
    dropped = 0
    for case in EP_CASES:
        for kc in (1, 2):
            for rank, dr, mr in _coords(shape):
                want = _jax_dispatch_meta(inp, case, shape, dr, mr, kc)
                for name, val in want.items():
                    np.testing.assert_array_equal(
                        port[shape][rank][f"meta/{case}/{kc}/{name}"], np.asarray(val),
                        err_msg=f"{case} kc={kc} rank={rank} {name}")
                slots = np.asarray(want["slots"])
                dropped += int(((slots < E) & ~np.asarray(want["keep"])).sum())
    assert dropped > 0


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
@pytest.mark.parametrize("mask", tuple(SP_MASKS))
def test_seq_parallel_decode_matches_reference(runs, shape, mask):
    """Partials body (``flash_decode``'s partials mode, plain here) and
    einsum body against the reference's kernel and einsum bodies."""
    _, ref, port = runs
    for rank, dr, _ in _coords(shape):
        rows = sharding.batch_rows(4, shape[0], dr)
        for uk, juk in (("auto", True), ("False", False)):
            np.testing.assert_allclose(
                port[shape][rank][f"sp/{mask}/{uk}"],
                ref[f"{_tag(shape)}/sp/{mask}/{juk}"][rows], rtol=0, atol=MERGE_ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_server_generate_with_migrations_matches_reference(runs, shape):
    """Every rank returns every request's greedy tokens, equal to the
    reference Server's on the same mesh shape, kernels' plain versions and
    plain path alike; the same migration count, above 0, with weight
    slices sent from rank to rank; the same tokens with the balancer
    off."""
    _, ref, port = runs
    tag = _tag(shape)
    want = ref[f"{tag}/server/0.1/tokens"]
    migs = int(ref[f"{tag}/server/0.1/migrations"])
    assert migs > 0
    np.testing.assert_array_equal(ref[f"{tag}/server/1000000000.0/tokens"], want)
    for uk in ("auto", "False"):
        assert sum(int(r[f"server/{uk}/0.1/slices_sent"]) for r in port[shape]) > 0
        for r in port[shape]:
            np.testing.assert_array_equal(r[f"server/{uk}/0.1/tokens"], want)
            assert int(r[f"server/{uk}/0.1/migrations"]) == migs
            np.testing.assert_array_equal(r[f"server/{uk}/1000000000.0/tokens"], want)
            assert int(r[f"server/{uk}/1000000000.0/migrations"]) == 0


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_esp_and_paged_under_mesh_raise(runs, shape):
    """Once refused under a mesh, both now serve: each rank's ESP Server
    (every expert's hidden-dim shard, no balancer) and paged EP Server (the
    pool's KV heads over the model axis, the balancer live) return the
    reference Server's greedy tokens on the same mesh shape, the paged one
    with the reference's migration count (no copy drops at capacity factor
    8, so ESP and EP agree). ``tests/test_torch_mesh_serve.py`` holds the
    paged Server against the reference's own paged run."""
    _, ref, port = runs
    tag = _tag(shape)
    for r in port[shape]:
        for name in ("esp", "paged"):
            np.testing.assert_array_equal(r[f"served/{name}/tokens"],
                                          ref[f"{tag}/server/0.1/tokens"])
        assert int(r["served/esp/migrations"]) == 0
        assert int(r["served/paged/migrations"]) == int(ref[f"{tag}/server/0.1/migrations"])


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_rank_shards_match_reference_specs(runs, shape):
    """Slot rows, cache slots and batch rows of every rank equal the
    shards of the reference's specs on the same mesh coordinates."""
    _, ref, _ = runs
    tag = _tag(shape)
    n_slots = shape[1] * SERVE["slots_per_device"]
    for rank, dr, mr in _coords(shape):
        slot = ref[f"{tag}/shard/slot"][rank]
        cache = ref[f"{tag}/shard/cache"][rank]
        batch = ref[f"{tag}/shard/batch"][rank]
        got = sharding.slot_rows(n_slots, shape[1], mr)
        assert (got.start, got.stop) == tuple(slot[1])
        got = sharding.cache_slots(SERVE["max_seq"], shape[1], mr)
        assert (got.start, got.stop) == tuple(cache[2])
        got = sharding.batch_rows(SERVE["batch"], shape[0], dr)
        assert (got.start, got.stop) == tuple(cache[1]) == tuple(batch[0])
