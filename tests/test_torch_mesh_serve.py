"""The port's serving path under a ``("data", "model")`` mesh of four gloo
processes on the CPU (2 x 2 and 1 x 4), against the JAX package on the same
mesh shapes (four forced host devices in one subprocess, run beside the
port's ranks), fp32, the kernels' plain versions:

* the paged ``Server``: greedy tokens, migrations, host page tables, each
  rank's device tables and lengths exact; its pool shard, tables and
  lengths shaped as the reference's ``cache_specs`` shards;
* the prefill lane: ``decode_step(chunk=...)`` logits and chunk logits
  within 1e-5, the expert counts (the data group's sum) and the chunk's
  copies exact;
* ``mark_dead`` then ``revive`` (device 0, whose experts move to another
  rank): evacuation and revival plans, placement tables and tokens equal;
  the revived device's free slot rows hold ``BLANK_WEIGHT`` on the ranks
  that hold them, and no other rank's rows do;
* ``esp_expert_ffn`` against the reference's (its ragged kernels in
  interpret mode) and ``moe_esp`` against the reference's kernel and einsum
  branches, within 1e-5, with a hidden dim that does not divide 4;
* non-dividing layouts (the smoke model's 2 KV heads on 4 model ranks, an
  odd cache length, ``seq_parallel_kv`` off, slot counts that do not
  divide): each rank's shard against the reference's specs, and the
  Server's tokens on those layouts equal to the reference's;
* the ``RequestScheduler`` under seed 5's chaos plan, splice and chunked
  admission: events, preemptions, streams and the placement table equal to
  the reference's on 1 x 4. On 2 x 2 the reference cannot serve it (its
  ``ep_moe_shardmap`` refuses the batch-1 admission operand; ROADMAP Queue
  3), so there the run must equal the port's own no-mesh virtual-EP run
  and the JAX no-mesh virtual-EP Server's.

The four port processes start with ``torch.multiprocessing`` (spawn), meet
through a file in the test's temporary directory and bound every
collective with a timeout.
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
from repro_torch.parallel import sharding

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((2, 2), (1, 4))
TOL = dict(rtol=1e-5, atol=1e-5)
CFG = smoke(get_config("dbrx-132b"))        # 4 heads, 2 KV heads, 4 experts top-2
SERVE = dict(max_seq=32, batch=4, slots_per_device=3, alpha=0.1)
N_NEW = 6
PAGE = 8
# the prefill lane: the batch on pages 0..15, the chunk's request on 16..19
CHUNKS = ((0, 8), (8, 3))                   # (start, valid tokens)
# non-dividing layouts: (seq_parallel_kv, max_seq)
LAYOUTS = ((False, 32), (True, 33))
ESP_F = (96, 90)                            # 90 does not divide 4
SCHED = dict(max_seq=64, paged=True, page_size=PAGE, pool_pages=10, alpha=0.1,
             slots_per_device=3)
SCHED_NEW = 7
SCHED_CHUNKS = (None, 8)


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


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


def _inputs(path):
    rng = np.random.default_rng(0)
    params = T.init_params(CFG, seed=0, device="cpu")
    arr = {"params/" + k: v.numpy() for k, v in _flatten(params).items()}
    arr["prompt"] = rng.integers(0, CFG.vocab_size, (SERVE["batch"], 8)).astype(np.int32)
    arr["chunk_tokens"] = rng.integers(0, CFG.vocab_size, (len(CHUNKS), PAGE)).astype(np.int32)
    e, d = CFG.n_experts, CFG.d_model
    for f in ESP_F:
        arr[f"esp{f}/router"] = rng.standard_normal((d, e)).astype(np.float32)
        arr[f"esp{f}/w_gate"] = (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32)
        arr[f"esp{f}/w_up"] = (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32)
        arr[f"esp{f}/w_down"] = (rng.standard_normal((e, f, d)) * 0.1).astype(np.float32)
    arr["esp_x"] = (rng.standard_normal((4, 2, d)) * 0.5).astype(np.float32)
    arr["esp_bufs"] = rng.standard_normal((2, e, 8, d)).astype(np.float32)
    arr["esp_counts"] = np.array([[8, 0, 3, 5], [1, 8, 0, 7]], np.int32)
    lens = np.random.default_rng(5).integers(3, 14, size=4)
    for i, n in enumerate(lens):
        arr[f"sched_prompt{i}"] = rng.integers(0, CFG.vocab_size, n).astype(np.int32)
    np.savez(path, **arr)
    return arr


JAX_SCRIPT = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config, smoke
from repro.launch.mesh import make_mesh_compat
from repro.models import transformer as T
from repro.models.moe import moe_esp
from repro.parallel.collectives import esp_expert_ffn
from repro.parallel.ctx import ParallelCtx
from repro.parallel.sharding import batch_spec_for, cache_specs, param_spec
from repro.runtime import faults as F
from repro.runtime.scheduler import RequestScheduler
from repro.runtime.serve import ServeConfig, Server

(SHAPES, SERVE, N_NEW, PAGE, CHUNKS, LAYOUTS, ESP_F, SCHED, SCHED_NEW,
 SCHED_CHUNKS) = {consts}
inp = dict(np.load(sys.argv[1]))
out = {{}}
cfg = smoke(get_config("dbrx-132b"))


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


params = tree("params/")
prompt = jnp.asarray(inp["prompt"])


def fresh():
    return jax.tree.map(jnp.copy, params)


def shards(mesh, shape, spec):
    idx = NamedSharding(mesh, spec).devices_indices_map(shape)
    return np.array([[[s.start or 0, shape[i] if s.stop is None else s.stop]
                      for i, s in enumerate(idx[d])] for d in mesh.devices.reshape(-1)])


def decode_loop(srv, n):
    logits, cache = srv.prefill(prompt)
    toks = []
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    for _ in range(n):
        toks.append(tok)
        logits, cache = srv.decode(tok, cache)
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    return np.concatenate([np.asarray(t) for t in toks], 1), cache


def chunk_steps(ctx, tag):
    # the batch on pages 0..15 of a 24-page pool, the chunk's request on
    # pages 16..19, two chunks through decode_step
    tables = jnp.arange(16, dtype=jnp.int32).reshape(4, 4)
    logits, cache = T.prefill(params, prompt, cfg, ctx, max_seq=SERVE["max_seq"],
                              paged=True, page_size=PAGE, n_pages=24, tables=tables)
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    table = jnp.arange(16, 20, dtype=jnp.int32)
    for i, (start, n) in enumerate(CHUNKS):
        chunk = {{"tokens": jnp.asarray(inp["chunk_tokens"][i:i + 1]), "table": table,
                  "start": jnp.int32(start), "length": jnp.int32(n)}}
        _, _, bare = T.decode_step(params, tok, cache, cfg, ctx)
        logits, cache, stats = T.decode_step(params, tok, cache, cfg, ctx, chunk=chunk)
        out[f"{{tag}}/chunk{{i}}/logits"] = np.asarray(logits)
        out[f"{{tag}}/chunk{{i}}/chunk_logits"] = np.asarray(stats["chunk_logits"])
        out[f"{{tag}}/chunk{{i}}/counts"] = np.asarray(stats["expert_counts"])
        out[f"{{tag}}/chunk{{i}}/copies"] = np.asarray(
            stats["expert_counts"] - bare["expert_counts"])
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)


def sched_run(ctx, scfg, n_dev, tag):
    srv = Server(cfg, ctx, fresh(), ServeConfig(**scfg))
    plan = F.FaultPlan.chaos(5, n_steps=8, n_devices=n_dev, pressure_pages=5,
                             nan_slots=(0, 1, 2))
    s = RequestScheduler(srv, None, faults=plan)
    for i in range(4):
        s.submit(inp[f"sched_prompt{{i}}"], SCHED_NEW, arrival=i)
    res = s.run()
    out[f"{{tag}}/steps"] = np.array([st for st, _, _ in s.events])
    out[f"{{tag}}/kinds"] = np.array([k for _, k, _ in s.events])
    out[f"{{tag}}/preempted"] = np.asarray(s.n_preempted)
    for rid, toks in res.items():
        out[f"{{tag}}/stream{{rid}}"] = np.asarray(toks)
    out[f"{{tag}}/slot_of"] = np.array(srv.table.slot_of)


for shape in SHAPES:
    tag = f"{{shape[0]}}x{{shape[1]}}"
    mesh = make_mesh_compat(shape, ("data", "model"))
    ctx = ParallelCtx(mesh=mesh, capacity_factor=8.0)
    m = shape[1]
    with mesh:
        # the paged Server
        srv = Server(cfg, ctx, fresh(), ServeConfig(paged=True, page_size=PAGE, **SERVE))
        toks, cache = decode_loop(srv, N_NEW)
        out[f"{{tag}}/paged/tokens"] = toks
        out[f"{{tag}}/paged/migrations"] = np.asarray(srv.migrations)
        out[f"{{tag}}/paged/host_tables"] = np.asarray(srv._tables)
        lay = cache["layers"]
        out[f"{{tag}}/paged/tables"] = np.asarray(lay["tables"])
        out[f"{{tag}}/paged/lengths"] = np.asarray(lay["lengths"])
        specs = cache_specs(cfg, {{"layers": lay}}, ctx, SERVE["batch"])["layers"]
        for name in ("pool_k", "tables", "lengths"):
            out[f"{{tag}}/paged/shard/{{name}}"] = shards(mesh, lay[name].shape, specs[name])
        # the prefill lane (the reference refuses its batch-1 operand under
        # a data axis of 2)
        try:
            chunk_steps(ctx, tag)
        except ValueError as exc:
            out[f"{{tag}}/chunk_fault"] = np.asarray(str(exc))
        # death of device 0 and its revival
        srv = Server(cfg, ctx, fresh(), ServeConfig(**dict(SERVE, slots_per_device=4)))
        logits, cache = srv.prefill(prompt)
        toks = []
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        for step in range(8):
            if step == 0:
                out[f"{{tag}}/death/plan"] = np.asarray(srv.mark_dead(0)).reshape(-1, 3)
                out[f"{{tag}}/death/slot_of_dead"] = np.array(srv.table.slot_of)
            if step == 3:
                out[f"{{tag}}/death/plan_revive"] = np.asarray(srv.revive(0)).reshape(-1, 3)
                out[f"{{tag}}/death/slot_of_revived"] = np.array(srv.table.slot_of)
            toks.append(tok)
            logits, cache = srv.decode(tok, cache)
            tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        out[f"{{tag}}/death/tokens"] = np.concatenate([np.asarray(t) for t in toks], 1)
        out[f"{{tag}}/death/slot_of"] = np.array(srv.table.slot_of)
        out[f"{{tag}}/death/n_replicas"] = np.array(srv.table.n_replicas)
        out[f"{{tag}}/death/migrations"] = np.asarray(srv.migrations)
        # ESP: the expert FFN (ragged kernels in interpret mode) and moe_esp
        kctx = ParallelCtx(mesh=mesh, use_kernels=True)
        n_b = shape[0]
        w = {{n: jnp.asarray(inp[f"esp96/{{n}}"]) for n in ("w_gate", "w_up", "w_down")}}
        y = esp_expert_ffn(jnp.asarray(inp["esp_bufs"][:n_b]),
                           jnp.asarray(inp["esp_counts"][:n_b]), w["w_gate"], w["w_up"],
                           w["w_down"], kctx)
        out[f"{{tag}}/esp/ffn"] = np.asarray(y)
        for f in ESP_F:
            c = dataclasses.replace(cfg, moe_d_ff=f)
            p = {{n: jnp.asarray(inp[f"esp{{f}}/{{n}}"]) for n in ("router", "w_gate", "w_up",
                                                               "w_down")}}
            for uk in (True, False):
                o, _ = moe_esp(p, jnp.asarray(inp["esp_x"]), c,
                               ParallelCtx(mesh=mesh, use_kernels=uk, capacity_factor=8.0))
                out[f"{{tag}}/esp/moe/{{f}}/{{uk}}"] = np.asarray(o)
        # layouts
        for sp, max_seq in LAYOUTS:
            lctx = ParallelCtx(mesh=mesh, capacity_factor=8.0, seq_parallel_kv=sp)
            srv = Server(cfg, lctx, fresh(), ServeConfig(**dict(SERVE, max_seq=max_seq)))
            toks, cache = decode_loop(srv, N_NEW)
            out[f"{{tag}}/layout/{{sp}}/{{max_seq}}/tokens"] = toks
            k = cache["layers"]["k"]
            spec = cache_specs(cfg, {{"layers": cache["layers"]}}, lctx, SERVE["batch"])
            out[f"{{tag}}/layout/{{sp}}/{{max_seq}}/shard"] = shards(
                mesh, k.shape, spec["layers"]["k"])
        for n_slots in (m * 2, 6):
            for name in ("w_gate", "w_down"):
                shp = (2, n_slots, 64, 96) if name == "w_gate" else (2, n_slots, 96, 64)
                spec = param_spec(f"layers/moe/{{name}}", shp, cfg, m)
                out[f"{{tag}}/param/{{name}}/{{n_slots}}"] = shards(mesh, shp, spec)
        spec = P(batch_spec_for(3, ctx))
        out[f"{{tag}}/batch3"] = shards(mesh, (3,), spec)
    # the scheduler under seed 5's chaos plan
    for chunk in SCHED_CHUNKS:
        scfg = dict(SCHED, batch=3 if shape[0] == 1 else 4, prefill_chunk=chunk)
        with mesh:
            try:
                sched_run(ctx, scfg, m, f"{{tag}}/sched/{{chunk}}")
            except ValueError as exc:
                out[f"{{tag}}/sched/{{chunk}}/fault"] = np.asarray(str(exc))
        if shape[0] > 1:
            sched_run(ParallelCtx(capacity_factor=8.0), dict(scfg, virtual_ep=m), m,
                      f"{{tag}}/sched_nomesh/{{chunk}}")
    if shape[0] > 1:
        # the prefill lane with no mesh
        chunk_steps(ParallelCtx(capacity_factor=8.0, moe_impl="ep"), "nomesh")
np.savez(sys.argv[2], **out)
"""


def _start_jax(inputs: Path, out: Path, shape) -> subprocess.Popen:
    """The reference on one mesh shape (the 2 x 2 run also gives the
    no-mesh runs), in a subprocess of its own."""
    consts = repr(((shape,), SERVE, N_NEW, PAGE, CHUNKS, LAYOUTS, ESP_F, SCHED, SCHED_NEW,
                   SCHED_CHUNKS))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT.format(consts=consts)),
         str(inputs), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    )


def _rank_main(rank, shape, init_file, inputs, out_dir):
    """One port rank: every cell of the file on this rank's blocks, saved
    as ``rank<r>.npz``."""
    import torch.distributed as dist

    from repro_torch.bridge import params_from_numpy
    from repro_torch.models.moe import moe_esp
    from repro_torch.parallel.collectives import esp_expert_ffn
    from repro_torch.parallel.ctx import ParallelCtx
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.runtime import faults as F
    from repro_torch.runtime.scheduler import RequestScheduler
    from repro_torch.runtime.serve import BLANK_WEIGHT, ServeConfig, Server

    torch.set_num_threads(1)
    data, model = shape
    timeout = datetime.timedelta(seconds=120)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=data * model, rank=rank, timeout=timeout)
    mesh = make_mesh(data, model, timeout=timeout)
    inp = dict(np.load(inputs))
    np_params = _unflatten(inp, "params/")
    out = {}
    ctx = ParallelCtx(mesh=mesh, capacity_factor=8.0)
    rows = sharding.batch_rows(SERVE["batch"], data, mesh.data_rank)
    prompt = torch.tensor(inp["prompt"]).long()

    def params():
        return params_from_numpy(np_params, device="cpu")

    def decode_loop(srv, n):
        logits, cache = srv.prefill(prompt)
        toks = []
        tok = torch.argmax(logits[:, -1:], dim=-1)
        for _ in range(n):
            toks.append(tok)
            logits, cache = srv.decode(tok, cache)
            tok = torch.argmax(logits[:, -1:], dim=-1)
        return torch.cat(toks, 1).numpy(), cache

    # the paged Server
    srv = Server(CFG, ctx, params(), ServeConfig(paged=True, page_size=PAGE, **SERVE),
                 device="cpu")
    toks, cache = decode_loop(srv, N_NEW)
    out["paged/tokens"] = toks
    out["paged/migrations"] = np.asarray(srv.migrations)
    out["paged/host_tables"] = srv._tables.copy()
    for name in ("pool_k", "tables", "lengths"):
        out[f"paged/{name}"] = cache["layers"][name].numpy()

    # the prefill lane: each rank its batch rows and slot rows
    lp = params()
    mine = sharding.slot_rows(CFG.n_experts, model, mesh.model_rank)
    for w in ("w_gate", "w_up", "w_down"):
        lp["layers"]["moe"][w] = lp["layers"]["moe"][w][:, mine].contiguous()
    tables = torch.arange(16, dtype=torch.int32).reshape(4, 4)[rows]
    logits, cache = T.prefill(lp, prompt[rows], CFG, ctx, max_seq=SERVE["max_seq"],
                              paged=True, page_size=PAGE, n_pages=24, tables=tables)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    table = torch.arange(16, 20, dtype=torch.int32)
    for i, (start, n) in enumerate(CHUNKS):
        chunk = {"tokens": torch.tensor(inp["chunk_tokens"][i:i + 1]).long(),
                 "table": table, "start": start, "length": n}
        bare_cache = {"pos": cache["pos"], "len": cache["len"],
                      "layers": {k: v.clone() for k, v in cache["layers"].items()}}
        _, _, bare = T.decode_step(lp, tok, bare_cache, CFG, ctx)
        logits, cache, stats = T.decode_step(lp, tok, cache, CFG, ctx, chunk=chunk)
        counts, bare_counts = stats["expert_counts"], bare["expert_counts"]
        dist.all_reduce(counts, group=mesh.data_group)
        dist.all_reduce(bare_counts, group=mesh.data_group)
        out[f"chunk{i}/logits"] = logits.numpy()
        out[f"chunk{i}/chunk_logits"] = stats["chunk_logits"].numpy()
        out[f"chunk{i}/counts"] = counts.numpy()
        out[f"chunk{i}/copies"] = (counts - bare_counts).numpy()
        tok = torch.argmax(logits[:, -1:], dim=-1)

    # death of device 0 and its revival
    srv = Server(CFG, ctx, params(), ServeConfig(**dict(SERVE, slots_per_device=4)),
                 device="cpu")
    logits, cache = srv.prefill(prompt)
    toks = []
    tok = torch.argmax(logits[:, -1:], dim=-1)
    for step in range(8):
        if step == 0:
            out["death/plan"] = np.asarray(srv.mark_dead(0)).reshape(-1, 3)
            out["death/slot_of_dead"] = srv.table.slot_of.copy()
        if step == 3:
            out["death/plan_revive"] = np.asarray(srv.revive(0)).reshape(-1, 3)
            out["death/slot_of_revived"] = srv.table.slot_of.copy()
            moe = srv._moe()
            blank = np.stack([(moe[w] == BLANK_WEIGHT).all(dim=(0, 2, 3)).numpy()
                              for w in ("w_gate", "w_up", "w_down")])
            out["death/blank_rows"] = blank.all(axis=0)       # (local slot rows,)
            out["death/any_blank"] = np.stack([(moe[w] == BLANK_WEIGHT).any(dim=(0, 2, 3))
                                               .numpy() for w in ("w_gate", "w_up",
                                                                  "w_down")]).any(axis=0)
            out["death/free_after_revive"] = srv.table.owner_of_slots() < 0
        toks.append(tok)
        logits, cache = srv.decode(tok, cache)
        tok = torch.argmax(logits[:, -1:], dim=-1)
    out["death/tokens"] = torch.cat(toks, 1).numpy()
    out["death/slot_of"] = srv.table.slot_of.copy()
    out["death/n_replicas"] = srv.table.n_replicas.copy()
    out["death/migrations"] = np.asarray(srv.migrations)

    # ESP: the expert FFN and moe_esp on the rank's hidden-dim shard
    fs = sharding.expert_hidden(96, model, mesh.model_rank)
    w = {n: torch.tensor(inp[f"esp96/{n}"]) for n in ("w_gate", "w_up", "w_down")}
    y = esp_expert_ffn(torch.tensor(inp["esp_bufs"][mesh.data_rank:mesh.data_rank + 1]),
                       torch.tensor(inp["esp_counts"][mesh.data_rank:mesh.data_rank + 1]),
                       w["w_gate"][..., fs].contiguous(), w["w_up"][..., fs].contiguous(),
                       w["w_down"][:, fs].contiguous(), ParallelCtx(mesh=mesh))
    out["esp/ffn"] = y.numpy()
    x = torch.tensor(inp["esp_x"])[rows]
    for f in ESP_F:
        cfg = dataclasses.replace(CFG, moe_d_ff=f)
        fs = sharding.expert_hidden(f, model, mesh.model_rank)
        p = {"router": torch.tensor(inp[f"esp{f}/router"]),
             "w_gate": torch.tensor(inp[f"esp{f}/w_gate"][..., fs]),
             "w_up": torch.tensor(inp[f"esp{f}/w_up"][..., fs]),
             "w_down": torch.tensor(inp[f"esp{f}/w_down"][:, fs])}
        for uk in ("auto", False):
            o, _ = moe_esp(p, x, cfg, ParallelCtx(mesh=mesh, use_kernels=uk,
                                                  capacity_factor=8.0))
            out[f"esp/moe/{f}/{uk}"] = o.numpy()
    # the ESP Server (its hidden-dim shards, no balancer), dense and paged
    for paged in (False, True):
        srv = Server(CFG, ParallelCtx(mesh=mesh, moe_impl="esp", capacity_factor=8.0),
                     params(), ServeConfig(paged=paged, page_size=PAGE, **SERVE),
                     device="cpu")
        out[f"esp/server/{paged}"] = srv.generate(prompt, N_NEW).numpy()

    # layouts
    for sp, max_seq in LAYOUTS:
        lctx = ParallelCtx(mesh=mesh, capacity_factor=8.0, seq_parallel_kv=sp)
        srv = Server(CFG, lctx, params(), ServeConfig(**dict(SERVE, max_seq=max_seq)),
                     device="cpu")
        toks, cache = decode_loop(srv, N_NEW)
        out[f"layout/{sp}/{max_seq}/tokens"] = toks
        out[f"layout/{sp}/{max_seq}/k_shape"] = np.asarray(cache["layers"]["k"].shape)

    # the scheduler under seed 5's chaos plan, and with no mesh on virtual EP
    for chunk in SCHED_CHUNKS:
        scfg = dict(SCHED, batch=3 if data == 1 else 4, prefill_chunk=chunk)
        for name, sctx, extra in (("sched", ctx, {}),
                                  ("sched_nomesh", ParallelCtx(capacity_factor=8.0),
                                   {"virtual_ep": model})):
            srv = Server(CFG, sctx, params(), ServeConfig(**scfg, **extra), device="cpu")
            plan = F.FaultPlan.chaos(5, n_steps=8, n_devices=model, pressure_pages=5,
                                     nan_slots=(0, 1, 2))
            s = RequestScheduler(srv, None, faults=plan)
            for i in range(4):
                s.submit(inp[f"sched_prompt{i}"], SCHED_NEW, arrival=i)
            res = s.run()
            tag = f"{name}/{chunk}"
            out[f"{tag}/steps"] = np.array([st for st, _, _ in s.events])
            out[f"{tag}/kinds"] = np.array([k for _, k, _ in s.events])
            out[f"{tag}/preempted"] = np.asarray(s.n_preempted)
            for rid, t in res.items():
                out[f"{tag}/stream{rid}"] = np.asarray(t)
            out[f"{tag}/slot_of"] = srv.table.slot_of.copy()
            out[f"{tag}/fired"] = np.asarray(sorted({d[0] for _, k, d in s.events
                                                     if k == "fault"}))
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results (one subprocess a mesh shape, run beside
    the port's ranks) and the port's, one spawn of four ranks a shape."""
    base = tmp_path_factory.mktemp("mesh_serve")
    inputs = base / "inputs.npz"
    inp = _inputs(inputs)
    procs = {shape: _start_jax(inputs, base / f"jax{_tag(shape)}.npz", shape)
             for shape in SHAPES}
    try:
        port = {}
        for shape in SHAPES:
            out_dir = base / _tag(shape)
            out_dir.mkdir()
            tmp.spawn(_rank_main, args=(shape, str(out_dir / "pg"), str(inputs), str(out_dir)),
                      nprocs=shape[0] * shape[1], join=True)
            port[shape] = [dict(np.load(out_dir / f"rank{r}.npz"))
                           for r in range(shape[0] * shape[1])]
        ref = {}
        for shape, proc in procs.items():
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            ref.update(np.load(base / f"jax{_tag(shape)}.npz"))
    finally:
        for proc in procs.values():
            proc.kill()
    return inp, ref, port


def _coords(shape):
    return [(r, r // shape[1], r % shape[1]) for r in range(shape[0] * shape[1])]


def _slice_pairs(sl: slice, n: int):
    return [sl.start, sl.stop if sl.stop is not None else n]


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_paged_server_matches_reference(runs, shape):
    """Tokens, migrations and host page tables equal on every rank; each
    rank's device tables and lengths are its rows of the reference's, and
    its pool, tables and lengths have the shapes of the reference's
    ``cache_specs`` shards (the pool: every page, the rank's KV heads when
    they divide the model axis, all of them otherwise)."""
    _, ref, port = runs
    tag = _tag(shape)
    want = ref[f"{tag}/paged/tokens"]
    assert int(ref[f"{tag}/paged/migrations"]) > 0
    for rank, dr, mr in _coords(shape):
        r = port[shape][rank]
        np.testing.assert_array_equal(r["paged/tokens"], want)
        assert int(r["paged/migrations"]) == int(ref[f"{tag}/paged/migrations"])
        np.testing.assert_array_equal(r["paged/host_tables"], ref[f"{tag}/paged/host_tables"])
        for name in ("tables", "lengths"):
            sh = ref[f"{tag}/paged/shard/{name}"][rank]
            np.testing.assert_array_equal(
                r[f"paged/{name}"], ref[f"{tag}/paged/{name}"][:, sh[1][0]:sh[1][1]])
        sh = ref[f"{tag}/paged/shard/pool_k"][rank]
        assert r["paged/pool_k"].shape == tuple(int(b - a) for a, b in sh)
        heads = sharding.kv_heads(CFG.n_kv_heads, shape[1], mr)
        assert [heads.start, heads.stop] == list(sh[3])


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_chunk_lane_matches_reference(runs, shape):
    """Two chunks through ``decode_step`` beside the decode batch: logits
    and chunk logits within 1e-5, expert counts and the chunk's copies
    exact. The JAX no-mesh step holds every shape; the reference's mesh
    step holds 1 x 4, and on 2 x 2 it refuses the operand."""
    _, ref, port = runs
    tag = _tag(shape)
    refs = ["nomesh"]
    if shape[0] == 1:
        refs.append(tag)
    else:
        assert "batch=1 does not divide" in str(ref[f"{tag}/chunk_fault"])
    for i, (_, n) in enumerate(CHUNKS):
        for src in refs:
            for rank, dr, _ in _coords(shape):
                r = port[shape][rank]
                rows = sharding.batch_rows(SERVE["batch"], shape[0], dr)
                np.testing.assert_allclose(r[f"chunk{i}/logits"],
                                           ref[f"{src}/chunk{i}/logits"][rows], **TOL)
                np.testing.assert_allclose(r[f"chunk{i}/chunk_logits"],
                                           ref[f"{src}/chunk{i}/chunk_logits"], **TOL)
                np.testing.assert_array_equal(r[f"chunk{i}/counts"],
                                              ref[f"{src}/chunk{i}/counts"])
                np.testing.assert_array_equal(r[f"chunk{i}/copies"],
                                              ref[f"{src}/chunk{i}/copies"])
                assert r[f"chunk{i}/copies"].sum() == n * CFG.experts_per_token * CFG.n_layers


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_death_and_revival_match_reference(runs, shape):
    """Device 0 dies right after the prefill (its experts evacuate to other
    ranks) and revives at step 3: plans, placement tables, migrations and tokens equal
    the reference's; right after the revival the device's free slot rows
    hold ``BLANK_WEIGHT`` on the ranks that hold them, and no other rank's
    rows do."""
    _, ref, port = runs
    tag = _tag(shape)
    assert len(ref[f"{tag}/death/plan"]) > 0 and len(ref[f"{tag}/death/plan_revive"]) > 0
    spd = 4
    for rank, _, mr in _coords(shape):
        r = port[shape][rank]
        for name in ("plan", "plan_revive", "slot_of_dead", "slot_of_revived", "tokens",
                     "slot_of", "n_replicas", "migrations"):
            np.testing.assert_array_equal(r[f"death/{name}"], ref[f"{tag}/death/{name}"],
                                          err_msg=f"{name} rank {rank}")
        mine = sharding.slot_rows(spd * shape[1], shape[1], mr)
        free = r["death/free_after_revive"][mine]
        dev0 = np.arange(mine.start, mine.stop) < spd
        np.testing.assert_array_equal(r["death/blank_rows"], free & dev0)
        np.testing.assert_array_equal(r["death/any_blank"], free & dev0)
    assert any(port[shape][rank]["death/blank_rows"].any() for rank, _, _ in _coords(shape))


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_esp_under_mesh_matches_reference(runs, shape):
    """``esp_expert_ffn`` (the ragged pair's plain versions on the rank's
    hidden shard, reduce-scattered onto d) against the reference's ragged
    kernels in interpret mode; ``moe_esp``'s kernel and einsum branches
    against the reference's, the einsum branch also where 90 columns do
    not divide 4; the ESP Server's tokens, dense and paged, equal to the
    reference's EP tokens (no copy drops at capacity factor 8)."""
    _, ref, port = runs
    tag = _tag(shape)
    d = CFG.d_model
    for rank, dr, mr in _coords(shape):
        r = port[shape][rank]
        ds = slice(mr * d // shape[1], (mr + 1) * d // shape[1])
        np.testing.assert_allclose(r["esp/ffn"], ref[f"{tag}/esp/ffn"][dr:dr + 1, ..., ds],
                                   **TOL)
        rows = sharding.batch_rows(4, shape[0], dr)
        for f in ESP_F:
            for uk, juk in (("auto", True), ("False", False)):
                np.testing.assert_allclose(r[f"esp/moe/{f}/{uk}"],
                                           ref[f"{tag}/esp/moe/{f}/{juk}"][rows], **TOL)
        for paged in (False, True):
            np.testing.assert_array_equal(r[f"esp/server/{paged}"],
                                          ref[f"{tag}/paged/tokens"])


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_non_dividing_layouts_match_reference(runs, shape):
    """Each rank's shard against the reference's specs where a dim does
    not divide: the dense cache with ``seq_parallel_kv`` off and with 33
    slots (KV heads over 2 ranks, replicated over 4), expert weights whose
    slot count does not divide (the hidden-dim fallback), a batch of 3; the
    Server's tokens on those cache layouts equal the reference's."""
    _, ref, port = runs
    tag = _tag(shape)
    m = shape[1]
    for sp, max_seq in LAYOUTS:
        for rank, dr, mr in _coords(shape):
            r = port[shape][rank]
            np.testing.assert_array_equal(r[f"layout/{sp}/{max_seq}/tokens"],
                                          ref[f"{tag}/layout/{sp}/{max_seq}/tokens"])
            sh = ref[f"{tag}/layout/{sp}/{max_seq}/shard"][rank]
            slots, heads = sharding.dense_cache_shard(max_seq, CFG.n_kv_heads, m, mr, sp)
            assert [slots.start, slots.stop] == list(sh[2])
            assert [heads.start, heads.stop] == list(sh[3])
            assert tuple(r[f"layout/{sp}/{max_seq}/k_shape"]) == tuple(
                int(b - a) for a, b in sh)
    for n_slots in (m * 2, 6):
        for name in ("w_gate", "w_down"):
            shp = (2, n_slots, 64, 96) if name == "w_gate" else (2, n_slots, 96, 64)
            # the slot rows when they divide, else the hidden dim
            dim = 1 if n_slots % m == 0 else (3 if name == "w_gate" else 2)
            for rank, _, mr in _coords(shape):
                sh = ref[f"{tag}/param/{name}/{n_slots}"][rank]
                for i, n in enumerate(shp):
                    want = list(sh[i])
                    if i == dim:
                        got = sharding.slot_rows(n, m, mr) if i == 1 else \
                            sharding.expert_hidden(n, m, mr)
                        assert _slice_pairs(got, n) == want
                    else:
                        assert want == [0, n]
    for rank, dr, _ in _coords(shape):
        got = sharding.batch_rows(3, shape[0], dr)
        assert [got.start, got.stop] == list(ref[f"{tag}/batch3"][rank][0])


@pytest.mark.parametrize("chunk", SCHED_CHUNKS, ids=("splice", "chunked"))
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_scheduler_chaos_under_mesh(runs, shape, chunk):
    """Seed 5's chaos plan (a death, a straggler, pool pressure, a NaN
    step) through the ``RequestScheduler`` over the meshed Server: events,
    preemptions, streams and the placement table equal to the reference's
    mesh run on 1 x 4; on 2 x 2, where the reference refuses the batch-1
    admission operand, equal to the port's no-mesh virtual-EP run and to
    the JAX no-mesh virtual-EP run of the same plan."""
    _, ref, port = runs
    tag = _tag(shape)
    if shape[0] == 1:
        want = f"{tag}/sched/{chunk}"
    else:
        assert "batch=1 does not divide" in str(ref[f"{tag}/sched/{chunk}/fault"])
        want = f"{tag}/sched_nomesh/{chunk}"
    assert {"fault", "preempt"} <= set(ref[f"{want}/kinds"].tolist())
    for rank, _, _ in _coords(shape):
        r = port[shape][rank]
        for name in ("sched", "sched_nomesh"):
            got = f"{name}/{chunk}"
            for key in ("steps", "kinds"):
                np.testing.assert_array_equal(r[f"{got}/{key}"], ref[f"{want}/{key}"],
                                              err_msg=got)
            assert int(r[f"{got}/preempted"]) == int(ref[f"{want}/preempted"]) > 0
            for rid in range(4):
                np.testing.assert_array_equal(r[f"{got}/stream{rid}"],
                                              ref[f"{want}/stream{rid}"])
            np.testing.assert_array_equal(r[f"{got}/slot_of"], ref[f"{want}/slot_of"])
        assert {"device_death", "straggler", "pool_pressure", "nan_logits"} <= set(
            r[f"sched/{chunk}/fired"].tolist())
