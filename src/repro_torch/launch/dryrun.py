"""Multi-pod dry run: trace every (arch x shape x mesh) cell of the
production mesh on the host, allocating nothing (PyTorch port of
``repro.launch.dryrun``).

One process plays rank 0 of a world of 256 (``single``: 16 x 16
``("data", "model")``) or 512 (``multi``: 2 x 16 x 16, ``("pod", "data",
"model")``) ranks on the ``"fake"`` process-group backend, whose
collectives complete without moving data. The mesh is built over that
world with ``launch.mesh`` (the ER placement by default). Then, under
``FakeTensorMode`` (tensors with shapes, dtypes and devices but no
storage, on ``"cpu"``), rank 0's parameters come from ``T.init_params``,
cut to rank 0's slices by ``parallel.sharding.rank_params`` (EP: the slot
rows of the experts at their native homes; ESP: every expert's
hidden-dim shard), its cache from ``T.init_cache(ctx=)``, and one
``T.prefill``, ``T.decode_step`` or train step runs on rank 0's batch
rows (one new token against a ``seq_len`` cache):

* ``prefill_*`` -> ``transformer.prefill``;
* ``decode_*`` / ``long_*`` -> ``transformer.decode_step``;
* ``train_*`` -> ``runtime.train.make_train_step``: one step (forward,
  backward with remat over layers, as the reference's ``make_ctx`` sets,
  and AdamW) on rank 0's slices of the train state (``sharding.
  rank_params``: the moments take their parameter's layout) and its batch
  rows, traced with gradients on;
* the ``zamba``, ``xlstm`` and ``encdec`` patterns under a mesh are
  recorded as ``SKIP`` naming the ROADMAP item that brings them (Queue 1
  item 6), as ``long_500k`` is for a model with full attention.

The ctx is the reference's: capacity factor 1.25 and the plain path
(``use_kernels=False``), since no CUDA kernel launches on a fake tensor
(the reference's CPU lowering ran its plain path too). :func:`analyze`
records, per rank, under the reference's JSON keys: ``flops``,
``bytes_accessed``, ``argument_size_in_bytes``, ``output_size_in_bytes``,
``temp_size_in_bytes`` and ``collectives`` (see there what each counts),
plus ``collective_calls``. The port runs every layer eagerly, so there is
no scan body to undercount and no ``probe1``/``probe2``: ``units`` is
written and the roofline reads the full values.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out results/torch/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, SHAPES, get_config, shapes_for
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import make_er_mesh, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding
from repro_torch.parallel.ctx import ParallelCtx
from repro_torch.parallel.mesh import Mesh
from repro_torch.runtime.optimizer import AdamWConfig, adamw_init
from repro_torch.runtime.train import make_train_step

PARAM_DTYPE = torch.bfloat16
WORLD = {"single": 256, "multi": 512}
ITEM_6 = "ROADMAP Queue 1 item 6"

# c10d op the port's collectives dispatch to -> the reference's HLO name
# (``parallel/collectives.py``: ``all_reduce``, ``all_gather``,
# ``all_to_all_single``, ``reduce_scatter_tensor``; the migration driver's
# ``send``/``recv``); any other raises
COLLECTIVE = {
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "alltoall_base_": "all-to-all",
    "_reduce_scatter_base_": "reduce-scatter",
    "send": "collective-permute",
}


# ---------------------------------------------------------------------------
# the fake world and the mesh
# ---------------------------------------------------------------------------

def fake_world(world: int) -> None:
    """Make this process rank 0 of a ``"fake"``-backend world of ``world``
    ranks (replacing any world it already belongs to). The backend lives
    in a private module of torch; without it the dry run cannot count
    collectives, so it raises."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch's 'fake' process-group backend "
            "(torch.testing._internal.distributed.fake_pg), which this torch "
            f"{torch.__version__} lacks"
        ) from e
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def production_mesh(mesh_kind: str, mapping: str) -> Mesh:
    """The production mesh of ``mesh_kind`` over a fresh fake world, with
    ``mapping``'s placement (``none``: row-major)."""
    fake_world(WORLD[mesh_kind])
    multi_pod = mesh_kind == "multi"
    if mapping == "none":
        return make_production_mesh(multi_pod=multi_pod)
    return make_er_mesh(multi_pod=multi_pod, mapping=mapping)


# ---------------------------------------------------------------------------
# inputs, ctx and rank 0's slices
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Model inputs for one workload cell: ``{name: (global shape, dtype)}``."""
    b, s = shape.global_batch, shape.seq_len
    specs = {}
    if shape.kind == "train":
        specs["tokens"] = ((b, s), torch.int32)
        specs["labels"] = ((b, s), torch.int32)
    elif shape.kind == "prefill":
        specs["tokens"] = ((b, s), torch.int32)
    else:  # decode: one new token against a seq_len cache
        specs["tokens"] = ((b, 1), torch.int32)
    if cfg.frontend_stub:
        specs["embeds"] = ((b, cfg.frontend_tokens, cfg.d_model), PARAM_DTYPE)
    return specs


def make_ctx(mesh: Mesh, batch: int) -> ParallelCtx:
    """The reference's ``make_ctx``: capacity factor 1.25, the plain path;
    a batch that does not divide the batch axes is replicated (long_500k's
    B = 1)."""
    return ParallelCtx(
        mesh=mesh,
        capacity_factor=1.25,
        use_kernels=False,
        batch_replicated=batch % mesh.n_batch != 0,
    )


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree (a view counts its own elements)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


# aten ops that return a tensor but move no bytes (views not tagged as such)
NO_BYTES = {"_unsafe_view", "alias", "lift_fresh", "detach"}


def _moves_bytes(func, out) -> bool:
    """Does an op read and write memory: an aten op returning a tensor that
    is not a view (metadata queries such as ``prim.device`` and views move
    nothing)."""
    return (func.namespace == "aten" and not func.is_view
            and func._schema.name.split("::")[-1] not in NO_BYTES
            and any(True for _ in _tensors(out)))


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


# ---------------------------------------------------------------------------
# cost analysis
# ---------------------------------------------------------------------------

class _Cost(TorchDispatchMode):
    """Counts what every aten op of a traced step reads, writes and
    allocates, and the operand bytes of every c10d collective."""

    def __init__(self, held: set[int]):
        super().__init__()
        self.held = held                 # the arguments' storages
        self.bytes_accessed = 0
        self.collectives: dict[str, int] = {}
        self.calls: dict[str, int] = {}
        self.live: dict[int, list[int]] = {}   # storage -> [bytes, tensor objects]
        self.now = 0
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            self._collective(func, args)
        elif _moves_bytes(func, out):
            self.bytes_accessed += tree_bytes(args) + tree_bytes(kwargs) + tree_bytes(out)
        for t in _tensors(out):
            self._track(t)
        return out

    def _collective(self, func, args) -> None:
        name = func._schema.name.split("::")[-1]
        if name == "recv_":
            return                       # the send counts the permute's operand
        op = COLLECTIVE.get(name)
        if op is None:
            raise NotImplementedError(f"dry run: no byte rule for c10d.{name}")
        # the operand: the input tensors (the output list precedes them
        # in the all-gather and all-to-all schemas)
        operand = args[0] if name in ("allreduce_", "send") else args[1]
        n = tree_bytes(operand) * (2 if op == "all-reduce" else 1)
        self.collectives[op] = self.collectives.get(op, 0) + n
        self.calls[op] = self.calls.get(op, 0) + 1

    def _track(self, t: torch.Tensor) -> None:
        key = _key(t)
        if key in self.held:
            return
        entry = self.live.get(key)
        if entry is None:
            entry = self.live[key] = [t.untyped_storage().nbytes(), 0]
            self.now += entry[0]
            self.peak = max(self.peak, self.now)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self.live[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.now -= entry[0]
            del self.live[key]


def analyze(fn, *args, grad: bool = False) -> tuple[object, dict]:
    """Run ``fn(*args)`` (fake tensors) under the counters, with autograd
    on only where ``grad`` asks for it (a train step); returns its result
    and the record:

    * ``flops``: ``FlopCounterMode``'s count of the matmuls, convolutions
      and attention calls;
    * ``bytes_accessed``: the input and output bytes of every aten op that
      returns a tensor, views excluded, summed: unfused, as the
      reference's CPU-lowered HLO figure is (a fused kernel reads and
      writes less);
    * ``argument_size_in_bytes``: the tensors of ``args`` (parameters,
      cache and inputs); ``output_size_in_bytes``: those of the result;
    * ``temp_size_in_bytes``: the peak of the storage bytes allocated
      inside the step and still referenced (freed storages are tracked
      with ``weakref.finalize``), outputs included. It is the plain
      path's (its chunked attention scores, its padded expert buckets);
      the CUDA kernels' workspaces are not modelled;
    * ``collectives``: operand bytes per c10d op under the reference's
      HLO names, ``all-reduce`` weighted x2 (a ring all-reduce moves about
      twice its operand), plus ``total``; ``collective_calls``: the calls.
    """
    held = {_key(t) for t in _tensors(args)}
    cost = _Cost(held)
    flops = FlopCounterMode(display=False)
    with torch.set_grad_enabled(grad), flops, cost:
        out = fn(*args)
    coll = dict(cost.collectives)
    coll["total"] = sum(coll.values())
    rec = {
        "flops": float(flops.get_total_flops()),
        "bytes_accessed": float(cost.bytes_accessed),
        "argument_size_in_bytes": tree_bytes(args),
        "output_size_in_bytes": tree_bytes(out),
        "temp_size_in_bytes": cost.peak,
        "collectives": coll,
        "collective_calls": dict(cost.calls),
    }
    return out, rec


# ---------------------------------------------------------------------------
# per-cell tracing
# ---------------------------------------------------------------------------

def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    """Why a cell is not traced (every cell here is under a mesh)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return "SKIP (full attention cannot fit the 524k context)"
    if cfg.block_pattern != "attn":
        return f"SKIP ({cfg.block_pattern} under a mesh: {ITEM_6})"
    return None


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
               multi_pod: bool = False) -> dict:
    """Trace rank 0's step of one cell on fake tensors; the record of
    :func:`analyze` plus ``param_count`` (the config's), ``param_bytes``
    (rank 0's slices) and ``n_devices``. ``multi_pod`` must match the
    mesh (the batch spans ``pod x data`` there)."""
    if multi_pod != (mesh.pod > 1):
        raise ValueError(f"multi_pod={multi_pod} but the mesh has {mesh.pod} pod(s)")
    ctx = make_ctx(mesh, shape.global_batch)
    if shape.kind == "train":
        ctx = dataclasses.replace(ctx, remat=True)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = sharding.rank_params(T.init_params(cfg, dtype=PARAM_DTYPE, device="cpu"),
                                      cfg, ctx)
        rows = sharding.batch_rows(shape.global_batch, ctx.n_batch, ctx.batch_rank)
        inputs = {}
        for name, (shp, dt) in input_specs(cfg, shape).items():
            shp = (rows.stop - rows.start, *shp[1:])
            inputs[name] = torch.zeros(shp, dtype=dt, device="cpu")
        if shape.kind == "train":
            state = {"params": params, "opt": adamw_init(params)}
            step = make_train_step(cfg, ctx, AdamWConfig(total_steps=10_000))
            out, rec = analyze(step, state, inputs, grad=True)
        elif shape.kind == "prefill":
            def step(params, inputs):
                return T.prefill(params, inputs["tokens"], cfg, ctx, max_seq=shape.seq_len,
                                 dtype=PARAM_DTYPE, embeds=inputs.get("embeds"))
            out, rec = analyze(step, params, inputs)
        else:
            cache = T.init_cache(cfg, rows.stop - rows.start, shape.seq_len, PARAM_DTYPE,
                                 device="cpu", ctx=ctx)
            cache["pos"] = shape.seq_len - 1

            def step(params, inputs, cache):
                logits, cache, _ = T.decode_step(params, inputs["tokens"], cache, cfg, ctx)
                return logits, cache
            out, rec = analyze(step, params, inputs, cache)
        del out
    rec["param_count"] = cfg.param_count()
    rec["param_bytes"] = tree_bytes(params)
    rec["n_devices"] = dist.get_world_size()
    return rec


def layer_units(cfg: ModelConfig) -> float:
    """Layer units of the model (the reference's scan trip count; the
    port runs every layer, so no cost is scaled by it)."""
    if cfg.block_pattern == "zamba":
        return cfg.n_layers / cfg.attn_every
    if cfg.block_pattern == "xlstm":
        return cfg.n_layers / 4
    return float(cfg.n_layers)


def with_units(cfg: ModelConfig, u: int) -> ModelConfig:
    """``cfg`` cut to ``u`` layer units."""
    if cfg.block_pattern == "zamba":
        return dataclasses.replace(cfg, n_layers=u * cfg.attn_every)
    if cfg.block_pattern == "xlstm":
        return dataclasses.replace(cfg, n_layers=4 * u)
    if cfg.block_pattern == "encdec":
        return dataclasses.replace(cfg, n_layers=u, n_encoder_layers=u)
    return dataclasses.replace(cfg, n_layers=u)


def run_cell(arch: str, shape_name: str, mesh_kind: str, mapping: str,
             cfg: ModelConfig | None = None) -> dict:
    """One cell's record: ``status`` ``OK``, ``SKIP (...)`` or ``FAIL:
    <exception>`` with its traceback. ``cfg`` overrides the arch's config
    (a layer cut)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "mapping": mapping}
    reason = skip_reason(cfg, shape)
    if reason:
        rec["status"] = reason
        return rec
    try:
        mesh = production_mesh(mesh_kind, mapping)
        t0 = time.time()
        rec.update(trace_cell(cfg, shape, mesh, multi_pod=mesh_kind == "multi"))
        rec["t_trace_s"] = round(time.time() - t0, 1)
        rec["units"] = layer_units(cfg)
        rec["status"] = "OK"
    except Exception as e:
        rec["status"] = f"FAIL: {type(e).__name__}"
        rec["error"] = traceback.format_exc()[-2000:]
    return rec


def cell_line(rec: dict) -> str:
    coll = rec.get("collectives", {}).get("total", 0)
    return (
        f"{rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:6s} "
        f"{rec['status']:8s} flops={rec.get('flops', 0):.3g} "
        f"coll={coll / 1e9:.2f}GB t={rec['t_total_s']}s"
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--mapping", default="er", choices=["er", "her", "baseline", "none"])
    ap.add_argument("--out", default="results/torch/dryrun")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)

    for arch in archs:
        cfg = get_config(arch)
        shapes = (
            [s.name for s in shapes_for(cfg)] + (
                ["long_500k"] if not cfg.subquadratic else []
            )
            if args.shape == "all"
            else args.shape.split(",")
        )
        for shape_name in shapes:
            for mesh_kind in meshes:
                fname = os.path.join(args.out, f"{arch}__{shape_name}__{mesh_kind}.json")
                if os.path.exists(fname):
                    print(f"[skip existing] {fname}")
                    continue
                t0 = time.time()
                rec = run_cell(arch, shape_name, mesh_kind, args.mapping)
                rec["t_total_s"] = round(time.time() - t0, 1)
                with open(fname, "w") as f:
                    json.dump(rec, f, indent=1)
                print(cell_line(rec), flush=True)


if __name__ == "__main__":
    main()
