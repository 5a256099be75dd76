"""The port's dry run (``repro_torch.launch.dryrun``) on a fake world of
eight ranks (a 2 x 4 ``("data", "model")`` mesh), mirroring the
reference's ``test_dryrun_machinery_small_mesh``
(``tests/test_multidevice.py``): llama3.2-1b at 2 layers and dbrx-132b's
``smoke()``, decode and prefill, traced on fake tensors.

* the cost record: FLOPs, temp and collective bytes above 0 (tensor
  parallelism gives every cell collectives);
* ``argument_size_in_bytes`` equal to the analytic bytes of rank 0's
  slices: its parameters (the expert slot rows of EP and the
  tensor-parallel slices: its query heads, its KV heads or a copy of
  one, its block of the dense MLP, its vocab rows and columns), its dense
  cache shard and its batch rows;
* llama's tensor parallelism: rank 0's parameter bytes equal to the sum
  of its slices of the full leaves, and each cell's collective calls and
  bytes as the layout predicts (per layer the all-reduce after ``wo``
  and after ``w_down``, the K/V rows all-gathered for the cache; the
  embedding's all-reduce and the logits' all-gather);
* the EP all-to-all's operand bytes equal to ``ep_moe_shardmap``'s static
  buffers, and the call counts;
* FLOPs of the dense model's decode against its matmuls;
* llama's ``train_4k`` cell (one train step with remat, gradients on):
  its arguments are exactly rank 0's parameters, two fp32 moments, the
  step and its batch rows, and its FLOPs at least three times its
  forward's;
* the recurrent and enc-dec families' one-token cells at full width
  traced ``OK``, zamba2's and seamless's ``decode_32k`` with the bytes
  and collectives their layout predicts (the Mamba2 heads, the shared
  block, the encoder and the decoder split over the model axis), the
  full-attention ``long_500k`` cell still ``SKIP``; the CLI's file per
  cell;
* the time-loop probe: FLOPs, bytes accessed and collectives of a
  prefill and a train step of zamba (a trailing Mamba2 layer, heads split
  over the model axis) and xlstm equal to a trace of every step.

The reference's dry run is not imported here: it sets ``XLA_FLAGS`` when
imported. Its config helpers are held in ``test_torch_configs_shapes.py``.
"""

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, ShapeConfig, get_config, smoke
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding
from repro_torch.parallel.collectives import bucket_capacity

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the layout's tensor-parallel prediction)

torch.set_num_threads(1)
DATA, MODEL = 2, 4
CELLS = {"decode": ShapeConfig("d", 256, 8, "decode"),
         "prefill": ShapeConfig("p", 256, 8, "prefill")}
MODELS = {"llama3.2-1b": lambda: dataclasses.replace(get_config("llama3.2-1b"), n_layers=2),
          "dbrx-smoke": lambda: smoke(get_config("dbrx-132b"))}


@pytest.fixture(scope="module")
def records():
    D.fake_world(DATA * MODEL)
    mesh = make_test_mesh(DATA, MODEL)
    out = {(m, c): D.trace_cell(make(), shape, mesh)
           for m, make in MODELS.items() for c, shape in CELLS.items()}
    cfg, shape = MODELS["llama3.2-1b"](), SHAPES["train_4k"]
    out[("llama3.2-1b", "train")] = D.trace_cell(cfg, shape, mesh)
    ctx = D.make_ctx(mesh, shape.global_batch)
    with FakeTensorMode():
        params = sharding.rank_params(T.init_params(cfg, dtype=D.PARAM_DTYPE, device="cpu"),
                                      cfg, ctx)
        tokens = torch.zeros((shape.global_batch // DATA, shape.seq_len), dtype=torch.int32)
        _, out[("llama3.2-1b", "forward")] = D.analyze(
            lambda p, t: T.forward(p, t, cfg, ctx), params, tokens)
    dist.destroy_process_group()
    return out


def _tp_dims(cfg, m: int) -> tuple[int, int, int, int]:
    """``(query heads, KV heads, dense hidden dim, vocab)`` rank 0 holds:
    each split m ways where it divides (the KV heads: a copy of one when m
    is a multiple of them)."""
    h, k = cfg.n_heads, cfg.n_kv_heads
    if h % m == 0 and (k % m == 0 or m % k == 0):
        h, k = h // m, (k // m if k % m == 0 else 1)
    f = cfg.d_ff // m if cfg.d_ff % m == 0 else cfg.d_ff
    v = cfg.vocab_size // m if cfg.vocab_size % m == 0 else cfg.vocab_size
    return h, k, f, v


def _param_bytes(cfg, m: int) -> int:
    """Rank 0's parameters (bf16; the router fp32): its query heads and
    their rows of ``wo``, its KV heads, its block of a dense MLP, E / m
    experts, its vocab rows of ``embed`` and columns of ``lm_head``; the
    norms and the router whole."""
    d, hd = cfg.d_model, cfg.head_dim_
    h, k, f, v = _tp_dims(cfg, m)
    layer = 2 * d + d * h * hd + 2 * d * k * hd + h * hd * d
    if cfg.is_moe:
        layer += cfg.n_experts // m * 3 * d * cfg.moe_d_ff_ + 2 * d * cfg.n_experts
    else:
        layer += 3 * d * f
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    return 2 * (emb + d + cfg.n_layers * layer)


@pytest.mark.parametrize("cell", tuple(CELLS))
@pytest.mark.parametrize("model", tuple(MODELS))
def test_cost_record(records, model, cell):
    rec = records[(model, cell)]
    cfg, shape = MODELS[model](), CELLS[cell]
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["temp_size_in_bytes"] > 0
    assert rec["n_devices"] == DATA * MODEL
    assert rec["param_count"] == cfg.param_count()
    b = shape.global_batch // DATA
    params = _param_bytes(cfg, MODEL)
    assert rec["param_bytes"] == params
    if cell == "decode":
        cache = 2 * cfg.n_layers * b * (shape.seq_len // MODEL) * cfg.n_kv_heads \
            * cfg.head_dim_ * 2
        assert rec["argument_size_in_bytes"] == params + cache + b * 4
        assert rec["output_size_in_bytes"] == cache + b * cfg.vocab_size * 2
    else:
        assert rec["argument_size_in_bytes"] == params + b * shape.seq_len * 4
    coll = rec["collectives"]
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    assert coll["total"] > 0


@pytest.mark.parametrize("cell", tuple(CELLS))
def test_ep_all_to_all_bytes_are_the_static_buffers(records, cell):
    """Per layer the padded branch ships the (ep, spd, cap, d) buckets out
    and back and the (ep, spd) int32 fills once: three all-to-alls. The
    prefill's all-gathers: per layer the sequence gathered back over the
    model group and the K/V rows of every KV head for the cache (each rank
    projects a copy of one of the 2), then the logits' vocab columns."""
    cfg, shape = MODELS["dbrx-smoke"](), CELLS[cell]
    rec = records[("dbrx-smoke", cell)]
    b = shape.global_batch // DATA
    n = b if cell == "decode" else b * shape.seq_len // MODEL
    cap = bucket_capacity(n, cfg.experts_per_token, 1.25, cfg.n_experts)
    buckets = cfg.n_experts * cap * cfg.d_model * 2
    want = cfg.n_layers * (2 * buckets + cfg.n_experts * 4)
    assert rec["collectives"]["all-to-all"] == want
    assert rec["collective_calls"]["all-to-all"] == 3 * cfg.n_layers
    if cell == "prefill":
        assert rec["collective_calls"]["all-gather"] == 2 * cfg.n_layers + 1


def test_dense_decode_flops(records):
    """llama's decode: the matmuls of 4 rows a rank on its tensor-parallel
    slices (its 8 query heads and 2 KV heads, its quarter of the MLP and
    of the logits' columns) plus the attention scores and values of all
    32 heads over the rank's 64 cache slots, 2 flops a multiply-add."""
    cfg, shape = MODELS["llama3.2-1b"](), CELLS["decode"]
    b, t = shape.global_batch // DATA, shape.seq_len // MODEL
    d, hd = cfg.d_model, cfg.head_dim_
    h, k, f, v = _tp_dims(cfg, MODEL)
    assert (h, k, f, v) == (8, 2, cfg.d_ff // 4, cfg.vocab_size // 4)
    per_layer = d * h * hd + 2 * d * k * hd + h * hd * d + 3 * d * f \
        + 2 * cfg.n_heads * t * hd
    want = 2 * b * (cfg.n_layers * per_layer + d * v)
    assert records[("llama3.2-1b", "decode")]["flops"] == want


def _leaf_bytes(tree, prefix=""):
    """``{path: bytes}`` of a tree's tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_bytes(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree.numel() * tree.element_size()}


@pytest.mark.parametrize("cell", tuple(CELLS))
def test_llama_tensor_parallel_slices_and_collectives(records, cell):
    """llama3.2-1b at 2 layers on the 2 x 4 mesh (H = 32, K = 8 split 4
    ways): rank 0's parameter bytes are the sum of its tensor-parallel
    slices (``tp_layout``) and of the whole other leaves, a quarter of the
    attention, the MLP and the vocab; its collectives are the layout's.
    Per layer: one all-reduce after ``wo``, one after ``w_down``, and the
    K/V rows of all 8 KV heads all-gathered for the cache (the rank
    projects 2), in one call; decode also all-gathers ``q``'s heads for
    the sequence split and LSE-merges with three all-reduces (the max,
    the weighted values, the weights). Once: the embedding's all-reduce
    and the logits' all-gather. The operand bytes follow (bf16; the
    merge's max and weights fp32; an all-reduce counts twice)."""
    cfg, shape = MODELS["llama3.2-1b"](), CELLS[cell]
    rec = records[("llama3.2-1b", cell)]
    D.fake_world(DATA * MODEL)
    try:
        ctx = D.make_ctx(make_test_mesh(DATA, MODEL), shape.global_batch)
        layout = sharding.tp_layout(cfg, ctx)
        with FakeTensorMode():
            full = _leaf_bytes(T.init_params(cfg, dtype=D.PARAM_DTYPE, device="cpu"))
    finally:
        dist.destroy_process_group()
    assert set(layout) == {"embed", *(f"layers/attn/w{n}" for n in "qkvo"),
                           *(f"layers/mlp/w_{n}" for n in ("gate", "up", "down"))}
    assert all(isinstance(part, slice) for _, part in layout.values())
    mine = sum(b // MODEL if path in layout else b for path, b in full.items())
    assert rec["param_bytes"] == mine == _param_bytes(cfg, MODEL)
    assert mine * MODEL < 2 * sum(full.values())
    d, hd, L, b = cfg.d_model, cfg.head_dim_, cfg.n_layers, shape.global_batch // DATA
    h, k, _, v = _tp_dims(cfg, MODEL)
    s = 1 if cell == "decode" else shape.seq_len
    act = b * s * d * 2                                # one (b, s, d) bf16 activation
    kv = 2 * b * s * k * hd * 2                        # the rank's K and V rows
    reduce = (2 * L + 1) * 2 * act
    gather = L * kv + b * v * 2                        # the logits at the last position
    calls = {"all-reduce": 2 * L + 1, "all-gather": L + 1}
    if cell == "decode":
        g = cfg.n_heads // cfg.n_kv_heads
        calls = {"all-reduce": 5 * L + 1, "all-gather": 2 * L + 1}
        gather += L * b * h * hd * 2                   # q's heads
        reduce += L * 2 * b * cfg.n_heads * (4 + hd * 2 + 4)
        assert g == 4
    assert rec["collective_calls"] == calls
    assert rec["collectives"]["all-reduce"] == reduce
    assert rec["collectives"]["all-gather"] == gather


def test_train_cell_arguments_and_flops(records):
    """Rank 0's train state and batch rows are the step's arguments, byte
    for byte: its bf16 parameters, two fp32 moments of them, the int32
    step, and 128 rows of 4096 int32 tokens and labels. The backward's
    products (two a forward product, and the forward recomputed under
    remat) put the step's FLOPs at three times the forward's or more."""
    cfg, shape = MODELS["llama3.2-1b"](), SHAPES["train_4k"]
    rec = records[("llama3.2-1b", "train")]
    params = _param_bytes(cfg, MODEL)
    assert rec["param_bytes"] == params
    rows = shape.global_batch // DATA
    assert rec["argument_size_in_bytes"] == \
        params + 2 * 2 * params + 4 + 2 * rows * shape.seq_len * 4
    assert rec["flops"] >= 3 * records[("llama3.2-1b", "forward")]["flops"] > 0
    assert rec["temp_size_in_bytes"] > 0 and rec["n_devices"] == DATA * MODEL
    # the data-parallel gradient average and the clip norm's sum
    assert rec["collective_calls"]["all-reduce"] > 0


def test_skips_name_their_roadmap_item():
    """The families' one-token cells trace at full width on the 16 x 16
    mesh (no ``SKIP`` naming item 6 is left). zamba2's and seamless's
    ``decode_32k`` rank 0 holds the layout's tensor-parallel slices of
    the shared block, the encoder and the decoder, and counts exactly the
    layout's collectives and bytes (``chip_smoke.tp_prediction``, which
    phase 3i (d) holds the card's dry run to):
    zamba2 two all-reduces a Mamba2 layer, five a unit and one for the
    embedding, two all-gathers a unit and one for the logits. A
    full-attention model's ``long_500k`` cell is still skipped."""
    try:
        recs = {arch: D.run_cell(arch, shape, "single", "er")
                for arch, shape in (("zamba2-1.2b", "decode_32k"), ("xlstm-350m", "long_500k"),
                                    ("seamless-m4t-medium", "decode_32k"))}
        for rec in recs.values():
            assert rec["status"] == "OK", rec
            assert rec["flops"] > 0 and rec["argument_size_in_bytes"] > 0
        for arch in ("zamba2-1.2b", "seamless-m4t-medium"):
            want = chip_smoke.tp_prediction(get_config(arch), SHAPES["decode_32k"], 16, 16)
            got = {k: recs[arch][k] for k in want}
            got["collectives"] = {k: v for k, v in got["collectives"].items() if k != "total"}
            assert got == want, arch
        assert recs["zamba2-1.2b"]["collective_calls"] == {"all-reduce": 107, "all-gather": 13}
        assert recs["seamless-m4t-medium"]["collective_calls"] == {"all-reduce": 108,
                                                                   "all-gather": 36}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    rec = D.run_cell("qwen2-72b", "long_500k", "multi", "er")
    assert rec["status"] == "SKIP (full attention cannot fit the 524k context)"
    assert not dist.is_initialized()


def test_cli_writes_a_file_per_cell_and_skips_existing(tmp_path, capsys):
    """A file per (arch, shape, mesh) cell, the cells the CLI is given
    only (the full-attention ``long_500k`` skips, which trace nothing),
    and an existing file is kept."""
    archs = ("llama3.2-1b", "qwen2-72b")
    D.main(["--arch", ",".join(archs), "--shape", "long_500k", "--mesh", "both",
            "--out", str(tmp_path)])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == sorted(f"{a}__long_500k__{m}.json" for a in archs
                           for m in ("single", "multi"))
    rec = json.loads((tmp_path / files[0]).read_text())
    assert rec["status"].startswith("SKIP") and "t_total_s" in rec
    D.main(["--arch", "qwen2-72b", "--shape", "long_500k", "--mesh", "single",
            "--out", str(tmp_path)])
    assert "[skip existing]" in capsys.readouterr().out
    assert SHAPES["long_500k"].global_batch == 1
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ("llama3.2-1b", "zamba2-1.2b", "dbrx-132b", "xlstm-350m",
                                  "seamless-m4t-medium"))
def test_layer_units_and_with_units(arch):
    """``with_units(cfg, u)`` cuts a model to ``u`` layer units of its
    pattern, which ``layer_units`` counts back (the reference's rules)."""
    cfg = get_config(arch)
    for u in (1, 2):
        cut = D.with_units(cfg, u)
        assert D.layer_units(cut) == u
        if cfg.block_pattern == "encdec":
            assert cut.n_encoder_layers == u
    assert D.layer_units(cfg) == {"zamba": cfg.n_layers / max(cfg.attn_every, 1),
                                  "xlstm": cfg.n_layers / 4}.get(cfg.block_pattern,
                                                                 float(cfg.n_layers))


PROBED = {"zamba": lambda: dataclasses.replace(smoke(get_config("zamba2-1.2b")), d_model=128,
                                                n_layers=5),
          "xlstm": lambda: smoke(get_config("xlstm-350m"))}


@pytest.fixture
def fake_mesh():
    D.fake_world(DATA * MODEL)
    yield make_test_mesh(DATA, MODEL)
    dist.destroy_process_group()


@pytest.mark.parametrize("kind", ("prefill", "train"))
@pytest.mark.parametrize("model", tuple(PROBED))
def test_time_probe_counts_a_full_trace(fake_mesh, model, kind):
    """Three steps of every time loop, the middle one counted ``t - 2``
    times forward and backward (remat included), against a trace of all
    ``t = 9`` steps: FLOPs, bytes accessed, collective bytes and calls,
    arguments and outputs equal; the probe holds fewer temporaries live
    (three steps' outputs, not nine) or as many."""
    cfg = PROBED[model]()
    shape = ShapeConfig("t", 9, 4, kind)
    probed = D.trace_cell(cfg, shape, fake_mesh)
    full = D.trace_cell(cfg, shape, fake_mesh, probe=False)
    for k in ("flops", "bytes_accessed", "collectives", "collective_calls",
              "argument_size_in_bytes", "output_size_in_bytes"):
        assert probed[k] == full[k], k
    assert probed["temp_size_in_bytes"] <= full["temp_size_in_bytes"]
    if model == "zamba":
        assert sharding.mamba_layout(cfg, D.make_ctx(fake_mesh, 4))
        assert full["collective_calls"]["all-reduce"] >= 2 * cfg.n_layers
