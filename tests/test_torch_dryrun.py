"""The port's dry run (``repro_torch.launch.dryrun``) on a fake world of
eight ranks (a 2 x 4 ``("data", "model")`` mesh), mirroring the
reference's ``test_dryrun_machinery_small_mesh``
(``tests/test_multidevice.py``): llama3.2-1b at 2 layers and dbrx-132b's
``smoke()``, decode and prefill, traced on fake tensors.

* the cost record: FLOPs, temp and collective bytes above 0 where the
  port has collectives (a dense model computes every prefill layer whole
  on each rank, so its prefill has none);
* ``argument_size_in_bytes`` equal to the analytic bytes of rank 0's
  slices: its parameters (the expert slot rows of EP), its dense cache
  shard and its batch rows;
* the EP all-to-all's operand bytes equal to ``ep_moe_shardmap``'s static
  buffers, and the call counts;
* FLOPs of the dense model's decode against its matmuls;
* llama's ``train_4k`` cell (one train step with remat, gradients on):
  its arguments are exactly rank 0's parameters, two fp32 moments, the
  step and its batch rows, and its FLOPs at least three times its
  forward's;
* a recurrent pattern's cells (a train cell too) recorded as ``SKIP``
  naming its ROADMAP item, never ``FAIL``; the CLI's file per cell.

The reference's dry run is not imported here: it sets ``XLA_FLAGS`` when
imported. Its config helpers are held in ``test_torch_configs_shapes.py``.
"""

import dataclasses
import json

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


def _param_bytes(cfg, m: int) -> int:
    """Rank 0's parameters: everything whole but the experts, of which it
    keeps E / m (bf16; the router fp32)."""
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    layer = 2 * d + d * h * hd + 2 * d * k * hd + h * hd * d
    if cfg.is_moe:
        layer += cfg.n_experts // m * 3 * d * cfg.moe_d_ff_ + 2 * d * cfg.n_experts
    else:
        layer += 3 * d * cfg.d_ff
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
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
    if model == "llama3.2-1b" and cell == "prefill":
        assert coll["total"] == 0
    else:
        assert coll["total"] > 0


@pytest.mark.parametrize("cell", tuple(CELLS))
def test_ep_all_to_all_bytes_are_the_static_buffers(records, cell):
    """Per layer the padded branch ships the (ep, spd, cap, d) buckets out
    and back and the (ep, spd) int32 fills once: three all-to-alls."""
    cfg, shape = MODELS["dbrx-smoke"](), CELLS[cell]
    rec = records[("dbrx-smoke", cell)]
    b = shape.global_batch // DATA
    n = b if cell == "decode" else b * shape.seq_len // MODEL
    cap = bucket_capacity(n, cfg.experts_per_token, 1.25, cfg.n_experts)
    buckets = cfg.n_experts * cap * cfg.d_model * 2
    want = cfg.n_layers * (2 * buckets + cfg.n_experts * 4)
    assert rec["collectives"]["all-to-all"] == want
    assert rec["collective_calls"]["all-to-all"] == 3 * cfg.n_layers
    if cell == "prefill":   # the sequence gathered back over the model group
        assert rec["collective_calls"]["all-gather"] == cfg.n_layers


def test_dense_decode_flops(records):
    """llama's decode: the matmuls of 4 rows a rank (projections, the MLP,
    the logits) plus the attention scores and values over the rank's 64
    cache slots, 2 flops a multiply-add."""
    cfg, shape = MODELS["llama3.2-1b"](), CELLS["decode"]
    b, t = shape.global_batch // DATA, shape.seq_len // MODEL
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    per_layer = d * h * hd + 2 * d * k * hd + h * hd * d + 3 * d * cfg.d_ff + 2 * h * t * hd
    want = 2 * b * (cfg.n_layers * per_layer + d * cfg.vocab_size)
    assert records[("llama3.2-1b", "decode")]["flops"] == want


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
    for arch, shape, item in (("zamba2-1.2b", "train_4k", "item 6"),
                              ("zamba2-1.2b", "decode_32k", "item 6"),
                              ("xlstm-350m", "long_500k", "item 6"),
                              ("seamless-m4t-medium", "prefill_32k", "item 6")):
        rec = D.run_cell(arch, shape, "single", "er")
        assert rec["status"].startswith("SKIP") and item in rec["status"], rec
    rec = D.run_cell("qwen2-72b", "long_500k", "multi", "er")
    assert rec["status"] == "SKIP (full attention cannot fit the 524k context)"
    assert not dist.is_initialized()


def test_cli_writes_a_file_per_cell_and_skips_existing(tmp_path, capsys):
    D.main(["--arch", "xlstm-350m", "--shape", "all", "--mesh", "both",
            "--out", str(tmp_path)])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == sorted(f"xlstm-350m__{s}__{m}.json" for s in
                           ("train_4k", "prefill_32k", "decode_32k", "long_500k")
                           for m in ("single", "multi"))
    rec = json.loads((tmp_path / files[0]).read_text())
    assert rec["status"].startswith("SKIP") and "t_total_s" in rec
    D.main(["--arch", "xlstm-350m", "--shape", "decode_32k", "--mesh", "single",
            "--out", str(tmp_path)])
    assert "[skip existing]" in capsys.readouterr().out
    assert SHAPES["long_500k"].global_batch == 1


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
