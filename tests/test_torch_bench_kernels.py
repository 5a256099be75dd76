"""The port's kernel bench (``repro_torch.benchmarks.bench_kernels``)
against the reference's ``benchmarks/bench_kernels.py`` (imported as the
figure tests import the reference's figures: the repository root on
``sys.path``, since ``benchmarks/`` is not a package):

* every deterministic accounting function equal to the reference's on
  every shape of the reference's lists, smoke lists included, and the
  shape lists and model constants themselves;
* ``check_baseline("BENCH_kernels.json") == []`` (the committed file is
  read, never written), and a drifted copy of it caught;
* the ``--smoke`` run on ``--device cpu`` (the kernels' plain versions):
  every parity check passes, no kernel launches, no CUDA-event time, the
  port's tile columns beside the reference's; the default device is the
  card, which raises here.

Comparisons are exact: both sides are the same numpy arithmetic."""

import copy
import hashlib
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import bench_kernels as B

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))   # the reference's benchmarks/ is not a package
REF = importlib.import_module("benchmarks.bench_kernels")
BASELINE = ROOT / "BENCH_kernels.json"

torch.set_num_threads(1)


def test_shape_lists_and_constants_match_reference():
    for name in ("SHAPES", "SMOKE_SHAPES", "DECODE_SHAPES", "MIGRATION_SHAPES",
                 "MIGRATION_SMOKE_SHAPES", "PREFILL_SHAPES", "PREFILL_SMOKE_SHAPES",
                 "EP_CHUNK_SHAPES", "EP_CHUNK_SMOKE_SHAPES", "BM", "EP_WIRE_GBPS",
                 "EP_MODEL_TFLOPS"):
        assert getattr(B, name) == getattr(REF, name), name
    # the port's decode kernels take head dims that are multiples of 32
    (port,), (ref,) = B.DECODE_SMOKE_SHAPES, REF.DECODE_SMOKE_SHAPES
    assert port[:6] + port[7:] == ref[:6] + ref[7:] and (ref[6], port[6]) == (16, 32)


@pytest.mark.parametrize("cell", REF.SHAPES + REF.SMOKE_SHAPES, ids=lambda c: c[0])
def test_ffn_accounting_matches_reference(cell):
    counts, meta, paths = B.ffn_cell_accounting(*cell)
    want_counts, want_meta, want_paths = REF.ffn_cell_accounting(*cell)
    np.testing.assert_array_equal(counts, want_counts)
    assert meta == want_meta and paths == want_paths
    for n in (1, 5, 64, 100, 128, 1000):
        assert B._tile(n, B.BM) == REF._tile(n, REF.BM)


@pytest.mark.parametrize("cell", REF.DECODE_SHAPES + REF.DECODE_SMOKE_SHAPES,
                         ids=lambda c: c[0])
def test_decode_accounting_matches_reference(cell):
    assert B.decode_cell_accounting(*cell) == REF.decode_cell_accounting(*cell)


@pytest.mark.parametrize("cell", REF.MIGRATION_SHAPES + REF.MIGRATION_SMOKE_SHAPES,
                         ids=lambda c: c[0])
def test_migration_accounting_matches_reference(cell):
    assert B.migration_cell_accounting(*cell) == REF.migration_cell_accounting(*cell)


@pytest.mark.parametrize("cell", REF.PREFILL_SHAPES + REF.PREFILL_SMOKE_SHAPES,
                         ids=lambda c: c[0])
def test_prefill_accounting_matches_reference(cell):
    assert B.prefill_cell_accounting(*cell) == REF.prefill_cell_accounting(*cell)


@pytest.mark.parametrize("cell", REF.EP_CHUNK_SHAPES + REF.EP_CHUNK_SMOKE_SHAPES,
                         ids=lambda c: c[0])
def test_ep_chunk_accounting_matches_reference(cell):
    counts, meta, per_k = B.ep_chunk_cell_accounting(*cell)
    want_counts, want_meta, want_per_k = REF.ep_chunk_cell_accounting(*cell)
    np.testing.assert_array_equal(counts, want_counts)
    assert meta == want_meta and per_k == want_per_k


def test_check_baseline_reads_the_committed_file(tmp_path, capsys):
    digest = hashlib.sha256(BASELINE.read_bytes()).hexdigest()
    assert B.check_baseline(str(BASELINE)) == []
    B.main(["--check", str(BASELINE)])
    assert "0 mismatches" in capsys.readouterr().out
    assert hashlib.sha256(BASELINE.read_bytes()).hexdigest() == digest
    drifted = json.loads(BASELINE.read_text())
    base = copy.deepcopy(drifted)
    drifted["shapes"][0]["paths"]["gmm_fused_ffn_combine"]["hidden_hbm_mb"] = 1.0
    drifted["ep_chunk_shapes"][0]["chunks"].pop("2")
    (tmp_path / "b.json").write_text(json.dumps(drifted))
    failures = B.check_baseline(str(tmp_path / "b.json"))
    assert failures == REF.check_baseline(str(tmp_path / "b.json"))
    assert len(failures) == 2 and base != drifted
    with pytest.raises(SystemExit):
        B.main(["--check", str(tmp_path / "b.json")])


def test_port_tile_columns():
    # fp32 ragged GMM: the decode body's 8-row group at C <= 8, else 64-row tiles
    assert B.port_ffn_columns(128, 128, 256, [0, 1, 64, 65, 128], fused=False)[
        "port_exec_rows"] == 0 + 64 + 64 + 128 + 128
    assert B.port_ffn_columns(8, 16, 32, [0, 3, 8], fused=False)["port_exec_rows"] == 16
    # the fused FFN's FMA body: 16-row tiles at C <= 16
    cols = B.port_ffn_columns(16, 16, 32, [0, 5, 16], fused=True)
    assert (cols["port_row_tile"], cols["port_exec_rows"]) == (16, 32)
    assert cols["port_exec_gflop"] == round(32 * 6 * 16 * 32 / 1e9, 4)


def test_smoke_on_the_cpu_passes_parity(capsys):
    B.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("BENCH SMOKE OK")
    doc = json.loads(out[: out.rindex("BENCH SMOKE OK")])
    assert doc["backend"] == "cpu" and doc["smoke"] and doc["card"] is None
    (ffn,) = doc["shapes"]
    assert set(ffn["paths"]) == set(REF.ffn_cell_accounting(*REF.SMOKE_SHAPES[0])[2])
    for p in ffn["paths"].values():
        assert p["launches"] == {} and p["event_ms"] is None and p["wall_ms"] >= 0
    assert "port_exec_gflop" in ffn["paths"]["gmm_fused_ffn_combine"]
    assert doc["decode_shapes"][0]["paths"]["flash_decode_paged"]["launches"] == {}
    assert doc["migration_shapes"][0]["launches"] == {}
    assert doc["prefill_shapes"][0]["ttft_ticks"] == 2
    assert set(doc["ep_chunk_shapes"][0]["chunks"]) == {"1", "2"}


def test_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="cuda"):
        B.main(["--smoke"])
