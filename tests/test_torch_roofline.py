"""The port's roofline (``repro_torch.figures.roofline``) against the
reference's ``benchmarks/roofline.py``: ``analyze_record`` on synthetic
records equals the reference's once the reference module's three TPU
constants are monkeypatched, in this test only, to the port's H100
datasheet constants (the reference's file is not edited). Then the port's
``load_all``/``run`` and the figure runner over a directory of dry-run
records."""

import importlib
import json
import sys
from pathlib import Path

import pytest

from repro_torch.figures import roofline as R

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))   # the reference's benchmarks/ is not a package
REF = importlib.import_module("benchmarks.roofline")

RECORDS = [
    {"arch": "dbrx-132b", "shape": "decode_32k", "mesh": "single", "status": "OK",
     "n_devices": 256, "flops": 2.1e12, "bytes_accessed": 3.3e11,
     "argument_size_in_bytes": 28_000_000_000, "temp_size_in_bytes": 1_500_000_000,
     "collectives": {"all-to-all": 1.2e8, "all-reduce": 2.0e7, "total": 1.4e8},
     "units": 40.0},
    {"arch": "llama3.2-1b", "shape": "prefill_32k", "mesh": "multi", "status": "OK",
     "n_devices": 512, "flops": 2.05e14, "bytes_accessed": 4.0e13,
     "argument_size_in_bytes": 2_500_000_000, "temp_size_in_bytes": 37_000_000_000,
     "collectives": {"total": 0.0}, "units": 16.0},
    {"arch": "mixtral-8x22b", "shape": "long_500k", "mesh": "single", "status": "OK",
     "n_devices": 256, "flops": 1.5e11, "bytes_accessed": 9.0e10,
     "collectives": {"all-reduce": 9.0e7, "total": 9.0e7}, "units": 56.0,
     # a reference-style record with layer probes: the extrapolation
     "probe1": {"flops": 1e9, "bytes_accessed": 2e9, "collectives": {"total": 1e6}},
     "probe2": {"flops": 3e9, "bytes_accessed": 3e9, "collectives": {"total": 3e6}}},
    {"arch": "qwen2-72b", "shape": "train_4k", "mesh": "single", "status": "OK",
     "n_devices": 256, "flops": 1e16, "bytes_accessed": 1e14,
     "collectives": {"total": 5e10}, "units": 80.0},
]


@pytest.fixture
def h100_reference(monkeypatch):
    monkeypatch.setattr(REF, "PEAK_FLOPS", 989e12)
    monkeypatch.setattr(REF, "HBM_BW", 3.35e12)
    monkeypatch.setattr(REF, "ICI_BW", 50e9)
    return REF


def test_constants_are_the_h100_datasheet():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 50e9)
    text = Path(R.__file__).read_text()
    assert "197e12" not in text and "819e9" not in text and "ICI" not in text
    assert "datasheet" in R.__doc__ and "not measurements" in R.__doc__


@pytest.mark.parametrize("rec", RECORDS, ids=lambda r: f"{r['arch']}/{r['shape']}")
def test_analyze_record_matches_reference(h100_reference, rec):
    got = R.analyze_record(dict(rec))
    assert got == h100_reference.analyze_record(dict(rec))
    assert got["t_step_s"] == max(got["t_compute_s"], got["t_memory_s"],
                                  got["t_collective_s"])


def test_skip_and_fail_records(h100_reference):
    for status in ("SKIP (zamba under a mesh: ROADMAP Queue 1 item 6)", "FAIL: X"):
        rec = {"arch": "zamba2-1.2b", "shape": "train_4k", "mesh": "single",
               "status": status}
        assert R.analyze_record(rec) is None is h100_reference.analyze_record(rec)


def test_run_over_dry_run_records(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert R.run() == []
    d = tmp_path / "results" / "torch" / "dryrun"
    d.mkdir(parents=True)
    skip = {"arch": "xlstm-350m", "shape": "decode_32k", "mesh": "single",
            "status": "SKIP (xlstm under a mesh: ROADMAP Queue 1 item 6)"}
    for i, rec in enumerate(RECORDS + [skip]):
        (d / f"{i}.json").write_text(json.dumps(rec))
    rows = R.run()
    assert [r["name"] for r in rows] == [
        f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}" for r in RECORDS]
    md = (tmp_path / R.ROOFLINE_MD).read_text()
    assert "ROADMAP Queue 1 item 6" in md and md.count("\n") == 2 + len(RECORDS) + 1
    from repro_torch.figures import run

    assert run.main(["roofline"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived" and len(lines) == 1 + len(RECORDS)
