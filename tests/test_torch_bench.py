"""The port's bench (python -m bwamem_tpu_torch.benchmarks.bench) keeps the
contract of the JAX package's root bench.py: the same configurations and
baseline, and one JSON line with the same four leading keys; here at a tiny
size on the CPU, through the fused path's plain versions."""
import importlib.util
import json
import os

import pytest

from bwamem_tpu_torch.benchmarks import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_bench():
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_configs_and_baseline_are_the_references():
    ref = _root_bench()
    assert bench.CONFIGS == ref.CONFIGS
    assert bench.BASELINE_READS_PER_SEC == ref.BASELINE_READS_PER_SEC


@pytest.mark.parametrize("runs", ("2", "3"))
def test_bench_prints_one_json_line(monkeypatch, capsys, tmp_path, runs):
    monkeypatch.setitem(bench.CONFIGS, "tiny", dict(
        ref_len=100_000, n_pairs=8, read_len=150, isize=350))
    monkeypatch.setenv("BENCH_CONFIG", "tiny")
    monkeypatch.setenv("BENCH_RUNS", runs)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert list(rec)[:4] == ["metric", "value", "unit", "vs_baseline"]
    assert rec["metric"] == "reads_per_sec_chip_150bp_pe_tiny"
    assert rec["unit"] == "reads/s" and rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 5000.0, abs=1e-4)
    assert ("passes" in rec) == (runs == "3")
    assert rec["device"] == "cpu" and rec["device_pipeline"] is True
    assert rec["device_stages"] == ["seed", "sa_lookup", "chain"]
    fused = rec["shares"]["fused"]
    assert fused["device_reads"] + fused["host_reads"] == rec["reads"] == 16
    assert set(rec["shares"]) == {"extend", "sa_lookup", "seed", "chain", "fused"}
