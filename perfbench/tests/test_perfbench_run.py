"""A tiny cell runs end to end on the port's CPU route against the plain
reference; its last line has the contract's keys; the comparison fails a
broken program and the control; nothing of JAX is loaded."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
from perfbench_tiny import ROOT, tiny_root

from perfbench import control, harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _run(root, workload, trace, seed=2**31 + 11):
    result = harness.run_cell(harness.load_cell(workload, root), seed, 0.5,
                              trace, device="cpu")
    assert result.pop("forbidden_modules") == []
    return result


@pytest.mark.parametrize("workload", ["tiny.pe", "tiny.se"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_is_correct_with_the_contract_keys(root, workload, trace):
    r = _run(root, workload, trace)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(r) == want
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["sampled_reads_differing"] == dict(value=0, limit=0)
    assert r["checks"]["sampled_reads_compared"]["value"] >= 8
    names = {m["name"] for m in harness.load_cell(workload, root)[
        "per_layer" if trace else "end_to_end"]}
    assert set(r["metrics"]) <= names
    if not trace:
        assert {"reads_per_s", "setup_s"} <= set(r["metrics"])
    else:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def _broken(monkeypatch, how):
    from bwamem_tpu_torch import BwaMemAligner

    inner = BwaMemAligner.align_seqs

    def align_seqs(self, seqs, *a, **k):
        out = inner(self, seqs, *a, **k)
        if how == "answer_altered":
            for recs in out:
                recs[0].__dict__["ref_start"] += 1
        elif how == "half_left_out":
            for i in range(len(out) // 2, len(out)):
                out[i] = []
        return out

    monkeypatch.setattr(BwaMemAligner, "align_seqs", align_seqs)


@pytest.mark.parametrize("how", ["answer_altered", "half_left_out"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, how):
    _broken(monkeypatch, how)
    r = _run(root, "tiny.pe", False)
    assert r["correct"] is False
    c = r["checks"]
    if how == "answer_altered":
        assert c["sampled_reads_differing"]["value"] > 0
    else:
        assert c["reads_unanswered"]["value"] == r["attempted"] // 2


def test_the_control_is_not_correct(tmp_path):
    # one megabase and 48 pairs: re-seeding changes about one read in ten
    root = tiny_root(tmp_path, genome_length=1_000_000, sample=48)
    reading = control.control_reading(harness.load_cell("tiny.pe", root),
                                      2**31 + 5, 3, "cpu")
    assert reading["reads"] == 96
    assert reading["differ"] > 0


def test_the_work_count_is_fixed_and_cached(root):
    from perfbench import check, genome as genome_mod, work
    from perfbench.reference.fm import Work

    cell = harness.load_cell("tiny.pe", root)
    cache = os.path.join(root, "perfbench", ".cache", "tiny")
    genome = genome_mod.load(cell["config"], cache)
    ref = check.reference_index(genome, "cpu")
    first = work.count(ref, cell["traffic"], genome)
    assert first == work.count(ref, cell["traffic"], genome)
    assert first["reads"] == 8 and first["extends"] > 0
    assert first["lines"] <= 2 * first["extends"]
    assert first["extends"] <= first["words"] <= 16 * first["extends"]
    assert work.cached(cache, "tiny-pe150-k10m", ref, cell["traffic"],
                       genome) == first
    assert os.path.exists(os.path.join(cache, "work.tiny-pe150-k10m.json"))
    # rows 5 and 40 share a block: one line, the count runs on to row 40
    w = Work()
    w.count_extend(5, 40)
    assert (w.lines, w.words) == (1, 3)
    w.count_extend(127, 128)
    assert (w.lines, w.words) == (3, 3 + 8 + 1)


def test_no_module_of_jax_or_the_jax_package_is_loaded(root):
    script = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from perfbench import harness\n"
        "r = harness.run_cell(harness.load_cell('tiny.pe', %r), 3, 0.3, True,"
        " device='cpu')\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps(dict(correct=r['correct'], tops=tops)))\n"
    ) % (ROOT, root)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, check=True, cwd=root)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert "bwamem_tpu_torch" in got["tops"]
    for name in harness.FORBIDDEN:
        assert name not in got["tops"]


def test_without_a_card_it_prints_nothing_and_fails():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
         "--workload", "ecoli.pe150", "--seed", str(2**31 + 1), "--seconds",
         "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
