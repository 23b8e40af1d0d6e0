"""A tiny copy of the benchmark for its CPU tests: the harness, a genome of a
few hundred kilobases and batches of a few hundred reads, in a temporary
root that holds its own ``BENCHMARK.json``."""
from __future__ import annotations

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {
    "tiny.pe": ("ecoli-k12", "pe150-k10m"),
    "tiny.se": ("ecoli-k12", "se150-k10m"),
}


def tiny_root(tmp, genome_length=300_000, batch_bases=30_000, sample=8,
              pool_batches=2) -> str:
    """A copy of ``perfbench/`` and ``BENCHMARK.json`` under ``tmp`` with
    the cells ``tiny.pe`` and ``tiny.se`` added, as a later change would add
    them: new files and new entries only."""
    root = str(tmp)
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(ROOT, "perfbench/configs/ecoli-k12.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny"
    cfg["genome"]["length"] = genome_length
    with open(os.path.join(root, "perfbench/configs/tiny.json"), "w") as f:
        json.dump(cfg, f)
    spec["configs"].append(dict(name="tiny", source="https://example.org",
                                file="perfbench/configs/tiny.json",
                                reduced=["length"], why="CPU tests"))
    for name, (_, traffic) in TINY.items():
        with open(os.path.join(ROOT, f"perfbench/traffic/{traffic}.json")) as f:
            tr = json.load(f)
        tr.update(batch_bases=batch_bases, pool_batches=pool_batches,
                  warmup_batches=1, warmup_staged_reads=8, sample=sample,
                  work_sample=4)
        with open(os.path.join(root, f"perfbench/traffic/tiny-{traffic}.json"),
                  "w") as f:
            json.dump(tr, f)
        spec["workloads"].append(dict(name=name, config="tiny",
                                      traffic=f"tiny-{traffic}", chips=1,
                                      why="CPU tests"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + list(TINY)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root
