"""The control of the comparison that decides ``correct``: the plain
reference with one guarantee of the configuration broken, put in the
program's place, must come out as not correct.

    python3 perfbench/control.py --workload <name> --seeds <n> [<n> ...]
        [--batches <window's batches>]

The configuration states bwa mem's default seeding, whose second round
re-seeds every SMEM of at least ``split_len`` bases with at most
``split_width`` occurrences from its middle.  The control skips that round
(``split_factor`` so large that no SMEM qualifies): the saving a change to
the seeding kernels would be tempted by.  For each seed the control draws
the run's batches and its sample as a run of the cell does (a window of
``--batches`` batches), aligns the sampled reads with the control and with
the reference, and prints the reads whose records differ: the number a
run compares against the limit 0.  Only the sampled reads are aligned:
they are all that the comparison reads.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def control_options(traffic: dict):
    from .check import options

    return dataclasses.replace(options(traffic), split_factor=1e9)


def control_reading(cell: dict, seed: int, batches: int, device: str) -> dict:
    """Reads of the sample whose control records differ from the
    reference's, for one seed."""
    from . import check, genome as genome_mod, traffic as traffic_mod
    from .reference.records import Engine, align_batch

    cfg, tr = cell["config"], cell["traffic"]
    cache = os.path.join(cell["root"], "perfbench", ".cache", cfg["name"])
    genome = genome_mod.load(cfg, cache)
    pool = traffic_mod.make_pool(tr, genome, seed)
    per = 2 if tr["paired"] else 1
    sample = check.Sample(tr["sample"], seed, tr["paired"])
    drawn = {}
    for b in range(batches):
        for slot, u in sample.draw(len(pool[b % len(pool)]) // per):
            drawn[slot] = (b % len(pool), u)
    ref = check.reference_index(genome, device)
    eng, pes = Engine(ref), check.pe_stats(tr)
    for slot, (pool_no, u) in drawn.items():
        codes = list(pool[pool_no].codes[per * u: per * (u + 1)])
        sample.slots[slot] = (pool_no, u, align_batch(
            check.options(tr), eng, codes, [u], pes))
    bad = check.compare(sample, pool, ref, tr, opt=control_options(tr))
    return dict(seed=seed, reads=bad["reads"], differ=bad["differ"])


def main(argv=None) -> int:
    from .harness import load_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        r = control_reading(cell, seed, args.batches, args.device)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(dict(workload=args.workload, **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from perfbench.control import main as _main

    sys.exit(_main())
