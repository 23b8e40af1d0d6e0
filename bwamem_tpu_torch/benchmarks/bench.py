"""End-to-end alignment benchmark of the port: ONE JSON line.

    python -m bwamem_tpu_torch.benchmarks.bench [--device cuda]
        [--device-stages seed,sa_lookup,chain] [--no-device-pipeline]

The counterpart of the JAX package's root ``bench.py``, with its contract:
reads/s through the public aligner surface on the repeat-rich synthetic
reference of ``utils/synth.py`` with paired-end reads, the same ``CONFIGS``
(``BENCH_CONFIG``: ecoli, 4.6 Mbp, the default; chr20, 64 Mbp; midlen, 300-base
reads), seed 1234, sampled-SA interval 8, the index image cached in the
temporary directory, fixed PE stats, 8 warm-up pairs, ``BENCH_PAIRS`` and
``BENCH_RUNS`` (2: the better of two passes; 3 or more: the median, with the
passes printed), and the assertion that at least 95 % of the reads align.
``vs_baseline`` is the ratio against one bwa-mem CPU thread's typical
~5,000 reads/s on 150-base pairs.

Beside ``metric``, ``value``, ``unit`` and ``vs_baseline`` the line carries
the device's name and power limit (as nvidia-smi reports them), the device
stages and whether the fused device path was on, and, from the last pass, the
shares of work done on the device and the reads each budget sent to the host
(``STATS``, ``SA_STATS``, ``SEED_STATS``, ``CHAIN_STATS``, ``FUSED_STATS``).
By default every stage runs on the device through the fused path.  A pass is
timed on the host clock around ``align_seqs``, which ends with the records
on the host.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

BASELINE_READS_PER_SEC = 5000.0  # one bwa-mem thread, 150bp PE (ballpark)
SEED = 1234
SA_INTV = 8
WARM_PAIRS = 8

CONFIGS = {
    "ecoli": dict(ref_len=4_600_000, n_pairs=6000, read_len=150, isize=350),
    "chr20": dict(ref_len=64_000_000, n_pairs=6000, read_len=150, isize=350),
    "midlen": dict(ref_len=4_600_000, n_pairs=3000, read_len=300, isize=700),
}


def _card(device) -> dict:
    """The device's name and power limit, as nvidia-smi reports them."""
    import torch

    if device.type != "cuda":
        return dict(device="cpu", power_limit=None)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(device.index or 0)],
        check=True, capture_output=True, text=True).stdout.strip()
    name, _, limit = out.partition(", ")
    return dict(device=name or torch.cuda.get_device_name(device),
                power_limit=limit)


def _shares() -> dict:
    """What the last pass did where, from the port's stats objects."""
    from ..engine.extend_batch import STATS
    from ..engine.pipeline import CHAIN_STATS, SA_STATS
    from ..engine.pipeline_device import FUSED_STATS
    from ..engine.seed_device import SEED_STATS

    def ints(obj, skip=()):
        return {k: v for k, v in vars(obj).items()
                if isinstance(v, (int, float)) and k not in skip}

    fused = ints(FUSED_STATS)
    fused["seconds"] = {k: round(v, 4) for k, v in FUSED_STATS.seconds.items()}
    return dict(extend=dict(ints(STATS), device_share=STATS.device_share()),
                sa_lookup=ints(SA_STATS), seed=ints(SEED_STATS),
                chain=ints(CHAIN_STATS), fused=fused)


def _reset_stats():
    from ..engine.extend_batch import STATS
    from ..engine.pipeline import CHAIN_STATS, SA_STATS
    from ..engine.pipeline_device import FUSED_STATS
    from ..engine.seed_device import SEED_STATS

    for s in (STATS, SA_STATS, SEED_STATS, CHAIN_STATS, FUSED_STATS):
        s.reset()


def main(argv=None) -> int:
    import torch

    from .. import BwaMemAligner, BwaMemIndex, BwaMemPairEndStats
    from ..index import image
    from ..index.build import build_index
    from ..utils.fasta import Fasta, FastaContig
    from ..utils.synth import simulate_pairs, synthetic_genome

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--device-stages", default="seed,sa_lookup,chain",
                    help="comma-separated; empty for none")
    ap.add_argument("--no-device-pipeline", dest="device_pipeline",
                    action="store_false")
    args = ap.parse_args(argv)
    stages = tuple(s for s in args.device_stages.split(",") if s)
    device = torch.device(args.device)

    cfg_name = os.environ.get("BENCH_CONFIG", "ecoli")
    cfg = CONFIGS[cfg_name]
    codes = synthetic_genome(cfg["ref_len"], np.random.default_rng(SEED))
    img = os.path.join(tempfile.gettempdir(),
                       f"bench_torch_ref_{cfg_name}_{SEED}_sa{SA_INTV}.img")
    if not os.path.exists(img):
        idx = build_index(Fasta([FastaContig("chr", "", codes)]), sa_intv=SA_INTV)
        image.write_image(img + f".{os.getpid()}.tmp", idx)
        os.replace(img + f".{os.getpid()}.tmp", img)

    index = BwaMemIndex(img)
    aligner = BwaMemAligner(index, device=device, device_stages=stages,
                            device_pipeline=args.device_pipeline)
    aligner.align_pairs()
    read_len, isize = cfg["read_len"], cfg["isize"]
    aligner.set_proper_pair_end_stats(BwaMemPairEndStats.of(isize, isize // 10))
    read_rng = np.random.default_rng(SEED + 1)
    aligner.align_seqs(simulate_pairs(codes, read_rng, WARM_PAIRS,
                                      read_len=read_len, isize_mean=isize))
    n_pairs = int(os.environ.get("BENCH_PAIRS", str(cfg["n_pairs"])))
    reads = simulate_pairs(codes, read_rng, n_pairs, read_len=read_len,
                           isize_mean=isize)
    n_runs = int(os.environ.get("BENCH_RUNS", "2"))
    passes, results = [], None
    for _ in range(n_runs):
        _reset_stats()
        t0 = time.perf_counter()
        results = aligner.align_seqs(reads)
        passes.append(len(reads) / (time.perf_counter() - t0))
    rate = max(passes) if n_runs <= 2 else sorted(passes)[len(passes) // 2]
    aligned = sum(1 for r in results if r and not (r[0].sam_flag & 0x4))
    index.close()
    assert aligned >= 0.95 * len(reads), f"only {aligned}/{len(reads)} aligned"
    rec = {
        "metric": f"reads_per_sec_chip_{read_len}bp_pe_{cfg_name}",
        "value": round(rate, 2),
        "unit": "reads/s",
        "vs_baseline": round(rate / BASELINE_READS_PER_SEC, 4),
    }
    if n_runs > 2:
        rec["stat"] = f"median_of_{n_runs}"
        rec["passes"] = [round(p, 1) for p in passes]
    rec.update(_card(device), device_stages=list(stages),
               device_pipeline=bool(args.device_pipeline), reads=len(reads),
               shares=_shares())
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
