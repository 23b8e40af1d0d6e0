"""Times of the collect_intv kernel on one NVIDIA card against its K budget,
the batch size and the read order, and the serial time of single reads.

    python -m bwamem_tpu_torch.benchmarks.seed_timing [--length N] [--pairs N]

The reads are those of chip_smoke.py's phase 4: simulated 150 bp pairs
(numpy seed 1235, after 8 warm-up pairs) from the synthetic genome of numpy
seed 1234, indexed with a sampled-SA interval of 8 (by default the 4.6 Mbp
genome and 6,000 pairs).  Each time is the mean of 10 launches between two
CUDA events after a warm-up, on operands prepared once.  The kernel counts
its own work per read (``ops.seed.collect_intv_launch``'s ``work``), which
gives the bwt_extend calls per read and the slowest lane's share of each
32-read warp.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

SEED = 1234


def _event_ms(fn, reps: int, dev) -> float:
    fn()  # warm-up
    torch.cuda.synchronize(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize(dev)
    return a.elapsed_time(b) / reps


def _collect_ms(dfm, params, reads, K: int):
    """ms of one collect_intv launch on ``reads`` with K slots; the
    kernel's work counters [B, 5] and overflow flags [B]."""
    from ..ops import fmindex as fmops
    from ..ops import seed as so

    dev = dfm.device
    qseq, qlen = so.pad_reads(reads, dev)
    B = len(reads)
    rows = torch.zeros((B, so.M_SLOTS, 5), dtype=torch.int64, device=dev)
    n, ovf = (torch.zeros(B, dtype=torch.int32, device=dev) for _ in range(2))
    nks = torch.zeros(B, dtype=torch.int64, device=dev)
    work = torch.zeros((B, 5), dtype=torch.int32, device=dev)
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    ms = _event_ms(lambda: so.collect_intv_launch(
        dfm, qseq, qlen, params, so.M_SLOTS, K, rows, n, ovf, nks, flags, work),
        10, dev)
    fmops._raise_flags("collect_intv", flags)
    return ms, work.cpu().numpy(), ovf.cpu().numpy()


def _warp_ratio(ext: np.ndarray) -> float:
    """Sum over 32-read warps of the slowest lane's bwt_extend calls over
    the sum of their mean."""
    w = ext[: len(ext) // 32 * 32].reshape(-1, 32)
    return float(w.max(1).sum() / w.mean(1).sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--length", type=int, default=4_600_000)
    ap.add_argument("--pairs", type=int, default=6000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("seed_timing: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from ..api.options import MemOptions
    from ..engine.fmindex import FMIndex
    from ..index.build import build_index
    from ..ops import seed as so
    from ..ops.fmindex import DeviceFMIndex
    from ..utils.encoding import seq_to_codes_batch
    from ..utils.fasta import Fasta, FastaContig
    from ..utils.synth import simulate_pairs, synthetic_genome

    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"device: {card}")
    codes = synthetic_genome(args.length, np.random.default_rng(SEED))
    fm = FMIndex(build_index(Fasta([FastaContig("chr", "", codes)]), sa_intv=8))
    rng = np.random.default_rng(SEED + 1)
    simulate_pairs(codes, rng, 8)
    batch = simulate_pairs(codes, rng, args.pairs)
    reads = [np.asarray(c, np.uint8) for c in seq_to_codes_batch(batch)]
    dfm = DeviceFMIndex.from_host(fm, dev)
    params = so.SeedParams.from_opt(MemOptions())
    print(f"{len(reads)} reads of {args.length} bp genome")

    for K in (so.K_SLOTS, 64, so.K_MAX):
        ms, w, ovf = _collect_ms(dfm, params, reads, K)
        print(f"K={K}: {ms:.4f} ms, flagged {int(ovf.sum())}, bwt_extend calls "
              f"{int(w[:, 2].sum())}")
    ext = w[:, 2].astype(np.int64)
    print("bwt_extend calls per read: mean {:.1f}, p50/p90/p99 {}, max {}".format(
        ext.mean(), np.percentile(ext, [50, 90, 99]).tolist(), int(ext.max())))
    order = np.argsort(ext, kind="stable")
    ms_sorted, _, _ = _collect_ms(dfm, params, [reads[i] for i in order], so.K_MAX)
    print(f"K={so.K_MAX}, reads sorted by bwt_extend calls: {ms_sorted:.4f} ms "
          f"(batch order {ms:.4f} ms); slowest lane over mean per warp: batch "
          f"order {_warp_ratio(ext):.3f}, sorted {_warp_ratio(ext[order]):.3f}")
    for nb in sorted({n for n in (1000, 3000, len(reads) // 2) if n < len(reads)}
                     | {len(reads)}):
        ms_b, _, _ = _collect_ms(dfm, params, reads[:nb], so.K_MAX)
        print(f"B={nb}: {ms_b:.4f} ms")
    for tag, i in (("slowest", int(np.argmax(ext))),
                   ("median", int(order[len(order) // 2]))):
        ms1, _, _ = _collect_ms(dfm, params, [reads[i]], so.K_MAX)
        print(f"{tag} read alone ({ext[i]} bwt_extend calls): {ms1:.4f} ms, "
              f"{ms1 * 1e3 / ext[i]:.3f} us per call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
