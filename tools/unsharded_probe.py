#!/usr/bin/env python3
"""Holds the unsharded FM and seeding kernels of this checkout against
those of another tree (an older commit unpacked by ``git archive``), in
one process on one NVIDIA card.

    python3 tools/unsharded_probe.py <other-tree> [--turns 5]

csrc/fmindex.cuh's index form is a template parameter of the FM and
seeding kernels (``Fm``, one table; ``FmShards``, the idx-sharded tables);
the ``Fm`` instantiation is meant to compile to the kernels as they were.
This builds the other tree's csrc/fmindex.cu and csrc/seed.cu with the same
nvcc flags into build/unsharded_probe/, prints each build's registers,
stack and spills for occ4_kernel, sa_lookup_kernel (span 128, power-of-two
interval) and collect_intv_kernel, then times the three kernels of both
builds on chip_smoke.py's chr20 tables (64 Mbp, sa_intv 8) and batch (4,000
reads: occ4 on 2^20 random rows, the SA walk of the batch's SA rows from a
cold L2, collect_intv on the batch at K = 160), in turns other, this, this,
other, each launch's output held equal across the builds.  CUDA events;
the last line is one JSON object with the medians.  Nothing of JAX is
imported.
"""
import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the genomes, the card line, the timers)

OUT = os.path.join(ROOT, "build", "unsharded_probe")
KERNELS = {"occ4": r"occ4_kernel", "sa_lookup": r"sa_lookup_kernelILi3ELb1E",
           "collect_intv": r"collect_intv_kernel"}


class _Tolerant:
    """A library whose missing entries (the sharded ones, which an older
    tree lacks) are stand-ins, so the package's bind functions apply."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        try:
            return getattr(self.lib, name)
        except AttributeError:
            return SimpleNamespace(argtypes=None, restype=None)


def _build(tree: str, name: str) -> tuple:
    """nvcc of ``tree``'s csrc/<name>.cu as cudabuild builds it: (path of
    the library, ptxas report)."""
    from bwamem_tpu_torch.utils import cudabuild

    os.makedirs(OUT, exist_ok=True)
    tag = "this" if os.path.samefile(tree, ROOT) else "other"
    lib = os.path.join(OUT, f"lib{name}-{tag}.so")
    src = os.path.join(tree, "bwamem_tpu_torch", "csrc", f"{name}.cu")
    res = subprocess.run([cudabuild.nvcc_path(), *cudabuild.ARCH_FLAGS,
                          *cudabuild.FLAGS, "-o", lib, src],
                         capture_output=True, text=True, check=True)
    return lib, res.stdout + res.stderr


def _report(log: str) -> dict:
    """Registers, stack and spill bytes of the Fm instantiation (or of the
    untemplated kernel of an older tree) of each timed kernel."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            continue
        if fn is None or "FmShards" in fn:
            continue
        for key, pat in KERNELS.items():
            if re.search(pat, fn):
                rec = out.setdefault(key, {})
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
                if m:
                    rec.update(stack=int(m.group(1)), spill_stores=int(m.group(2)))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    rec["registers"] = int(m.group(1))
    return out


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--turns", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("unsharded_probe: no CUDA card", file=sys.stderr)
        return 1
    from bwamem_tpu_torch import BwaMemIndex
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.state import device_fm
    from bwamem_tpu_torch.ops import fmindex as fmops
    from bwamem_tpu_torch.ops import seed as seedops
    from bwamem_tpu_torch.utils.encoding import seq_to_codes_batch
    from bwamem_tpu_torch.utils.synth import simulate_pairs

    card = chip_smoke._card_line()
    libs, reports = {}, {}
    for tag, tree in (("other", args.other), ("this", ROOT)):
        for name in ("fmindex", "seed"):
            path, log = _build(tree, name)
            lib = _Tolerant(ctypes.CDLL(path))
            (fmops if name == "fmindex" else seedops)._bind(lib)
            libs[(tag, name)] = lib
            reports.setdefault(tag, {}).update(_report(log))
        print(f"{tag} ({tree}): {reports[tag]}")
    dev = torch.device("cuda", 0)
    codes, img, _ = chip_smoke._synthetic_index(chip_smoke.CHR20_LEN)
    index = BwaMemIndex(img)
    fm = index._require().fm
    rng = np.random.default_rng(chip_smoke.SEED + 1)
    simulate_pairs(codes, rng, 8)
    reads = seq_to_codes_batch(simulate_pairs(codes, rng, chip_smoke.CHR20_PAIRS))
    dfm = device_fm(fm, dev)
    params = seedops.SeedParams.from_opt(MemOptions())
    q, ql = seedops.pad_reads(reads, dev)
    rows = seedops.seed_sa(dfm, q, ql, params).ks
    k = torch.from_numpy(np.random.default_rng(7).integers(
        -1, fm.seq_len + 1, 1 << 20)).to(dev)
    B, M = len(reads), seedops.M_SLOTS
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    outs = {}

    def cases():
        occ = torch.empty((k.numel(), 4), dtype=torch.int32, device=dev)
        pos = torch.empty_like(rows)
        so = (torch.zeros((B, M, 5), dtype=torch.int64, device=dev),
              *(torch.zeros(B, dtype=torch.int32, device=dev) for _ in range(2)),
              torch.zeros(B, dtype=torch.int64, device=dev))
        return {"occ4": (lambda: fmops.occ4_launch(dfm, k, occ, flags), occ),
                "sa_lookup": (lambda: fmops.sa_lookup_launch(dfm, rows, pos,
                                                             flags), pos),
                "collect_intv": (lambda: seedops.collect_intv_launch(
                    dfm, q, ql, params, M, seedops.K_MAX, *so, flags), so[0])}

    times = {(t, n): [] for t in ("other", "this") for n in KERNELS}
    for _ in range(args.turns):
        for tag in ("other", "this", "this", "other"):
            fmops._lib = lambda tag=tag: libs[(tag, "fmindex")]
            seedops._lib = lambda tag=tag: libs[(tag, "seed")]
            for name, (fn, out) in cases().items():
                timer = chip_smoke._cold_ms if name == "sa_lookup" else \
                    chip_smoke._event_ms
                times[(tag, name)].append(timer(fn, 7, dev))
                ref = outs.setdefault(name, out.clone())
                if not torch.equal(out, ref):
                    raise AssertionError(f"{tag}'s {name} differs")
    if int(flags.item()):
        raise AssertionError(f"kernel flags {int(flags.item())}")
    index.close()
    med = {f"{t}_{n}_ms": statistics.median(v) for (t, n), v in times.items()}
    for name in KERNELS:
        a, b = med[f"other_{name}_ms"], med[f"this_{name}_ms"]
        print(f"{name}: other {a:.4f} ms, this {b:.4f} ms (x{b / a:.3f}; "
              f"{2 * args.turns} launches of each in turns) [{card}]")
    print(json.dumps(dict(card=card, reports=reports, **med,
                          runs={f"{t}_{n}": v for (t, n), v in times.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
