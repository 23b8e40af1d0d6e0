#!/usr/bin/env python3
"""Times bwamem_tpu_torch's chain_kernel (csrc/chain.cu) on single synthetic
reads that isolate its steps, on one NVIDIA card.

    python3 tools/chain_step_probe.py

Each read is laid out as the seed table of a batch of one (no index: the
seeds are given, on a 4 Mbp one-contig reference) and run alone, so its
time is its warp's chain of dependent steps:

* "merge1": n seeds that all join one chain (the merge path: predecessor
  search, test_and_merge, weight update; one chain to filter);
* "new_disjoint": n seeds that each open a chain (the insertion too), with
  query spans apart (the filter's shadowing finds no overlap);
* "new_overlap": the same over one query span (every chain overlaps every
  earlier one, none is dropped);
* "one_interval": n seeds of one interval, a chain each.

Times are the kernel's device time under torch.profiler (mean of 20
launches); CUDA events around the same launches are printed beside them,
since for a launch this small they time the host's call.  The last line is
one JSON object.  Nothing of JAX is imported.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the card line and the timing helpers)

L_PAC = 4_000_000


def seeds(kind: str, n: int):
    """(intervals as (x0, x1, s, qb, qe), reference starts per interval)."""
    if kind == "merge1":
        return ([(0, 0, 1, 10 * k, 10 * k + 30) for k in range(n)],
                [[1000 + 10 * k] for k in range(n)])
    if kind == "new_disjoint":
        return ([(0, 0, 1, 40 * k, 40 * k + 30) for k in range(n)],
                [[1000 + 20_000 * k] for k in range(n)])
    if kind == "new_overlap":
        return ([(0, 0, 1, k % 5, 100 + k % 5) for k in range(n)],
                [[1000 + 20_000 * k] for k in range(n)])
    if kind == "one_interval":
        return [(0, 0, n, 0, 30)], [[1000 + 20_000 * k for k in range(n)]]
    raise KeyError(kind)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chain_step_probe: no CUDA card", file=sys.stderr)
        return 1
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.index.build import BntAnn, Bntseq
    from bwamem_tpu_torch.ops import chain as co
    from bwamem_tpu_torch.utils import chain_cases

    dev = torch.device("cuda", 0)
    card = chip_smoke._card_line()
    print(f"card: {card}")
    bns = Bntseq(l_pac=L_PAC, anns=[BntAnn(offset=0, name="c", length=L_PAC)])
    ctg = co.DeviceContigs.from_host(bns, dev)
    params = co.ChainParams.from_opt(MemOptions())

    def run(ivs, rbs, qlen):
        tab = co.SeedTable.from_numpy(dev, *chain_cases.seed_table(
            [ivs], [[np.asarray(r, np.int64) for r in rbs]], [qlen]))
        tab, cnt, off = co.prepare(ctg, tab)
        T = int(cnt.sum())
        i32, i64 = torch.int32, torch.int64
        assign, slot_dst = (torch.empty(T, dtype=i32, device=dev)
                            for _ in range(2))
        crec = torch.empty((T, 5), dtype=i32, device=dev)
        n_chain, n_seed = (torch.zeros(1, dtype=i64, device=dev)
                           for _ in range(2))
        ovf, nslots = (torch.zeros(1, dtype=i32, device=dev) for _ in range(2))
        frac = torch.empty(1, dtype=torch.float64, device=dev)
        err = torch.zeros(1, dtype=i32, device=dev)
        order = co.read_order(cnt)

        def launch():
            co.chain_launch(ctg, tab, off, params, co.C_MAX, order, assign,
                            slot_dst, crec, n_chain, n_seed, frac, ovf,
                            nslots, err)

        ev = chip_smoke._event_ms(launch, 20, dev)
        ms = chip_smoke._device_ms(launch, 20, dev, "chain_kernel")
        if int(err.item()) or int(ovf.item()):
            raise AssertionError("the probe's read raised a flag")
        return ms, ev, int(nslots.item()), int(n_chain.item())

    base, base_ev, _, _ = run([(0, 0, 1, 0, 30)], [[1000]], 400)
    print(f"one seed: {base * 1e3:.2f} us on the card ({base_ev * 1e3:.2f} us "
          "by events)")
    out = {"card": card, "one_seed_us": base * 1e3, "reads": []}
    for kind in ("merge1", "new_disjoint", "new_overlap", "one_interval"):
        for n in ((32, 128, 1024, 4096) if kind == "merge1"
                  else (32, 64, 96, 128)):
            ivs, rbs = seeds(kind, n)
            ms, ev, slots, chains = run(ivs, rbs, 40 * n + 200)
            per = (ms - base) * 1e3 / (n - 1)
            print(f"{kind:13s} n={n:5d}: {ms * 1e3:9.2f} us on the card "
                  f"({ev * 1e3:9.2f} by events), {slots} chains, {chains} out; "
                  f"{per:.3f} us a seed past the first")
            out["reads"].append(dict(kind=kind, seeds=n, us=ms * 1e3,
                                     events_us=ev * 1e3, chains=slots,
                                     us_per_seed=per))
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
