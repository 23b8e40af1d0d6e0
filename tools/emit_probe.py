#!/usr/bin/env python3
"""Times bwamem_tpu_torch's chain emit pass (csrc/chain.cu
chain_emit_kernel) alone, on one NVIDIA card.

    python3 tools/emit_probe.py

On chip_smoke.py's ecoli PE batch (12,000 reads of the 4.6 Mbp synthetic
genome, seeded and walked on the card as the aligner's chain stage gets
them), after one count pass (chain_kernel): the emit pass over the whole
batch (warm, and from a cold L2, 256 MB written before each launch) and on
the read with the most seeds alone, as device time under torch.profiler;
each launch's rows held equal to the plain version's.  The emit pass's
scratch (``slot_dst``) is restored from a copy before every launch, so
that a form of the kernel that advances it in place is timed on the same
operands; an emit pass that takes no read order is called without one.
The last line is one JSON object.  Nothing of JAX is imported.
"""
import inspect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the genome, the card line, the timers)


class Pass:
    """A count pass's scratch and outputs for a table, and the emit pass
    on them."""

    def __init__(self, co, ctg, tab, params, dev):
        import torch

        self.co, self.ctg = co, ctg
        self.tab, cnt, self.off = co.prepare(ctg, tab)
        B, T = self.tab.qlen.shape[0], int(cnt.sum())
        i32, i64 = torch.int32, torch.int64
        self.order = co.read_order(cnt)
        self.assign, self.slot_dst = (torch.empty(T, dtype=i32, device=dev)
                                      for _ in range(2))
        self.crec = torch.empty((T, 5), dtype=i32, device=dev)
        self.n_chain, n_seed = (torch.zeros(B, dtype=i64, device=dev)
                                for _ in range(2))
        self.frac = torch.empty(B, dtype=torch.float64, device=dev)
        ovf, nslots = (torch.zeros(B, dtype=i32, device=dev) for _ in range(2))
        err = torch.zeros(1, dtype=i32, device=dev)
        co.chain_launch(ctg, self.tab, self.off, params, co.C_MAX, self.order,
                        self.assign, self.slot_dst, self.crec, self.n_chain,
                        n_seed, self.frac, ovf, nslots, err)
        if int(err.item()) or bool(ovf.any()):
            raise AssertionError("the count pass raised a flag")
        self.chain_off = torch.cumsum(self.n_chain, 0) - self.n_chain
        self.seed_dst = torch.cumsum(n_seed, 0) - n_seed
        self.rows = (torch.empty((int(self.n_chain.sum()), 7), dtype=i64,
                                 device=dev),
                     torch.empty((int(n_seed.sum()), 4), dtype=i64, device=dev))
        self.saved = self.slot_dst.clone()
        self.ordered = "order" in inspect.signature(
            co.chain_emit_launch).parameters

    def emit(self):
        self.slot_dst.copy_(self.saved)
        order = (self.order,) if self.ordered else ()
        self.co.chain_emit_launch(
            self.ctg, self.tab, self.off, *order, self.assign, self.slot_dst,
            self.crec, self.n_chain, self.frac, self.chain_off, self.seed_dst,
            *self.rows)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("emit_probe: no CUDA card", file=sys.stderr)
        return 1
    from bwamem_tpu_torch import BwaMemIndex
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine import pipeline
    from bwamem_tpu_torch.engine.exec_ctx import ExecConfig
    from bwamem_tpu_torch.engine.state import device_contigs
    from bwamem_tpu_torch.ops import chain as co
    from bwamem_tpu_torch.utils.encoding import seq_to_codes_batch
    from bwamem_tpu_torch.utils.synth import simulate_pairs

    dev = torch.device("cuda", 0)
    card = chip_smoke._card_line()
    print(f"card: {card}")
    codes, img, _ = chip_smoke._synthetic_index(chip_smoke.ECOLI_LEN)
    rng = np.random.default_rng(chip_smoke.SEED + 1)
    simulate_pairs(codes, rng, 8)
    reads = seq_to_codes_batch(simulate_pairs(codes, rng, chip_smoke.N_PAIRS))
    qlens = np.asarray([len(r) for r in reads], dtype=np.int32)
    opt = MemOptions()
    with BwaMemIndex(img) as index:
        eng = index._require()
        tab, _, _, _ = pipeline._device_table(opt, eng, reads, qlens, ExecConfig(
            device=dev, device_seed=True, device_sa_lookup=True,
            device_chain=True))
        ctg = device_contigs(eng.idx.bns, dev)
        params = co.ChainParams.from_opt(opt)
        plain = co.chain_torch(ctg, tab, params)
        whole = Pass(co, ctg, tab, params, dev)
        seed_cnt = plain.seed_cnt.cpu().numpy()
        top = int(np.argmax(seed_cnt))
        one = Pass(co, ctg, tab._replace(
            qlen=tab.qlen[top: top + 1], intv_off=tab.intv_off[top: top + 1],
            n_intv=tab.n_intv[top: top + 1]), params, dev)

        def ms(p, cold=False):
            return chip_smoke._device_ms(p.emit, 10, dev, "chain_emit_kernel",
                                         cold=cold)

        res = dict(card=card, reads=len(reads), seeds=int(seed_cnt.sum()),
                   chains=int(whole.n_chain.sum()),
                   seeds_out=whole.rows[1].shape[0], batch_ms=ms(whole),
                   batch_cold_ms=ms(whole, True), heaviest_seeds=int(seed_cnt[top]),
                   heaviest_chains=int(one.n_chain.sum()),
                   heaviest_ms=ms(one), heaviest_cold_ms=ms(one, True))
        err = max(chip_smoke._diff(whole.rows[0], plain.chain_rows),
                  chip_smoke._diff(whole.rows[1], plain.seed_rows))
        c0 = int(plain.n_chain[:top].sum())
        s0 = int(plain.n_seed[:top].sum())
        err = max(err, chip_smoke._diff(
            one.rows[0], plain.chain_rows[c0: c0 + one.rows[0].shape[0]]),
                  chip_smoke._diff(
            one.rows[1], plain.seed_rows[s0: s0 + one.rows[1].shape[0]]))
    print(f"emit pass on {res['reads']} reads ({res['seeds']} seeds in, "
          f"{res['chains']} chains and {res['seeds_out']} seeds out): "
          f"{res['batch_ms']:.4f} ms, {res['batch_cold_ms']:.4f} ms from a cold "
          f"L2; the read with the most seeds ({res['heaviest_seeds']} seeds, "
          f"{res['heaviest_chains']} chains) alone {res['heaviest_ms']:.4f} ms, "
          f"{res['heaviest_cold_ms']:.4f} ms cold; max|kernel-plain| {err}")
    if err:
        raise AssertionError("the emit pass disagrees with the plain version")
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
