"""What decides ``correct``: the window's answers, a sample of them held
against the plain reference (``perfbench/reference``), and the numbers
compared, each beside its limit.

The sample is drawn uniformly from every pair (or single read) that the
window answered, by reservoir sampling with a generator seeded from the
run's seed: each batch's records are dropped once the sampled ones are
copied out.  After the window the reference aligns the sampled reads
again, on its own index of the same genome, with the same options, the same
insert-size statistics and the same read ordinals, and every field of every
record must be equal.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .reference import pair as ref_pair
from .reference.fm import RefIndex
from .reference.options import MEM_F_PE, MemOptions
from .reference.records import RECORD_FIELDS, Engine, align_batch


def fields(records) -> List[tuple]:
    return [tuple(getattr(a, f) for f in RECORD_FIELDS) for a in records]


class Sample:
    """A uniform sample of ``size`` units (pairs, or single reads) of all
    the window's answers."""

    def __init__(self, size: int, seed: int, paired: bool):
        self.size = size
        self.rng = np.random.default_rng([seed, 1])
        self.paired = paired
        self.seen = 0
        self.slots: List[Optional[tuple]] = [None] * size

    def draw(self, m: int):
        """The next ``m`` units answered: [(slot, unit)] that enter."""
        idx = np.arange(self.seen, self.seen + m)
        self.seen += m
        j = np.where(idx < self.size, idx,
                     (self.rng.random(m) * (idx + 1)).astype(np.int64))
        return [(int(j[u]), u) for u in np.flatnonzero(j < self.size).tolist()]

    def offer(self, pool_no: int, out) -> None:
        """Batch ``pool_no`` of the pool was answered with ``out``."""
        per = 2 if self.paired else 1
        for slot, u in self.draw(len(out) // per):
            self.slots[slot] = (pool_no, u, [fields(out[per * u + r])
                                             for r in range(per)])

    def units(self):
        return [s for s in self.slots if s is not None]


def options(traffic: dict) -> MemOptions:
    opt = MemOptions()
    if traffic["paired"]:
        opt.flag |= MEM_F_PE
    return opt


def pe_stats(traffic: dict):
    """bwa's four orientations' statistics with the caller's for FR, as
    the port's ``resolve_pes`` fills them."""
    pes = ref_pair.default_pes()
    p = traffic.get("pe_stats")
    if traffic["paired"] and p:
        pes[1] = ref_pair.PeStat(low=p["low"], high=p["high"], failed=0,
                                 avg=float(p["average"]), std=float(p["std"]))
    return pes


def reference_index(genome, device) -> RefIndex:
    """The reference's index of every contig, in the configuration's order,
    its ALT contigs flagged from the configuration (``genome.alt``), as
    bwa's ``bns_restore`` flags those its ``.alt`` names."""
    ref = RefIndex(genome.contigs, device=device)
    for a in ref.anns:
        a.is_alt = int(a.name in genome.alt)
    return ref


def compare(sample: Sample, pool, ref: RefIndex, traffic: dict,
            opt: Optional[MemOptions] = None) -> dict:
    """Reads of the sample whose records differ from the reference's (with
    ``opt`` in place of bwa's defaults, for a control), the first few of
    them, and what the reference computed."""
    opt = opt or options(traffic)
    pes = pe_stats(traffic)
    eng = Engine(ref)
    per = 2 if traffic["paired"] else 1
    reads = differ = 0
    shown = []
    for pool_no, u, got in sample.units():
        codes = pool[pool_no].codes[per * u: per * (u + 1)]
        want = align_batch(opt, eng, list(codes), [u], pes)
        for r in range(per):
            reads += 1
            if got[r] != want[r]:
                differ += 1
                if len(shown) < 3:
                    shown.append(dict(batch=pool_no, read=per * u + r,
                                      got=got[r], want=want[r]))
    return dict(reads=reads, differ=differ, shown=shown)
