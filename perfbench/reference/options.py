"""bwa-mem's options with the engine defaults of ``mem_opt_init`` (bwa's
bwamem.c), the values ``bwa mem`` runs with when no option is given: the
settings every configuration of this benchmark states.  A frozen copy, so
that a change to the program's options cannot move the yardstick.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import List

# flag bits (BwaMemAligner.java:76-84)
MEM_F_PE = 0x2
MEM_F_NOPAIRING = 0x4
MEM_F_ALL = 0x8
MEM_F_NO_MULTI = 0x10
MEM_F_NO_RESCUE = 0x20

def fill_scoring_matrix(a: int, b: int) -> List[int]:
    """5x5 scoring matrix ([EXT] bwa_fill_scmat): match a, mismatch -b, N=-1."""
    mat = []
    for i in range(4):
        for j in range(4):
            mat.append(a if i == j else -b)
        mat.append(-1)
    mat.extend([-1] * 5)
    return mat


@dataclass
class MemOptions:
    """All bwa-mem options with engine defaults ([EXT] mem_opt_init)."""

    a: int = 1  # match score
    b: int = 4  # mismatch penalty
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    pen_unpaired: int = 17
    pen_clip5: int = 5
    pen_clip3: int = 5
    w: int = 100  # band width
    zdrop: int = 100
    max_mem_intv: int = 20
    T: int = 30  # output score threshold
    flag: int = 0
    min_seed_len: int = 19
    min_chain_weight: int = 0
    max_chain_extend: int = 1 << 30
    split_factor: float = 1.5
    split_width: int = 10
    max_occ: int = 500
    max_chain_gap: int = 10000
    n_threads: int = 1
    chunk_size: int = 10000000
    mask_level: float = 0.50
    drop_ratio: float = 0.50
    xa_drop_ratio: float = 0.80
    mask_level_redun: float = 0.95
    mapq_coef_len: float = 50.0
    mapq_coef_fac: int = int(math.log(50.0))
    max_ins: int = 10000
    max_matesw: int = 50
    max_xa_hits: int = 5
    max_xa_hits_alt: int = 200
    mat: List[int] = field(default_factory=lambda: fill_scoring_matrix(1, 4))

    def refresh_matrix(self) -> "MemOptions":
        """Recompute the scoring matrix after changing a/b."""
        self.mat = fill_scoring_matrix(self.a, self.b)
        return self

    def copy(self) -> "MemOptions":
        return replace(self, mat=list(self.mat))

    @property
    def split_len(self) -> int:
        """Seed re-split threshold (bwamem.c mem_collect_intv)."""
        return int(self.min_seed_len * self.split_factor + 0.499)

    def max_gap(self, qlen: int) -> int:
        """cal_max_gap: max gap length affordable at score level for qlen.

        Memoized per options instance, keyed on every input (hot in chain
        extension pruning; safe under option mutation)."""
        key = (qlen, self.a, self.o_del, self.e_del, self.o_ins, self.e_ins, self.w)
        cache = self.__dict__.setdefault("_max_gap_cache", {})
        v = cache.get(key)
        if v is None:
            l_del = int((qlen * self.a - self.o_del) / self.e_del + 1.0)
            l_ins = int((qlen * self.a - self.o_ins) / self.e_ins + 1.0)
            v = min(max(l_del, l_ins, 1), self.w << 1)
            cache[key] = v
        return v

    @property
    def mat5(self):
        """Scoring matrix as a 5x5 int64 array, cached per mat identity."""
        import numpy as np

        cached = self.__dict__.get("_mat5")
        if cached is None or self.__dict__.get("_mat5_id") != id(self.mat):
            cached = np.asarray(self.mat, dtype=np.int64).reshape(5, 5)
            self.__dict__["_mat5"] = cached
            self.__dict__["_mat5_id"] = id(self.mat)
        return cached
