"""Aligner options.

Python-native equivalent of the reference's options story: a `mem_opt_t`
struct exposed through ~40 fixed-offset ByteBuffer accessors
(BwaMemAligner.java:46-138) with engine defaults from [EXT] mem_opt_init.

We keep (a) the field set, defaults and `MEM_F_*` flag semantics, and (b) a
bit-exact 168-byte pack/unpack of the C struct layout documented in
SURVEY.md section 2.4 and tripwired by the reference's testOptsSize
(BwaMemIndexTest.java:38-43) — useful for interop and as an ABI-drift
golden test.
"""
from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field, replace
from typing import List

# flag bits (BwaMemAligner.java:76-84)
MEM_F_PE = 0x2
MEM_F_NOPAIRING = 0x4
MEM_F_ALL = 0x8
MEM_F_NO_MULTI = 0x10
MEM_F_NO_RESCUE = 0x20
MEM_F_REF_HDR = 0x100
MEM_F_SOFTCLIP = 0x200
MEM_F_SMARTPE = 0x400
MEM_F_PRIMARY5 = 0x800

OPTS_SIZE = 168  # BwaMemAligner.getExpectedOptsSize (BwaMemAligner.java:137)

_STRUCT = struct.Struct("<11i4xq2i3if5i5f5i25b3x")


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

    # preset equivalent to BwaMemAligner.setIntraCtgOptions
    # (BwaMemAligner.java:140-146)
    def set_intra_ctg(self) -> "MemOptions":
        self.o_del = 16
        self.o_ins = 16
        self.b = 9
        self.pen_clip5 = 5
        self.pen_clip3 = 5
        self.refresh_matrix()
        return self

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

    # ------------------------------------------------------------- C ABI

    def pack(self) -> bytes:
        """Serialize to the exact 168-byte mem_opt_t layout (SURVEY.md 2.4)."""
        vals = [
            self.a,
            self.b,
            self.o_del,
            self.e_del,
            self.o_ins,
            self.e_ins,
            self.pen_unpaired,
            self.pen_clip5,
            self.pen_clip3,
            self.w,
            self.zdrop,
            self.max_mem_intv,
            self.T,
            self.flag,
            self.min_seed_len,
            self.min_chain_weight,
            self.max_chain_extend,
            self.split_factor,
            self.split_width,
            self.max_occ,
            self.max_chain_gap,
            self.n_threads,
            self.chunk_size,
            self.mask_level,
            self.drop_ratio,
            self.xa_drop_ratio,
            self.mask_level_redun,
            self.mapq_coef_len,
            self.mapq_coef_fac,
            self.max_ins,
            self.max_matesw,
            self.max_xa_hits,
            self.max_xa_hits_alt,
            *self.mat,
        ]
        out = _STRUCT.pack(*vals)
        assert len(out) == OPTS_SIZE
        return out

    @classmethod
    def unpack(cls, raw: bytes) -> "MemOptions":
        if len(raw) != OPTS_SIZE:
            raise ValueError(f"expected {OPTS_SIZE} bytes, got {len(raw)}")
        v = _STRUCT.unpack(raw)
        return cls(
            a=v[0],
            b=v[1],
            o_del=v[2],
            e_del=v[3],
            o_ins=v[4],
            e_ins=v[5],
            pen_unpaired=v[6],
            pen_clip5=v[7],
            pen_clip3=v[8],
            w=v[9],
            zdrop=v[10],
            max_mem_intv=v[11],
            T=v[12],
            flag=v[13],
            min_seed_len=v[14],
            min_chain_weight=v[15],
            max_chain_extend=v[16],
            split_factor=v[17],
            split_width=v[18],
            max_occ=v[19],
            max_chain_gap=v[20],
            n_threads=v[21],
            chunk_size=v[22],
            mask_level=v[23],
            drop_ratio=v[24],
            xa_drop_ratio=v[25],
            mask_level_redun=v[26],
            mapq_coef_len=v[27],
            mapq_coef_fac=v[28],
            max_ins=v[29],
            max_matesw=v[30],
            max_xa_hits=v[31],
            max_xa_hits_alt=v[32],
            mat=list(v[33:58]),
        )
