"""Seeded extension batches for holding the SW kernel against its references.

Each case is a dict of numpy arrays in the JAX package's public layout
(``qseq [B, Q]``, ``tseq [B, T]``, per-job ``qlen, tlen, h0, w, end_bonus``,
``mat [5, 5]``) plus the gap statics, so the same values feed
``bwamem_tpu``'s kernels, the port's plain version and its CUDA kernel.
"""
from __future__ import annotations

import numpy as np

from ..api.options import fill_scoring_matrix

DEFAULT = dict(a=1, b=4, o_del=6, e_del=1, o_ins=6, e_ins=1, zdrop=100)
# non-default scoring: a=2, b=5, deletions and insertions priced apart
SKEWED = dict(a=2, b=5, o_del=5, e_del=2, o_ins=7, e_ins=1, zdrop=60)


def _related(rng, B, Q, T, qlen, tlen, err):
    """Targets, and queries copied from their heads with substitutions and
    a few indels, so extensions run long as they do on real reads."""
    tseq = rng.integers(0, 4, (B, T)).astype(np.int32)
    qseq = rng.integers(0, 4, (B, Q)).astype(np.int32)
    for b in range(B):
        src = tseq[b, : max(int(tlen[b]), 1)]
        if rng.random() < 0.3 and len(src) > 8:  # an indel in the copy
            p = int(rng.integers(1, len(src) - 4))
            k = int(rng.integers(1, 4))
            src = (np.delete(src, range(p, p + k)) if rng.random() < 0.5 else
                   np.insert(src, p, rng.integers(0, 4, k)))
        n = min(int(qlen[b]), len(src))
        qseq[b, :n] = src[:n]
        flip = rng.random(n) < err
        qseq[b, :n][flip] = (qseq[b, :n][flip] + 1 + rng.integers(0, 3, flip.sum())) % 4
    return qseq, tseq


def make_case(name: str) -> dict:
    """Cases: ``square`` and ``ragged`` (the JAX Pallas tests' shapes and
    draws), ``main`` (a 150 bp main-path wave: B=4096, Q=192, T=512),
    ``edges`` (padding jobs with tlen=0, qlen=1, N codes, w=1, end bonus),
    ``zdrop0`` and ``skewed`` (non-default scoring)."""
    sc = dict(DEFAULT)
    if name in ("square", "ragged"):
        B, Q, T = (128, 128, 160) if name == "square" else (37, 61, 93)
        rng = np.random.default_rng(0 if name == "square" else 1)
        qseq = rng.integers(0, 4, (B, Q)).astype(np.int32)
        tseq = rng.integers(0, 4, (B, T)).astype(np.int32)
        qlen = rng.integers(1, Q + 1, B).astype(np.int32)
        tlen = rng.integers(1, T + 1, B).astype(np.int32)
        h0 = rng.integers(1, 60, B).astype(np.int32)
        ws = [3, 10, 100, 400] if name == "square" else [3, 10, 100]
        w = rng.choice(ws, B).astype(np.int32)
        bonus = rng.choice([0, 5], B).astype(np.int32)
    else:
        seed, B, Q, T = {"main": (11, 4096, 192, 512), "edges": (12, 96, 40, 64),
                         "zdrop0": (13, 64, 80, 120),
                         "skewed": (14, 64, 80, 120)}[name]
        rng = np.random.default_rng(seed)
        qlen = rng.integers(1, Q + 1, B).astype(np.int32)
        tlen = rng.integers(0, T + 1, B).astype(np.int32)
        qseq, tseq = _related(rng, B, Q, T, qlen, tlen, err=0.04)
        h0 = rng.integers(1, 160, B).astype(np.int32)
        w = rng.choice([1, 5, 100, 200], B).astype(np.int32)
        bonus = rng.choice([0, 5], B).astype(np.int32)
        if name == "edges":
            pad = slice(0, 8)  # padding jobs, as the JAX wave loop adds them
            qlen[pad], tlen[pad], h0[pad] = 0, 0, 0
            qlen[8:24] = 1
            w[24:40] = 1
            bonus[40:56] = 9
            for a in (qseq, tseq):  # ambiguous bases
                a[rng.random(a.shape) < 0.05] = 4
        elif name == "zdrop0":
            sc["zdrop"] = 0
        elif name == "skewed":
            sc = dict(SKEWED)
    mat = np.asarray(fill_scoring_matrix(sc["a"], sc["b"]),
                     dtype=np.int32).reshape(5, 5)
    return dict(qseq=qseq, tseq=tseq, qlen=qlen, tlen=tlen, h0=h0, w=w,
                end_bonus=bonus, mat=mat,
                statics=dict(o_del=sc["o_del"], e_del=sc["e_del"],
                             o_ins=sc["o_ins"], e_ins=sc["e_ins"],
                             zdrop=sc["zdrop"], max_sc=int(mat.max())))


ARRAYS = ("qseq", "tseq", "qlen", "tlen", "h0", "w", "end_bonus", "mat")
CASES = ("square", "ragged", "main", "edges", "zdrop0", "skewed")


def jobs(case: dict):
    """The case as an extension wave's job lists: ([(qseq, tseq)], h0s, ws,
    bonuses) with each sequence cut to its length, as uint8."""
    out = [(case["qseq"][b, : case["qlen"][b]].astype(np.uint8),
            case["tseq"][b, : case["tlen"][b]].astype(np.uint8))
           for b in range(len(case["qlen"]))]
    return out, case["h0"].tolist(), case["w"].tolist(), case["end_bonus"].tolist()
