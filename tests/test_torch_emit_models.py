"""Numpy models of the two kernels redesigned for Hopper in this slice, held
exactly against the serial code they replace and the port's oracles.

* ``chain_emit_kernel`` (csrc/chain.cu), a warp per read: chain rows a lane
  a chain in 16-byte stores (``store_row7``); the seeds 32 at a time in
  enumeration order, a lane a seed found by the window search, placed at
  its slot's first place (``slot_dst``, read only) plus the slot's seeds
  placed by earlier batches (a count per slot in shared memory, advanced
  once a batch by the slot's highest lane) plus its rank among the batch's
  lanes of the same slot (``__match_any_sync``).  Against the serial emit
  pass (a thread walks the seeds and advances ``slot_dst`` in place) and
  the host oracle's chains, on ``chain_cases.warp_table`` reads (the count
  pass's scratch from ``test_torch_wave_models.chain_model``) and on
  random tables.
* The SA walk's step (csrc/fmindex.cuh ``lf_line``): the whole line in
  16-byte vectors, the char's word picked by selects, the count of the
  char among chars [0, pos] from every word with a mask (all of a word
  before the char's, the first pos % 16 + 1 chars of its own, none after).
  Against ``ops/fmindex.py`` ``_lf`` on random lines at every offset.
* ``sa_lookup_torch`` against the host ``FMIndex.sa_lookup`` and the JAX
  package's ``sa_lookup`` at sampled intervals 1, 5, 8 and 32 (5 takes the
  kernel's division path), and the wrapper's choice of path.

Nothing on the port's path imports these models.  Integers; tolerance 0.
"""
import dataclasses

import numpy as np
import pytest
import torch

from bwamem_tpu_torch.api.options import MemOptions
from bwamem_tpu_torch.ops import fmindex as fmops
from bwamem_tpu_torch.utils import chain_cases
from test_torch_wave_models import _bns, _oracle_chains, chain_model

LANES = 32
C_MAX = 128  # csrc/chain.cu kMaxC
M55 = 0x55555555
U32 = 0xFFFFFFFF


# ------------------------------------------------------------ the emit pass

def _popc(x: int) -> int:
    return bin(x).count("1")


def serial_emit(seeds, assign, slot_dst, n_seed):
    """The emit pass as one thread a read runs it: the seeds in enumeration
    order, each to its slot's next place, the place advanced in place."""
    out = [None] * n_seed
    nxt = list(slot_dst)
    for t, seed in enumerate(seeds):
        s = assign[t]
        if s < 0 or nxt[s] < 0:
            continue
        out[nxt[s]] = seed
        nxt[s] += 1
    return out


def warp_emit(cnt, seeds_of, assign, slot_dst, n_seed, events=None):
    """``emit_read``'s seed half on one read: windows of 32 intervals
    (counts ``cnt``, the seeds of interval r ``seeds_of[r]``), batches of 32
    seeds, a lane a seed.  ``slot_dst`` is only read.  ``events`` (a dict)
    gets per batch the live lanes' slots."""
    ev = events if events is not None else {}
    ev.setdefault("batches", [])
    placed = [0] * C_MAX  # the warp's shared memory
    out = [None] * n_seed
    tw = 0
    for w0 in range(0, len(cnt), LANES):
        win = list(cnt[w0:w0 + LANES]) + [0] * (LANES - len(cnt[w0:w0 + LANES]))
        inc = np.cumsum(win)
        excl = inc - np.asarray(win)
        total = int(inc[-1])
        for s0 in range(0, total, LANES):
            lanes = []
            for lane in range(LANES):
                rel = s0 + lane
                k = 0
                for step in (16, 8, 4, 2, 1):  # seed_interval
                    if excl[k + step] <= rel:
                        k += step
                s = d = -1
                seed = None
                if rel < total:
                    seed = seeds_of[w0 + k][rel - excl[k]]
                    s = assign[tw + rel]
                    if s >= 0:
                        d = slot_dst[s]
                live = s >= 0 and d >= 0
                lanes.append((live, s if live else -1, d, seed))
            # __match_any_sync on the slot (-1 for the lanes that write nothing)
            same = [sum(1 << m for m, o in enumerate(lanes) if o[1] == key)
                    for _, key, _, _ in lanes]
            before = [placed[s] if live else 0 for live, s, _, _ in lanes]
            for lane, (live, s, d, seed) in enumerate(lanes):  # after __syncwarp
                if not live:
                    continue
                if lane == same[lane].bit_length() - 1:
                    placed[s] = before[lane] + _popc(same[lane])
                at = d + before[lane] + _popc(same[lane] & ((1 << lane) - 1))
                assert out[at] is None, "two seeds to one place"
                out[at] = seed
            ev["batches"].append([s for live, s, _, _ in lanes if live])
        tw += total
    return out


def store_row7(mem, at, row):
    """``store_row7`` into int64 memory ``mem`` at element ``at``: 16-byte
    pair stores at even elements (the row's first element alone when it
    starts at an odd one), the last element alone otherwise."""
    pairs = ([(at, 0), (at + 2, 2), (at + 4, 4)] if at % 2 == 0
             else [(at + 1, 1), (at + 3, 3), (at + 5, 5)])
    singles = [(at + 6, 6)] if at % 2 == 0 else [(at, 0)]
    for a, j in pairs:
        assert a % 2 == 0
        mem[a:a + 2] = row[j:j + 2]
    for a, j in singles:
        mem[a] = row[j]


def _flat_seeds(ivs, rbs):
    """Per interval its seeds as the emit pass writes them (rbeg, qbeg,
    len, score = len), and the counts."""
    seeds_of = [[(int(r), p[3], p[4] - p[3], p[4] - p[3]) for r in rb]
                for p, rb in zip(ivs, rbs)]
    return [len(s) for s in seeds_of], seeds_of


@pytest.fixture(scope="module")
def warp_reads():
    names, ivs, rbs, qlens = chain_cases.warp_table(np.random.default_rng(5))
    bns = _bns()
    ends = np.array([a.offset + a.length for a in bns.anns], np.int64)
    alts = np.array([a.is_alt for a in bns.anns], np.int64)
    return names, ivs, rbs, qlens, bns, ends, alts


@pytest.mark.parametrize("opts", ({}, {"min_chain_weight": 30,
                                       "max_chain_extend": 3}),
                         ids=("default", "weight30_extend3"))
def test_emit_model_matches_serial_and_oracle_on_warp_reads(warp_reads, opts):
    """Every ``warp_table`` read: the warp emit pass places every seed where
    the serial pass does, and the rows are the oracle's chains' seeds in
    output order; the chain rows land whole at either alignment."""
    names, ivs, rbs, qlens, bns, ends, alts = warp_reads
    opt = MemOptions(**opts)
    seen = {"no_chains": 0, "dropped_chain": 0, "many_chains": 0}
    mem = np.full(7 * 200, -7, np.int64)
    for name, iv, rb, qlen in zip(names, ivs, rbs, qlens):
        ev = {}
        chains = chain_model(opt, ends, alts, bns.l_pac, qlen, iv, rb,
                             events=ev)
        exp = _oracle_chains(opt, bns, qlen, iv, rb)
        if chains is None:  # flagged by C: no emit pass
            assert name == "c129"
            continue
        assert chains == exp, name
        if not chains:
            seen["no_chains"] += 1
            continue
        seen["dropped_chain"] += -1 in ev["slot_dst"]
        seen["many_chains"] += len(ev["slot_dst"]) == C_MAX
        cnt, seeds_of = _flat_seeds(iv, rb)
        n_seed = sum(len(c[6]) for c in chains)
        ser = serial_emit([s for ss in seeds_of for s in ss], ev["assign"],
                          ev["slot_dst"], n_seed)
        got = warp_emit(cnt, seeds_of, ev["assign"], ev["slot_dst"], n_seed)
        assert got == ser, name
        assert [g[:3] for g in got] == [s for c in chains for s in c[6]], name
        # chain rows, a lane a chain, at an even and an odd first row
        for c0 in (0, 1):
            mem[:] = -7
            rows = [[c[0], c[1], len(c[6]), 0, c[3], c[4], c[5]] for c in chains]
            for j, row in enumerate(rows):
                store_row7(mem, (c0 + j) * 7, np.asarray(row, np.int64))
            assert (mem[7 * c0: 7 * (c0 + len(rows))].reshape(-1, 7)
                    == np.asarray(rows)).all(), name
            assert (mem[:7 * c0] == -7).all()
            assert (mem[7 * (c0 + len(rows)):] == -7).all()
    assert seen["no_chains"] >= 2 and seen["many_chains"] == 1
    assert seen["dropped_chain"] >= 1


def _random_table(rng, kind):
    """A read's intervals and the count pass's scratch (assign, slot_dst,
    emitted seeds) for one kind of read."""
    if kind == "spread32":  # one batch of 32 seeds over 32 slots
        cnt = [1] * 32
        assign = list(rng.permutation(32))
    elif kind == "one_chain":  # 100 seeds of one chain, one interval of 70
        cnt = [70, 0, 30]
        assign = [0] * 100
    elif kind == "all_dropped":
        cnt = list(rng.integers(0, 5, 20))
        assign = [-1] * sum(cnt)
    elif kind == "c128":
        cnt = list(rng.integers(1, 4, 150))
        assign = list(rng.integers(0, 128, sum(cnt)))
    else:  # "random": some seeds dropped, uneven intervals past 32 of them
        cnt = list(rng.integers(0, 40, int(rng.integers(1, 80))))
        nslot = int(rng.integers(1, 129))
        assign = list(np.where(rng.random(sum(cnt)) < 0.15, -1,
                               rng.integers(0, nslot, sum(cnt))))
    nslot = max([s + 1 for s in assign] + [1])
    used = np.bincount([s for s in assign if s >= 0], minlength=nslot)
    # the filter drops some chains; the rest are emitted in a shuffled order
    drop = rng.random(nslot) < (0.3 if kind in ("random", "c128") else 0.0)
    slot_dst = [-1] * nslot
    pos = 0
    for s in rng.permutation(nslot):
        if not drop[s]:
            slot_dst[s] = pos
            pos += int(used[s])
    seeds_of, k = [], 0
    for n in cnt:
        seeds_of.append([(1000 * (k + r), 7 * k, 20 + r, 20 + r)
                         for r in range(n)])
        k += n
    return cnt, seeds_of, [int(a) for a in assign], slot_dst, pos, drop


@pytest.mark.parametrize("kind", ("spread32", "one_chain", "all_dropped",
                                  "c128", "random"))
def test_emit_model_matches_serial_on_random_tables(kind):
    rng = np.random.default_rng(["spread32", "one_chain", "all_dropped",
                                 "c128", "random"].index(kind))
    for _ in range(20 if kind == "random" else 3):
        cnt, seeds_of, assign, slot_dst, n_seed, drop = _random_table(rng, kind)
        ev = {}
        got = warp_emit(cnt, seeds_of, assign, slot_dst, n_seed, events=ev)
        flat = [s for ss in seeds_of for s in ss]
        assert got == serial_emit(flat, assign, slot_dst, n_seed)
        assert None not in got
        # each emitted slot's seeds fill [slot_dst, + its count) in
        # enumeration order
        for s, d in enumerate(slot_dst):
            mine = [flat[t] for t, a in enumerate(assign) if a == s]
            if d >= 0:
                assert got[d: d + len(mine)] == mine
        live = [b for b in ev["batches"] if b]
        if kind == "spread32":
            assert [len(set(b)) for b in live] == [32]
        if kind == "one_chain":
            assert [len(b) for b in live] == [32, 32, 32, 4]
            assert all(len(set(b)) == 1 for b in live)
        if kind == "all_dropped":
            assert got == [] and not live
        if kind in ("random", "c128"):
            assert drop.any()


# ------------------------------------------------------- the SA walk's step

def lf_line_model(lines, L2, primary, span, k):
    """``lf_line`` on one row k: the line's NV 16-byte vectors as u32
    words, the char's word by selects, the masked popcounts."""
    words = span // 16
    kk = max(k - (k >= primary), 0)
    line = [int(x) & U32 for x in lines[kk // span]]
    counts, w = line[:4], line[4:4 + words]
    pos = kk & (span - 1)
    wi = pos >> 4
    x = w[0]
    for j in range(1, words):  # the select chain
        x = w[j] if j == wi else x
    c = (x >> (30 - 2 * (pos & 15))) & 3
    fh = 0 if c & 2 else M55
    fl = 0 if c & 1 else M55
    last = ((U32 << (30 - 2 * (pos & 15))) & U32) & M55
    n = 0
    for j in range(words):
        keep = M55 if j < wi else (last if j == wi else 0)
        hi = ((w[j] >> 1) & M55) ^ fh
        lo = (w[j] & M55) ^ fl
        n += _popc(hi & lo & keep)
    nk = int(L2[c]) + counts[c] + n
    return 0 if k == primary else nk


@pytest.mark.parametrize("span", (128, 256, 512))
def test_line_decode_model_matches_lf_at_every_offset(span):
    rng = np.random.default_rng(span)
    nb = 3
    W = 4 + span // 16
    lines = rng.integers(0, 1 << 32, (nb, W), dtype=np.uint64)
    lines[:, :4] = rng.integers(0, 1 << 20, (nb, 4))
    seq_len = nb * span - 1
    primary = span + 37
    L2 = np.concatenate([[0], np.sort(rng.integers(0, seq_len, 3)), [seq_len]])
    dfm = fmops.DeviceFMIndex(
        lines=torch.from_numpy(lines.astype(np.uint32).view(np.int32)),
        L2=torch.from_numpy(L2.astype(np.int64)),
        sa=torch.zeros(1, dtype=torch.int64), primary=primary,
        seq_len=seq_len, sa_intv=8, span=span)
    ks = np.arange(seq_len + 1)  # every offset of every line, primary too
    ref = fmops._lf(dfm, torch.from_numpy(ks)).numpy()
    got = [lf_line_model(lines, L2, primary, span, int(k)) for k in ks]
    assert got == ref.tolist()


# --------------------------------------------- the walk at other intervals

def _fm_pair(sa_intv):
    """The port's and the JAX package's host FMIndex of one genome with
    sampled interval ``sa_intv`` (build_bwt takes any interval;
    build_index only powers of two)."""
    from bwamem_tpu.engine.fmindex import FMIndex as JaxFM
    from bwamem_tpu.index import build as jb
    from bwamem_tpu.utils.fasta import Fasta as JFasta, FastaContig as JContig
    from bwamem_tpu_torch.engine.fmindex import FMIndex
    from bwamem_tpu_torch.index import build as tb
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig

    rng = np.random.default_rng(91)
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    codes[1500:1800] = codes[100:400]
    out = []
    for build, fasta, contig, fmc in ((tb, Fasta, FastaContig, FMIndex),
                                      (jb, JFasta, JContig, JaxFM)):
        idx = build.build_index(fasta([contig("c", "", codes)]), sa_intv=8)
        if sa_intv != 8:
            idx = dataclasses.replace(idx, bwt=build.build_bwt(codes, sa_intv))
        out.append(fmc(idx))
    return out


@pytest.mark.parametrize("sa_intv", (1, 5, 8, 32))
def test_sa_lookup_matches_host_and_jax_at_any_interval(sa_intv):
    from bwamem_tpu.ops import fmindex_tpu as ft

    fm, jfm = _fm_pair(sa_intv)
    assert fm.sa_intv == jfm.sa_intv == sa_intv
    rng = np.random.default_rng(sa_intv)
    rows = np.concatenate([[0, 1, fm.primary - 1, fm.primary, fm.primary + 1,
                            fm.seq_len - 1, fm.seq_len],
                           rng.integers(0, fm.seq_len + 1, 1500)]).astype(np.int64)
    dfm = fmops.DeviceFMIndex.from_host(fm, "cpu")
    got = fmops.sa_lookup_torch(dfm, torch.from_numpy(rows)).numpy()
    assert np.array_equal(got, fm.sa_lookup(rows))
    assert np.array_equal(got, jfm.sa_lookup(rows))
    ref = ft.DeviceFMIndex.from_host(jfm)
    assert np.array_equal(got, np.asarray(ft.sa_lookup(ref, rows)))
    # the kernel's path: mask and shift for a power of two, else division
    assert dfm.sa_shift == {1: 0, 5: -1, 8: 3, 32: 5}[sa_intv]
    assert dfm.L2_values == tuple(int(v) for v in fm.L2)
