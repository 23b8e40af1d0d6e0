"""Numpy models of the two kernels redesigned for Hopper in this slice, held
exactly against the serial code they replace and the plain versions.

* ``chain2aln_prep_kernel`` (csrc/chain2aln.cu ``prep_chain``), a chain a
  warp: the warp takes the chain's seeds 32 at a time, each lane computes
  its seed's span (``cal_max_gap`` in float64) and its rank in the stable
  (score, index) order against the chain's scores staged 256 at a time in
  shared memory; the span is a butterfly min/max over the lanes, then lane
  0 clamps it, cuts it at the strand boundary and clamps it to the first
  seed's contig.  Against the one-thread-per-chain insertion sort it
  replaces and against ``ops/pipeline_fused.py`` ``chain_windows``, on
  hand-built chains (``chain_cases.prep_table``), on random score lists and
  on the chains of ``chain_cases`` reads.
* ``sample_ks_kernel`` (csrc/seed.cu), a read a warp: the read's rows as
  one contiguous copy, each row's place among the round's SA rows an
  inclusive warp scan (``__shfl_up_sync`` steps), the round's SA rows
  written as one run a word a lane, each lane finding its row by a search
  over the scan.  Against the one-thread-per-(read, slot) arithmetic it
  replaces and ``ops/seed.py`` ``sample_ks_torch``, on random tables (rows
  at, below and past ``max_occ``; reads of 0, 1, 32, 33 and 48 rows) and
  on the intervals of ``chain_cases`` reads.

Nothing on the port's path imports these models.  Integers; tolerance 0.
"""
import numpy as np
import pytest
import torch

from bwamem_tpu_torch.api.options import MemOptions
from bwamem_tpu_torch.engine import chain as port_chain
from bwamem_tpu_torch.engine import seed as port_seed
from bwamem_tpu_torch.engine.fmindex import FMIndex
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.ops import chain as co
from bwamem_tpu_torch.ops import pipeline_fused as fo
from bwamem_tpu_torch.ops import seed as so
from bwamem_tpu_torch.utils import chain_cases, fused_cases
from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig

LANES = 32
TILE = 256  # csrc/chain2aln.cu kPrepTile: scores a warp stages at once


# ------------------------------------------------------------ the prep kernel

def serial_order(scores):
    """The seed order as one thread a chain built it: a stable insertion
    sort by score, ties in index order."""
    srt = []
    for t, sc in enumerate(scores):
        k = len(srt)
        srt.append(t)
        while k > 0 and scores[srt[k - 1]] > sc:
            srt[k] = srt[k - 1]
            k -= 1
        srt[k] = t
    return srt


def warp_order(scores):
    """The seed order as a warp builds it: rounds of 32 lanes, each lane's
    rank summed over the tiles of 256 staged scores, srt[rank] = t.  Every
    place is written once."""
    sc_all = np.asarray(scores, np.int64)
    ns, tile = len(sc_all), TILE
    srt = np.full(ns, -1, np.int64)
    for t0 in range(0, ns, LANES):
        t = np.arange(t0, min(t0 + LANES, ns))
        sc = sc_all[t]
        rank = np.zeros(len(t), np.int64)
        for u0 in range(0, ns, tile):
            staged = sc_all[u0: u0 + tile]
            k = np.arange(len(staged))
            rank += ((staged[None, :] < sc[:, None])
                     | ((staged[None, :] == sc[:, None])
                        & (k[None, :] < (t - u0)[:, None]))).sum(1)
        assert (srt[rank] == -1).all()
        srt[rank] = t
    return srt.tolist()


def _max_gap(p, x):
    l_del = int((x * p.a - p.o_del) / p.e_del + 1.0)
    l_ins = int((x * p.a - p.o_ins) / p.e_ins + 1.0)
    return min(max(l_del, l_ins, 1), p.w << 1)


def warp_prep(seeds, ql, p, l_pac, ends, offs):
    """``prep_chain`` on one chain's seed rows [ns, 4]: (rmax0, rmax1,
    srt), or None for the window when the first seed lies in no contig."""
    ns = len(seeds)
    if ns == 0:
        return 0, 0, []
    lo = [2 * l_pac] * LANES
    hi = [0] * LANES
    for t, (rbeg, qb, ln, _) in enumerate(seeds.tolist()):
        tail = ql - qb - ln
        lane = t % LANES
        lo[lane] = min(lo[lane], rbeg - (qb + _max_gap(p, qb)))
        hi[lane] = max(hi[lane], rbeg + ln + (tail + _max_gap(p, tail)))
    d = LANES >> 1
    while d:  # __shfl_xor_sync butterfly over the warp
        lo = [min(lo[i], lo[i ^ d]) for i in range(LANES)]
        hi = [max(hi[i], hi[i ^ d]) for i in range(LANES)]
        d >>= 1
    assert len(set(lo)) == 1 and len(set(hi)) == 1
    r0, r1 = max(lo[0], 0), min(hi[0], 2 * l_pac)
    srt = warp_order(seeds[:, 3])
    first = int(seeds[0, 0])
    fwd = first < l_pac
    if r0 < l_pac < r1:
        r1, r0 = (l_pac, r0) if fwd else (r1, l_pac)
    mid = first if fwd else 2 * l_pac - 1 - first
    rid = int(np.searchsorted(ends, mid, side="right"))
    if rid >= len(ends) or mid < 0:
        return None, None, srt
    fb, fe = int(offs[rid]), int(ends[rid])
    if not fwd:
        fb, fe = 2 * l_pac - fe, 2 * l_pac - fb
    return max(r0, fb), min(r1, fe), srt


def _hold_prep(ctg, chains, qlen, p=None):
    """warp_prep on every chain = chain_windows's windows and perm (mapped
    to indices within the chain) = the serial insertion sort."""
    p = p or fo.ExtendParams.from_opt(MemOptions())
    lay = fo._layout(chains)
    r0, r1, perm, c_of = fo.chain_windows(ctg, chains, lay, qlen, p)
    within = (perm - lay.chain_seed_off[c_of[perm]]).tolist()
    ends, offs = ctg.ctg_end.numpy(), ctg.ctg_off.numpy()
    sr = chains.seed_rows.numpy()
    for c in range(chains.chain_rows.shape[0]):
        so_, ns = int(lay.chain_seed_off[c]), int(lay.ns[c])
        seeds = sr[so_: so_ + ns]
        a, b, srt = warp_prep(seeds, int(qlen[lay.chain_read[c]]), p, ctg.l_pac,
                              ends, offs)
        assert (a, b) == (int(r0[c]), int(r1[c])), c
        assert srt == within[so_: so_ + ns] == serial_order(seeds[:, 3].tolist())
    return lay


def _warp_ctg():
    ends = np.asarray([o + n for o, n, _ in chain_cases.WARP_CONTIGS], np.int64)
    offs = np.asarray([o for o, _, _ in chain_cases.WARP_CONTIGS], np.int64)
    alts = np.asarray([a for _, _, a in chain_cases.WARP_CONTIGS], np.int32)
    return co.DeviceContigs(torch.from_numpy(ends), torch.from_numpy(alts),
                            chain_cases.WARP_L_PAC, torch.from_numpy(offs))


def _hand_chains(no_contig=False):
    names, crow, srow, n_chain, n_seed, qlen = chain_cases.prep_table(
        np.random.default_rng(31), no_contig)
    B = len(names)
    zeros = torch.zeros(B, dtype=torch.int64)
    chains = co.Chains(torch.from_numpy(crow), torch.from_numpy(srow),
                       torch.from_numpy(n_chain), torch.from_numpy(n_seed),
                       zeros, zeros.bool(), zeros.int())
    return names, chains, torch.from_numpy(qlen)


@pytest.mark.parametrize("ns", (1, 2, 31, 32, 33, 255, 256, 257, 600))
@pytest.mark.parametrize("spread", (1, 3, 1000), ids=("equal", "narrow", "wide"))
def test_rank_order_is_the_stable_insertion_sort(ns, spread):
    """The tiled rank sort gives the insertion sort's permutation, ties in
    index order, at every round (32 lanes) and tile (256 scores) edge."""
    scores = np.random.default_rng(ns * 7 + spread).integers(0, spread, ns)
    exp = serial_order(scores.tolist())
    assert exp == sorted(range(ns), key=lambda t: (scores[t], t))
    assert warp_order(scores) == exp


@pytest.mark.parametrize("kw", ({}, {"w": 7, "a": 2, "o_del": 3, "e_del": 2}),
                         ids=("default", "narrow_band"))
def test_prep_model_on_hand_built_chains(kw):
    """Ties, 1/31/32/33 seeds, two tiles and more, windows cut at the strand
    boundary on either side, a read of three chains."""
    names, chains, qlen = _hand_chains()
    p = fo.ExtendParams.from_opt(fused_cases.options(MemOptions(), kw))
    lay = _hold_prep(_warp_ctg(), chains, qlen, p)
    ns = lay.ns.tolist()
    assert max(ns) == 600 and {1, 31, 32, 33} <= set(ns)
    l_pac = chain_cases.WARP_L_PAC
    r0, r1, _, _ = fo.chain_windows(_warp_ctg(), chains, lay, qlen, p)
    k = names.index("strand_fwd")  # one chain a read up to there
    assert int(r1[k]) == l_pac and int(r0[k + 1]) == l_pac


def test_prep_model_flags_a_first_seed_in_no_contig():
    _, chains, qlen = _hand_chains(no_contig=True)
    ctg = _warp_ctg()
    lay = fo._layout(chains)
    c = chains.chain_rows.shape[0] - 1
    so_ = int(lay.chain_seed_off[c])
    seeds = chains.seed_rows[so_:].numpy()
    got = warp_prep(seeds, int(qlen[-1]), fo.ExtendParams.from_opt(MemOptions()),
                    ctg.l_pac, ctg.ctg_end.numpy(), ctg.ctg_off.numpy())
    assert got[:2] == (None, None)
    with pytest.raises(RuntimeError):
        fo.chain_windows(ctg, chains, lay, qlen,
                         fo.ExtendParams.from_opt(MemOptions()))


@pytest.fixture(scope="module")
def case_engine():
    """chain_cases' three-contig genome (the last ALT) as an index, 60 of its
    reads (both strands, repeats, N runs), their intervals by the host
    oracle's collect_intv and the SA rows of those at max_occ 500."""
    contigs = chain_cases.genome(np.random.default_rng(7))
    idx = build_index(Fasta([FastaContig(f"c{i}", "", c.copy())
                             for i, c in enumerate(contigs)]))
    idx.bns.anns[2].is_alt = 1
    fm = FMIndex(idx)
    reads = chain_cases.reads(contigs, np.random.default_rng(15), 60)
    opt = MemOptions()
    ivs = [port_seed.collect_intv(opt, fm, q) for q in reads]
    rbs = [[fm.sa_lookup(np.asarray(port_chain.sample_ks(p, opt.max_occ),
                                    np.int64)) for p in iv] for iv in ivs]
    return idx, reads, ivs, rbs


@pytest.mark.parametrize("kw", ({}, {"w": 7, "a": 2, "o_del": 3, "e_del": 2}),
                         ids=("default", "narrow_band"))
def test_prep_model_on_chain_case_reads(case_engine, kw):
    idx, reads, ivs, rbs = case_engine
    opt = fused_cases.options(MemOptions(), kw)
    tab = co.SeedTable.from_numpy(
        "cpu", *chain_cases.seed_table(ivs, rbs, [len(r) for r in reads]))
    ctg = co.DeviceContigs.from_host(idx.bns, "cpu")
    chains = co.chain_torch(ctg, tab, co.ChainParams.from_opt(opt))
    lay = _hold_prep(ctg, chains, tab.qlen, fo.ExtendParams.from_opt(opt))
    assert int(lay.ns.max()) >= 5 and int(chains.n_chain.max()) >= 2


# ------------------------------------------------------- the sample_ks kernel

def _occ(s, max_occ):
    return min(s, max_occ)


def _step(s, max_occ):
    return s // max_occ if s > max_occ and max_occ > 0 else 1


def _offsets(rows, nrows, max_occ):
    n = nrows.astype(np.int64)
    nks = np.asarray([sum(_occ(int(rows[b, j, 2]), max_occ) for j in range(n[b]))
                      for b in range(len(n))], np.int64)
    return np.cumsum(n) - n, np.cumsum(nks) - nks, int(n.sum()), int(nks.sum()), nks


def thread_sample_ks(rows, nrows, max_occ):
    """The arithmetic of one thread a (read, slot): its row to the flat
    table, its offset by re-reading the sizes of the read's earlier rows,
    its SA rows one after another."""
    B, M, _ = rows.shape
    row_off, ks_off, n_tot, ks_tot, _ = _offsets(rows, nrows, max_occ)
    flat = np.zeros((n_tot, 5), np.int64)
    ks = np.zeros(ks_tot, np.int64)
    for b in range(B):
        for j in range(M):
            if j >= nrows[b]:
                continue
            flat[row_off[b] + j] = rows[b, j]
            off = ks_off[b] + sum(_occ(int(rows[b, k, 2]), max_occ)
                                  for k in range(j))
            s = int(rows[b, j, 2])
            for k in range(_occ(s, max_occ)):
                ks[off + k] = rows[b, j, 0] + _step(s, max_occ) * k
    return flat, ks


def warp_sample_ks(rows, nrows, max_occ):
    """A read a warp of G = 32 lanes: the flat copy a word a lane, rounds of
    G rows with an inclusive ``__shfl_up_sync`` scan over the warp (a lane
    below the distance keeps its value), then the round's SA rows as one
    run a word a lane: lane l takes run place i = i0 + l, finds its row by
    the 5-step search over the lanes' inclusive counts (``__shfl_sync``
    from lane r + d - 1) and stores word i.  Every word of both outputs is
    written once."""
    G = LANES
    B, M, _ = rows.shape
    row_off, ks_off, n_tot, ks_tot, _ = _offsets(rows, nrows, max_occ)
    flat_w = np.full(n_tot * 5, -1, np.int64)
    ks = np.zeros(ks_tot, np.int64)
    hits = np.zeros(ks_tot, np.int64)
    for b in range(B):
        n = int(nrows[b])
        words = rows[b].reshape(-1)
        for k0 in range(0, 5 * n, G):
            for lane in range(G):
                k = k0 + lane
                if k < 5 * n:
                    assert flat_w[row_off[b] * 5 + k] == -1
                    flat_w[row_off[b] * 5 + k] = words[k]
        out = int(ks_off[b])
        for j0 in range(0, n, G):
            cnt, x0, step = (np.zeros(G, np.int64) for _ in range(3))
            step[:] = 1
            for lane in range(G):
                j = j0 + lane
                if j < n:
                    s = int(rows[b, j, 2])
                    cnt[lane], x0[lane] = _occ(s, max_occ), rows[b, j, 0]
                    step[lane] = _step(s, max_occ)
            incl = cnt.copy()
            d = 1
            while d < G:
                up = np.concatenate([incl[:d], incl[:-d]])  # lane - d (or own)
                incl = np.where(np.arange(G) >= d, incl + up, incl)
                d <<= 1
            excl, total = incl - cnt, int(incl[G - 1])
            for i0 in range(0, total, G):
                for lane in range(G):
                    i, r, d = i0 + lane, 0, G >> 1
                    while d:
                        if incl[r + d - 1] <= i:
                            r += d
                        d >>= 1
                    if i < total:
                        assert excl[r] <= i < incl[r]
                        ks[out + i] = x0[r] + step[r] * (i - excl[r])
                        hits[out + i] += 1
            out += total
        assert out == ks_off[b] + sum(_occ(int(rows[b, j, 2]), max_occ)
                                      for j in range(n))
    assert (hits == 1).all() and (flat_w >= 0).all()
    return flat_w.reshape(n_tot, 5), ks


def _hold_sample_ks(rows, nrows, max_occ):
    """The warp model against the one-thread arithmetic and
    sample_ks_torch."""
    flat, ks = warp_sample_ks(rows, nrows, max_occ)
    tflat, tks = thread_sample_ks(rows, nrows, max_occ)
    nks = _offsets(rows, nrows, max_occ)[4]
    pflat, pks = so.sample_ks_torch(torch.from_numpy(rows), torch.from_numpy(nrows),
                                    torch.from_numpy(nks), max_occ)
    assert np.array_equal(flat, tflat) and np.array_equal(ks, tks)
    assert np.array_equal(flat, pflat.numpy()) and np.array_equal(ks, pks.numpy())
    return flat, ks


def _random_rows(rng, nrows, M=48, max_occ=500):
    B = len(nrows)
    rows = np.zeros((B, M, 5), np.int64)
    rows[:, :, 0] = rng.integers(0, 1 << 40, (B, M))
    rows[:, :, 2] = rng.choice([1, 2, 31, 33, max_occ - 1, max_occ,
                                max_occ + 1, 2 * max_occ + 7, 100_003], (B, M))
    rows[:, :, 1] = rows[:, :, 0] + rows[:, :, 2]
    rows[:, :, 3] = rng.integers(0, 100, (B, M))
    rows[:, :, 4] = rows[:, :, 3] + rng.integers(19, 50, (B, M))
    return rows


@pytest.mark.parametrize("max_occ", (500, 7))
def test_sample_ks_model_on_random_tables(max_occ):
    """Reads of 0, 1, 32, 33, 48 and random row counts at M = 48, rows below,
    at and past max_occ (the step path)."""
    rng = np.random.default_rng(max_occ)
    nrows = np.asarray([0, 1, 32, 33, 48, 0] + rng.integers(0, 49, 10).tolist(),
                       np.int32)
    rows = _random_rows(rng, nrows, max_occ=max_occ)
    _, ks = _hold_sample_ks(rows, nrows, max_occ)
    s = rows[:, :, 2][np.arange(48)[None, :] < nrows[:, None]]
    assert (s < max_occ).any() and (s == max_occ).any() and (s > max_occ).any()
    assert len(ks) > 0


def test_sample_ks_model_on_empty_batches():
    for nrows in (np.zeros(0, np.int32), np.zeros(5, np.int32)):
        rows = np.zeros((len(nrows), 48, 5), np.int64)
        flat, ks = _hold_sample_ks(rows, nrows, 500)
        assert flat.shape == (0, 5) and ks.shape == (0,)


@pytest.mark.parametrize("max_occ", (500, 3))
def test_sample_ks_model_on_chain_case_reads(case_engine, max_occ):
    """The intervals bwa's collect_intv finds on chain_cases reads (repeat
    copies among them), at M = 48 and at max_occ 3 (many rows past it)."""
    _, reads, ivs, _ = case_engine
    M = so.M_SLOTS
    nrows = np.asarray([len(iv) if len(iv) <= M else 0 for iv in ivs], np.int32)
    rows = np.zeros((len(reads), M, 5), np.int64)
    for b, iv in enumerate(ivs):
        if nrows[b]:
            rows[b, :nrows[b]] = np.asarray([tuple(p) for p in iv], np.int64)
    flat, ks = _hold_sample_ks(rows, nrows, max_occ)
    k = 0
    for b, iv in enumerate(ivs):  # the host oracle's sample_ks, row by row
        for p in iv[:nrows[b]]:
            exp = np.asarray(port_chain.sample_ks(p, max_occ), np.int64)
            assert np.array_equal(ks[k: k + len(exp)], exp)
            k += len(exp)
    assert k == len(ks) and int(nrows.max()) >= 4
