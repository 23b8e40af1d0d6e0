"""Numpy models of the two kernels redesigned for Hopper in this slice, held
exactly against the port's host oracles.

* The wave kernel (csrc/extend.cu ``ksw_extend_kernel``): lane groups take
  jobs heaviest first (``ops.extend.job_order``) and write results back in
  job order; a job runs on the group DP (``ksw_extend_group``, modelled by
  ``test_torch_warp_models.warp_extend``) when ``ops.extend.warp_jobs``
  says so, else on the scalar recurrence (``engine.extend.ksw_extend2``
  stands for ``ksw_extend_core``, which computes the same).  Against
  ``engine.extend.ksw_extend2`` on every job.
* ``chain_kernel`` (csrc/chain.cu), a warp per read: seeds mapped to their
  intervals 32 at a time by a 5-step search of the window's scanned counts,
  ``bisect_right`` as popcounts of ballots over 32-lane chunks of the
  key-ordered slots, the insertion as a shift of those chunks, the weight
  sort as a rank sort, the shadowing walk as ballots with its break at the
  lowest set bit, the kept = 1 marks, the output walk as ballot prefix
  counts.  Against ``engine.chain`` ``chain_flt(mem_chain(...))`` and the
  plain version's C flag.

Nothing on the port's path imports these models.  Integers and the
oracle's double compares; tolerance 0.
"""
import numpy as np
import pytest
import torch

from bwamem_tpu_torch.api.options import MemOptions
from bwamem_tpu_torch.engine.chain import chain_flt, mem_chain
from bwamem_tpu_torch.engine.extend import ksw_extend2
from bwamem_tpu_torch.engine.seed import SmemIntv
from bwamem_tpu_torch.index.build import BntAnn, Bntseq
from bwamem_tpu_torch.ops import chain as co
from bwamem_tpu_torch.ops import extend as ext
from bwamem_tpu_torch.utils import chain_cases
from test_torch_warp_models import SCORINGS, _jobs, _mat, warp_extend

KEYS = ext.KEYS
LANES = 32


# ------------------------------------------------------------ the wave

def _oracle(job, mat, pen):
    q, t, h0, w, bonus = job
    o_del, e_del, o_ins, e_ins, zdrop = pen
    r = ksw_extend2(np.asarray(q, np.uint8), np.asarray(t, np.uint8),
                    mat.ravel().tolist(), o_del, e_del, o_ins, e_ins, w, bonus,
                    zdrop, h0)
    return dict(score=r.score, qle=r.qle, tle=r.tle, gtle=r.gtle,
                gscore=r.gscore, max_off=r.max_off)


def _plan(jobs, mat, pen, max_qlen=ext.WARP_MAX_QLEN):
    """The wrapper's plan of a wave (``job_order``, ``warp_jobs``,
    ``scalar_slots`` on CPU tensors) and the jobs' adjusted bands."""
    o_del, e_del, o_ins, e_ins, _ = pen
    i32 = torch.int32
    qlen, tlen, h0, w, bonus = (torch.tensor(v, dtype=i32) for v in zip(
        *[(len(q), len(t), h0, w, b) for q, t, h0, w, b in jobs]))
    w_adj = ext.band_width(qlen, w, bonus, int(mat.max()), o_del, e_del,
                           o_ins, e_ins)
    mt = torch.from_numpy(mat).to(i32)
    on_warp = ext.warp_jobs(qlen, h0, mt, max_qlen)
    return (ext.job_order(qlen, tlen, w_adj).numpy(),
            ext.scalar_slots(on_warp).numpy(), w_adj.numpy(), qlen, tlen)


def wave_model(jobs, mat, pen, lanes=LANES):
    """The wave kernel: a lane group takes job order[r] for r = 0, 1, ...
    and writes its six results to column order[r]; the group DP for slot
    -1, the scalar recurrence otherwise.  Returns [6, B] and the order."""
    order, slot, w_adj, *_ = _plan(jobs, mat, pen)
    out = np.full((len(KEYS), len(jobs)), -(1 << 40), np.int64)
    warp = [b for b in order if slot[b] < 0]
    res = {}
    if warp:  # the group DP runs the warp jobs in the same order
        Q = max(len(jobs[b][0]) for b in warp)
        T = max(max(len(jobs[b][1]) for b in warp), 1)
        qs, ts = np.full((len(warp), Q), 4, np.int64), np.zeros((len(warp), T),
                                                               np.int64)
        for k, b in enumerate(warp):
            qs[k, :len(jobs[b][0])], ts[k, :len(jobs[b][1])] = jobs[b][:2]
        got = warp_extend(
            qs, ts, np.array([len(jobs[b][0]) for b in warp], np.int64),
            np.array([len(jobs[b][1]) for b in warp], np.int64),
            np.array([jobs[b][2] for b in warp], np.int64),
            w_adj[warp].astype(np.int64), mat, *pen, lanes=lanes)
        res = {b: {k: int(got[k][n]) for k in KEYS} for n, b in enumerate(warp)}
    for b in order:  # write-back in job order
        r = res[b] if slot[b] < 0 else _oracle(jobs[b], mat, pen)
        out[:, b] = [r[k] for k in KEYS]
    return out, order, slot


@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_wave_runs_heaviest_first_and_writes_back_in_job_order(scoring):
    """(a) 250 seeded jobs and a few past the group DP's limits: the order
    is a permutation, heaviest first by target rows x band cells a row with
    ties in job order; written back in job order, every job's six results
    equal ``ksw_extend2``'s."""
    rng = np.random.default_rng(sorted(SCORINGS).index(scoring) + 90)
    torch.set_num_threads(1)
    a, b, *pen = SCORINGS[scoring]
    mat = _mat(a, b)
    jobs = _jobs(rng, 250, 150)
    jobs += [(q, t, (1 << 19) - 1, w, bon) for q, t, _, w, bon in jobs[:3]]
    out, order, slot = wave_model(jobs, mat, pen)
    assert sorted(order.tolist()) == list(range(len(jobs)))
    _, _, w_adj, qlen, tlen = _plan(jobs, mat, pen)
    est = tlen.numpy().astype(np.int64) * np.minimum(qlen.numpy(), 2 * w_adj + 1)
    e = est[order]
    assert np.all(e[:-1] >= e[1:])
    assert all(order[r] < order[r + 1] for r in range(len(e) - 1)
               if e[r] == e[r + 1])
    assert (slot >= 0).sum() == 3 and list(slot[-3:]) == [0, 1, 2]
    for n, job in enumerate(jobs):
        assert dict(zip(KEYS, out[:, n].tolist())) == _oracle(job, mat, pen), n


def test_wave_split_at_the_group_limits():
    """(b) ``warp_jobs`` sends a query of 4,095 bases to the group DP and one
    of 4,096 to the scalar path; an h0 with h0 + qlen x the largest score
    at 2^19 - 1 to the group DP and at 2^19 to the scalar path; a matrix
    past int8 sends every job to the scalar path.  At the H limit an exact
    match reaches that bound (score = max H seen = 2^19 - 1, so the packed
    row max never overflows), and jobs on each side of each line equal the
    oracle through the wave model."""
    mat = _mat(1, 4)
    pen = (6, 1, 6, 1, 100)
    rng = np.random.default_rng(95)
    q95 = rng.integers(0, 4, 4095)
    q96 = rng.integers(0, 4, 4096)
    q60 = rng.integers(0, 4, 60)
    top = 1 << 19
    jobs = [(q95, q95[:40].copy(), 30, 100, 5), (q96, q96[:40].copy(), 30, 100, 5),
            (q60, q60.copy(), top - 1 - 60, 100, 5),
            (q60, q60.copy(), top - 60, 100, 5), (q60, q60.copy(), 0, 100, 5)]
    order, slot, *_ = _plan(jobs, mat, pen)
    assert slot.tolist() == [-1, 0, -1, 1, -1]
    out, *_ = wave_model(jobs, mat, pen)
    for n, job in enumerate(jobs):
        assert dict(zip(KEYS, out[:, n].tolist())) == _oracle(job, mat, pen), n
    assert out[0, 2] == top - 1 and out[0, 3] == top
    # the card's shared memory may lower the query limit
    _, slot, *_ = _plan(jobs, mat, pen, max_qlen=59)
    assert slot.tolist() == [0, 1, 2, 3, 4]
    wide = mat.copy()
    wide[0, 0] = 128
    _, slot, *_ = _plan(jobs[-1:], wide, pen)
    assert slot.tolist() == [0]


@pytest.mark.parametrize("lanes", (16, 8))
def test_group_dp_at_other_widths_matches_the_oracle(lanes):
    """The group DP at 16 and 8 lanes a job (the widths measured against a
    whole warp): the same results as ``ksw_extend2`` on seeded jobs, rows
    of one pass and of several."""
    rng = np.random.default_rng(97 + lanes)
    torch.set_num_threads(1)
    a, b, *pen = SCORINGS["bwa"]
    mat = _mat(a, b)
    jobs = _jobs(rng, 120, 150) + _jobs(rng, 2, 600)
    out, *_ = wave_model(jobs, mat, pen, lanes=lanes)
    for n, job in enumerate(jobs):
        assert dict(zip(KEYS, out[:, n].tolist())) == _oracle(job, mat, pen), n


# ------------------------------------------------------------ chaining

def _bns():
    return Bntseq(l_pac=chain_cases.WARP_L_PAC, anns=[
        BntAnn(offset=o, name=f"c{i}", length=n, is_alt=a)
        for i, (o, n, a) in enumerate(chain_cases.WARP_CONTIGS)])


def _ballot_count(pred):
    """A ballot of ``pred`` a 32-lane chunk, the popcounts summed."""
    total = 0
    for c in range(0, len(pred), LANES):
        bits = sum(1 << lane for lane, p in enumerate(pred[c:c + LANES]) if p)
        total += bin(bits).count("1")
    return total


def chain_model(opt, ends, alts, l_pac, qlen, intervals, rbegs, C=co.C_MAX,
                events=None):
    """``chain_read`` of csrc/chain.cu on one read.  Returns None when the
    C budget flags it, else its chains as (rid, is_alt, frac_rep, w, kept,
    first, seeds) in output order.  ``events`` (a dict) records the
    predecessor searches (lo per seed) and, per shadowed chain a, the break
    position, the kept chains before it and the j whose ``first`` it set;
    and the scratch the emit pass reads: per seed in enumeration order its
    slot (``assign``, -1 dropped), per slot where its seeds start in the
    read's output (``slot_dst``, -1 for a chain not emitted)."""
    ev = events if events is not None else {}
    ev.setdefault("lo", [])
    ev.setdefault("breaks", [])
    ev.setdefault("assign", [])
    ev["slot_dst"] = []

    def ctg_of(pos):
        return int(np.searchsorted(ends, pos, side="right"))

    def intv2rid(rb, re):
        fwd = rb < l_pac
        if fwd != (re <= l_pac):
            return -1
        fb = rb if fwd else 2 * l_pac - 1 - (re - 1)
        fe = re - 1 if fwd else 2 * l_pac - 1 - rb
        if fb < 0 or fe >= l_pac:
            return -1
        r = ctg_of(fb)
        return r if r == ctg_of(fe) else -1

    # frac_rep: the rows of each window whose s passes max_occ, in turn
    b = e = l_rep = 0
    for p in intervals:
        if p[2] > opt.max_occ:
            if p[3] > e:
                l_rep += e - b
                b, e = p[3], p[4]
            elif p[4] > e:
                e = p[4]
    l_rep += e - b
    frac = l_rep / qlen if qlen > 0 else 0.0
    if qlen < opt.min_seed_len:
        return []
    okey = np.zeros(C, np.int64)  # key position m: 32 c + lane
    oslot = np.zeros(C, np.int64)
    tab = {k: [] for k in ("crid", "q0", "r0", "qlast", "rl", "ll", "endq",
                           "wq", "endr", "wr", "seeds")}
    nch = 0
    for w0 in range(0, len(intervals), LANES):
        win = intervals[w0:w0 + LANES]
        cnt = np.array([len(rbegs[w0 + k]) for k in range(len(win))]
                       + [0] * (LANES - len(win)), np.int64)
        inc = np.cumsum(cnt)
        excl = inc - cnt
        wtot = int(inc[-1])
        for s0 in range(0, wtot, LANES):
            batch = []
            for lane in range(LANES):
                rel = s0 + lane
                k = 0
                for step in (16, 8, 4, 2, 1):  # the 5-step shuffle search
                    if excl[k + step] <= rel:
                        k += step
                if rel < wtot:
                    p = win[k]
                    rb = int(rbegs[w0 + k][rel - excl[k]])
                    batch.append((intv2rid(rb, rb + p[4] - p[3]), rb, p[3],
                                  p[4] - p[3]))
            for prid, pr, pq, pl in batch:
                if prid < 0:
                    ev["assign"].append(-1)
                    continue
                live = np.arange(len(okey)) < nch
                lo = _ballot_count(live & (okey <= pr))
                ev["lo"].append(lo)
                s, settled = -1, False
                if lo > 0:
                    c = int(oslot[lo - 1])
                    if prid == tab["crid"][c]:
                        cq0, cql, cll = tab["q0"][c], tab["qlast"][c], tab["ll"][c]
                        cr0, crl = tab["r0"][c], tab["rl"][c]
                        if (pq >= cq0 and pq + pl <= cql + cll and pr >= cr0
                                and pr + pl <= crl + cll):
                            settled = True
                        elif not ((crl < l_pac or cr0 < l_pac) and pr >= l_pac):
                            x, y = pq - cql, pr - crl
                            if (y >= 0 and x - y <= opt.w and y - x <= opt.w
                                    and x - cll < opt.max_chain_gap
                                    and y - cll < opt.max_chain_gap):
                                settled, s = True, c
                if not settled:
                    if nch >= C:
                        return None
                    s = nch
                    nch += 1
                    m = np.arange(len(okey))  # positions >= lo move up one
                    up_k = np.concatenate([[0], okey[:-1]])
                    up_s = np.concatenate([[0], oslot[:-1]])
                    okey = np.where(m == lo, pr, np.where(m > lo, up_k, okey))
                    oslot = np.where(m == lo, s, np.where(m > lo, up_s, oslot))
                    for k_, v in (("crid", prid), ("q0", pq), ("r0", pr),
                                  ("qlast", 0), ("rl", 0), ("ll", 0),
                                  ("endq", 0), ("wq", 0), ("endr", 0),
                                  ("wr", 0), ("seeds", None)):
                        tab[k_].append([] if k_ == "seeds" else v)
                if s >= 0:
                    eq, er = pq + pl, pr + pl
                    tab["wq"][s] += max(eq - max(tab["endq"][s], pq), 0)
                    tab["endq"][s] = max(tab["endq"][s], eq)
                    tab["wr"][s] += max(er - max(tab["endr"][s], pr), 0)
                    tab["endr"][s] = max(tab["endr"][s], er)
                    tab["qlast"][s], tab["rl"][s], tab["ll"][s] = pq, pr, pl
                    tab["seeds"][s].append((pr, pq, pl))
                ev["assign"].append(s)
    # the rank sort over key order
    w = [min(min(tab["wq"][s], tab["wr"][s]), (1 << 30) - 1) for s in range(nch)]
    kw = np.array([w[oslot[m]] if w[oslot[m]] >= opt.min_chain_weight else -1
                   for m in range(nch)], np.int64)
    srt = {}
    for m in range(nch):
        if kw[m] >= 0:
            rank = int(np.sum((kw > kw[m]) | ((kw == kw[m]) & (np.arange(nch) < m))))
            srt[rank] = int(oslot[m])
    na = len(srt)
    ev["slot_dst"] = [-1] * nch
    if na == 0:
        return []
    sl = [srt[j] for j in range(na)]
    jq0 = np.array([tab["q0"][s] for s in sl])
    jqe = np.array([tab["qlast"][s] + tab["ll"][s] for s in sl])
    jw = np.array([w[s] for s in sl])
    jalt = np.array([alts[tab["crid"][s]] != 0 for s in sl])
    kept = np.zeros(na, np.int64)
    kept[0] = 3
    first = np.full(na, -1, np.int64)
    for a in range(1, na):
        j = np.arange(a)
        valid = kept[:a] != 0
        b_max = np.maximum(jq0[:a], jq0[a])
        e_min = np.minimum(jqe[:a], jqe[a])
        li, lj = jqe[a] - jq0[a], jqe[:a] - jq0[:a]
        min_l = np.minimum(li, lj)
        ov = valid & (e_min > b_max) & ~(jalt[:a] & ~jalt[a])
        big = ov & ((e_min - b_max).astype(np.float64)
                    >= min_l.astype(np.float64) * opt.mask_level) & (
            min_l < opt.max_chain_gap)
        drop = big & (float(jw[a]) < jw[:a].astype(np.float64) * opt.drop_ratio) & (
            jw[:a] - jw[a] >= (opt.min_seed_len << 1))
        # the lowest set bit of the drop ballots, chunk by chunk
        jb = next((c + int(np.flatnonzero(drop[c:c + LANES])[0])
                   for c in range(0, a, LANES) if drop[c:c + LANES].any()), None)
        upto = j <= (jb if jb is not None else a)
        setf = big & upto & (first[:a] < 0)
        first[:a] = np.where(setf, a, first[:a])
        ev["breaks"].append((a, jb, np.flatnonzero(valid).tolist(),
                             np.flatnonzero(setf).tolist()))
        if jb is None:
            kept[a] = 2 if big.any() else 3
    mark = np.zeros(na, bool)
    mark[first[(kept >= 2) & (first >= 0)]] = True
    kept = np.where((kept == 0) & mark, 1, kept)
    out, n_ext, seedpos = [], 0, 0
    for c in range(0, na, LANES):  # the ballot scans of the output walk
        jj = np.arange(c, min(c + LANES, na))
        ext_n = n_ext + np.cumsum(kept[jj] >= 2)
        emit = (kept[jj] > 0) & ~((kept[jj] >= 2) & (ext_n > opt.max_chain_extend))
        for j in jj[emit]:
            s = sl[j]
            ev["slot_dst"][s] = seedpos
            seedpos += len(tab["seeds"][s])
            out.append((tab["crid"][s], int(alts[tab["crid"][s]]), frac, int(jw[j]),
                        int(kept[j]), int(first[j]), tuple(tab["seeds"][s])))
        n_ext = int(ext_n[-1])
    return out


def _oracle_chains(opt, bns, qlen, ivs, rbs):
    exp = chain_flt(opt, mem_chain(opt, None, bns, qlen,
                                   [SmemIntv(*p) for p in ivs], rbs))
    return [(c.rid, c.is_alt, c.frac_rep, c.w, c.kept, c.first,
             tuple((s.rbeg, s.qbeg, s.len) for s in c.seeds)) for c in exp]


@pytest.fixture(scope="module")
def warp_reads():
    names, ivs, rbs, qlens = chain_cases.warp_table(np.random.default_rng(5))
    bns = _bns()
    ends = np.array([a.offset + a.length for a in bns.anns], np.int64)
    alts = np.array([a.is_alt for a in bns.anns], np.int64)
    return dict(zip(names, zip(qlens, ivs, rbs))), bns, ends, alts


def _check(warp_reads, name, opt=None, events=None):
    reads, bns, ends, alts = warp_reads
    opt = opt or MemOptions()
    qlen, ivs, rbs = reads[name]
    got = chain_model(opt, ends, alts, bns.l_pac, qlen, ivs, rbs, events=events)
    assert got == _oracle_chains(opt, bns, qlen, ivs, rbs), name
    return got


def test_chain_ballot_bisect_with_equal_keys(warp_reads):
    """(c) 40 chains of one key (two 32-lane chunks): bisect_right as
    popcounts of ballots finds the last of them (the seed that joins it
    sees lo = 40), a smaller key goes before them all, a seed at the key
    itself opens a chain after them; chains equal the oracle's."""
    ev = {}
    got = _check(warp_reads, "equal_keys", events=ev)
    assert ev["lo"][:41] == list(range(41))
    assert ev["lo"][41:44] == [0, 41, 42]
    assert len(got) == 44


def test_chain_rank_sort_keeps_key_order_on_equal_weights(warp_reads):
    """(d) Chains of equal weight created in another order than their keys':
    the rank sort (greater weights, then equal weights earlier in key
    order) gives the oracle's stable weight sort, not creation order; and
    the rank sort against numpy's stable sort on seeded weights with many
    ties."""
    got = _check(warp_reads, "key_vs_creation")
    assert [c[3] for c in got] == [45, 30, 30, 30, 30, 20]
    assert [c[6][0][0] for c in got[1:5]] == [10_000, 20_000, 25_000, 30_000]
    rng = np.random.default_rng(96)
    for _ in range(200):
        n = int(rng.integers(1, 129))
        kw = rng.integers(-1, 6, n)  # -1: below min_chain_weight
        rank = [int(np.sum((kw > kw[m]) | ((kw == kw[m]) & (np.arange(n) < m))))
                for m in range(n)]
        alive = np.flatnonzero(kw >= 0)
        exp = alive[np.argsort(-kw[alive], kind="stable")]
        got_order = [m for _, m in sorted((rank[m], m) for m in alive)]
        assert got_order == exp.tolist()


@pytest.mark.parametrize("name,want", (
    ("break_first", "first"), ("break_last", "last"),
    ("large_no_break", "none"), ("alt_skip", "none")))
def test_chain_shadowing_ballots(warp_reads, name, want):
    """(e) The shadowing walk as ballots: a break at the first kept chain, a
    break at the last, large overlaps on two kept chains and no break, an
    ALT chain skipped; ``first`` is set at the breaking j (and at every
    large j before it); kept codes and ``first`` equal the oracle's."""
    ev = {}
    _check(warp_reads, name, events=ev)
    broke = [b for b in ev["breaks"] if b[1] is not None]
    if want != "none":
        a, jb, kept_js, set_js = broke[0]
    if want == "first":
        assert jb == kept_js[0] and jb in set_js
    elif want == "last":
        assert len(kept_js) > 1 and jb == kept_js[-1] and set_js == [jb]
    else:
        assert all(b[1] is None for b in ev["breaks"][:2])
    if name == "large_no_break":
        assert ev["breaks"][1][3] == [0, 1]


def test_chain_budget_of_128_chains(warp_reads):
    """(f) 128 chains fit the budget; a 129th flags the read (no chains),
    as the plain version flags it (``ovf``, ``nslots`` = C + 1)."""
    reads, bns, ends, alts = warp_reads
    opt = MemOptions()
    got = _check(warp_reads, "c128")
    assert len(got) == 128
    qlen, ivs, rbs = reads["c129"]
    assert chain_model(opt, ends, alts, bns.l_pac, qlen, ivs, rbs) is None
    tab = co.SeedTable.from_numpy("cpu", *chain_cases.seed_table(
        [reads[n][1] for n in ("c128", "c129")],
        [reads[n][2] for n in ("c128", "c129")],
        [reads[n][0] for n in ("c128", "c129")]))
    out = co.chain_torch(co.DeviceContigs.from_host(bns, "cpu"), tab,
                         co.ChainParams.from_opt(opt))
    assert out.ovf.tolist() == [False, True]
    assert out.nslots.tolist() == [128, co.C_MAX + 1]


@pytest.mark.parametrize("opts", ({}, {"min_chain_weight": 30,
                                       "max_chain_extend": 3}),
                         ids=("default", "weight30_extend3"))
def test_chain_model_matches_the_oracle_on_every_warp_read(warp_reads, opts):
    """Every read of ``warp_table`` (the edge cases, a short and an empty
    read, and 40 random reads of 30-400 seeds from both strands, across
    contig ends and past max_occ), with the default options and with a
    weight filter and the max_chain_extend trim."""
    reads, bns, ends, alts = warp_reads
    opt = MemOptions(**opts)
    for name in reads:
        if name != "c129":
            _check(warp_reads, name, opt)
