"""The multi-device dry run: the counterpart of __graft_entry__.py
``dryrun_multichip``, on any list of devices (cards, a card repeated, or
``cpu`` repeated: the virtual mesh of the tests).

``dryrun_multichip(devices)`` checks, and raises on the first difference:

1.  PE alignment (100 and 300 bp pairs on a two-contig genome with a
    repeat block) on a ``(data, idx)`` mesh through
    ``parallel.pipeline.align_seqs_mesh``, record-equal to the
    single-device route on ``devices[0]``;
1b. the whole stage stack ("seed", "sa_lookup", "chain" and the waves) on a
    ``(n, 1)`` mesh, record-equal too;
2.  the idx-sharded occ4 step (``dataparallel.make_sharded_occ_step``)
    against the host oracle ``FMIndex.occ4``;
3.  on a ``utils.synth.synthetic_fmindex`` index (by default
    ``(3_100_000_000 // 128) * 128`` rows, past 2^31, ``sa_intv`` 512, as
    the reference's), the seed+SA step (``ops.seed.seed_sa_walk``:
    intervals, SA rows and their text positions) against the host oracle
    (``engine.seed.collect_intv``, ``sample_ks`` and ``FMIndex.sa_lookup``)
    for every read the M-slot budget does not flag (the aligner seeds those
    on the host);
3b. the same step on the tables sharded over each of ``shard_counts``
    (``ops.fmindex.ShardedFMIndex`` on the idx axis's devices, or
    ``devices[0]`` repeated when the mesh has fewer), bit-equal to the
    unsharded run.

It returns a summary (counts, and under "big" the synthetic index, its
reads and options, for a caller that times the kernels on them).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..api.options import MEM_F_PE, MemOptions
from ..engine import native_pipeline
from ..engine.chain import sample_ks
from ..engine.exec_ctx import ExecConfig
from ..engine.pipeline import Engine, align_regs_raw
from ..engine.seed import collect_intv
from ..index.build import build_index
from ..ops import fmindex as fmops
from ..ops import seed as seedops
from ..utils.fasta import Fasta, FastaContig
from ..utils.synth import synthetic_fmindex
from .dataparallel import make_sharded_occ_step, shard_tables
from .mesh import make_mesh
from .pipeline import align_seqs_mesh

BIG_LEN = (3_100_000_000 // 128) * 128


def _key(a):
    return (a.flag, a.rid, a.pos, a.is_rev, a.mapq, a.NM, tuple(a.cigar),
            a.md, a.score, a.sub, a.alt_sc, a.XA)


def _assert_equal(got, want, what: str) -> int:
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} reads, want {len(want)}")
    n = 0
    for i, (g, w) in enumerate(zip(got, want)):
        kg, kw = [_key(a) for a in g], [_key(a) for a in w]
        if kg != kw:
            raise AssertionError(f"{what}: read {i} diverged:\n mesh={kg}\n "
                                 f"single={kw}")
        n += len(kg)
    return n


def _single(opt, eng, reads, device, is_pe, pes=None):
    """The single-device route's records on ``device``: the waves (and no
    other device stage) there, then the C++ tail."""
    cfg = ExecConfig(device=device, force_waves=True)
    rows, n_reg = align_regs_raw(opt, eng, reads, cfg)
    arrays = native_pipeline.tail_batch_arrays(opt, eng.idx, reads, rows, n_reg,
                                               is_pe=is_pe, pes=pes)
    return native_pipeline.records_from_arrays(len(reads), *arrays)


def _reads(rng, c0, c1, n_pairs):
    reads = []
    for k in range(n_pairs):
        src = c0 if rng.integers(0, 3) else c1
        rlen = 300 if k % 4 == 0 else 100  # every 4th pair 300 bp
        isize = int(rng.integers(2 * rlen - 20, 3 * rlen + 20))
        start = int(rng.integers(0, len(src) - isize - 1))
        r1 = src[start: start + rlen].copy()
        r2 = (3 - src[start + isize - rlen: start + isize])[::-1].copy()
        for r in (r1, r2):
            for p in rng.integers(0, rlen, rng.binomial(rlen, 0.01)):
                r[p] = (r[p] + 1 + rng.integers(0, 3)) % 4
        reads += [r1, r2]
    return reads


def _seed_host(opt, fm, reads):
    """The host oracle of the seed+SA step: per read its intervals and,
    per interval, the text positions of its SA rows."""
    out = []
    for r in reads:
        ivs = collect_intv(opt, fm, r)
        out.append([(tuple(p), fm.sa_lookup(np.asarray(sample_ks(p, opt.max_occ),
                                                       dtype=np.int64)))
                    for p in ivs])
    return out


def _seed_device(opt, dfm, reads):
    """The seed+SA step on ``dfm`` (either form): per read its intervals
    and their positions, and the raw outputs (for the bit-equal check)."""
    q, ql = seedops.pad_reads(reads, dfm.device)
    p = seedops.SeedParams.from_opt(opt)
    res, pos = seedops.seed_sa_walk(dfm, q, ql, p)
    iv = res.intervals
    n = torch.where(iv.ovf, 0, iv.n).cpu().tolist()
    flat, ks, pos_h = res.flat.cpu().numpy(), res.ks.cpu(), pos.cpu().numpy()
    cnt = np.minimum(flat[:, 2], opt.max_occ) if len(flat) else np.zeros(0)
    per, row, at = [], 0, 0
    for nr in n:
        cur = []
        for _ in range(nr):
            c = int(cnt[row])
            cur.append((tuple(flat[row].tolist()), pos_h[at: at + c]))
            row, at = row + 1, at + c
        per.append(cur)
    raw = (iv.rows, iv.n, iv.ovf, iv.nks, res.flat, res.ks, pos)
    return per, [int(o) for o in iv.ovf.cpu().tolist()], raw


def dryrun_multichip(devices: Sequence, big_len: int = BIG_LEN,
                     shard_counts: Sequence[int] = (2,), n_pairs: int = 0,
                     n_sub: int = 64, min_seed_len: int = 14) -> dict:
    """The dry run on ``devices`` (their count even for a (n/2, 2) mesh);
    see the module docstring.  ``n_pairs`` 0 is the reference's count,
    max(8 x devices, 48); ``big_len`` 0 skips steps 3 and 3b;
    ``min_seed_len`` is step 3's (14 at 1.55 Gbp, where random reads carry
    many SMEMs: 4^14 << 3.1e9; a smaller index needs less)."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    idx_shards = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(devices=devices, idx_shards=idx_shards)
    opt = MemOptions(flag=MEM_F_PE)
    home = devices[0]

    # 1. PE alignment, waves split over the (data, idx) mesh
    rng = np.random.default_rng(0)
    c0 = rng.integers(0, 4, 40_000).astype(np.uint8)
    c1 = rng.integers(0, 4, 12_000).astype(np.uint8)
    c0[30_000:30_200] = c0[6_000:6_200]  # repeat block (XA path)
    eng = Engine(build_index(Fasta([FastaContig("c0", "", c0),
                                    FastaContig("c1", "", c1)])))
    reads = _reads(rng, c0, c1, n_pairs or max(8 * n, 48))
    from ..engine import pair as pair_mod
    from ..engine.pipeline import align_regs_batch

    pes = pair_mod.pestat(opt, eng.idx.bns.l_pac, align_regs_batch(
        opt, eng, reads, ExecConfig(device="cpu")))
    single = _single(opt, eng, reads, home, True, pes)
    n_rec = _assert_equal(align_seqs_mesh(opt, eng, reads, mesh, is_pe=True,
                                          pes=pes), single, "wave mesh")
    mapped = sum(1 for recs in single if recs and not recs[0].flag & 0x4)

    # 1b. the whole stage stack on an (n, 1) mesh
    mesh2 = make_mesh(devices=devices, idx_shards=1)
    sub = reads[:min(len(reads), n_sub)]
    n_rec_full = _assert_equal(
        align_seqs_mesh(opt, eng, sub, mesh2, is_pe=True, pes=pes,
                        device_stages=("seed", "sa_lookup", "chain")),
        _single(opt, eng, sub, home, True, pes), "full device stack mesh")

    # 2. the idx-sharded occ4 step against the host oracle
    fm = eng.fm
    ks = torch.from_numpy(rng.integers(-1, fm.seq_len + 1, 256))
    occ = make_sharded_occ_step(mesh)(shard_tables(mesh, fm), ks)
    if not np.array_equal(occ.cpu().numpy(), fm.occ4(ks.numpy())):
        raise AssertionError("sharded occ4 differs from the host oracle")
    out = dict(mesh=mesh.shape, reads=len(reads), records=n_rec, mapped=mapped,
               full_stack=dict(mesh=mesh2.shape, reads=len(sub),
                               records=n_rec_full),
               occ_queries=int(ks.numel()))
    if not big_len:
        return out

    # 3. past 2^31 rows: the seed+SA step against the host oracle
    rng_b = np.random.default_rng(7)
    fm_big = synthetic_fmindex(big_len, rng_b, sa_intv=512)
    reads_b = [rng_b.integers(0, 4, 64).astype(np.uint8) for _ in range(6)]
    reads_b.append(np.full(24, 4, dtype=np.uint8))  # all-N edge
    opt_b = MemOptions(min_seed_len=min_seed_len)
    dfm_b = fmops.DeviceFMIndex.from_host(fm_big, home)
    got, ovf, raw = _seed_device(opt_b, dfm_b, reads_b)
    want = _seed_host(opt_b, fm_big, reads_b)
    n_intv = n_rb = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if ovf[i]:  # past the M-slot budget: the aligner seeds it on the host
            continue
        if [x for x, _ in g] != [x for x, _ in w] or not all(
                np.array_equal(a, b) for (_, a), (_, b) in zip(g, w)):
            raise AssertionError(f"big-domain read {i}: seed+SA differs from "
                                 "the host oracle")
        n_intv += len(w)
        n_rb += sum(len(b) for _, b in w)

    # 3b. the same step on the tables sharded over the idx axis
    row = list(mesh.devices[0])
    for s in shard_counts:
        sdevs = row if len(row) == s else [home] * s
        sfm = fmops.ShardedFMIndex.from_host(fm_big, sdevs)
        _, _, raw_s = _seed_device(opt_b, sfm, reads_b)
        for a, b in zip(raw, raw_s):
            if not torch.equal(a.cpu(), b.cpu()):
                raise AssertionError(f"{s}-shard seed+SA differs from the "
                                     "unsharded run")
        del sfm
    out["big"] = dict(seq_len=int(fm_big.seq_len), reads=len(reads_b),
                      flagged=sum(ovf), intervals=n_intv, rbegs=n_rb,
                      shard_counts=list(shard_counts), fm=fm_big,
                      reads_b=reads_b, opt=opt_b, dfm=dfm_b)
    return out
