"""The port's seeding (plain PyTorch versions of smem1a, strategy1 and the
fused seed+SA chain, and the device seeding stage) against the JAX
package's ``smem_tpu.smem1a_batch``, ``seed_tpu.seed_strategy1`` and
``seed_fused.seed_sa_fused`` run on the CPU, and against the host oracle
(``engine.seed``, ``engine.chain.sample_ks``, ``FMIndex.sa_lookup``).
Integers, tolerance 0: every output is compared, overflow flags included;
an overflowed lane's intervals are unspecified in both packages (the host
seeds such a read), so only its flag and its next start are compared.
The CUDA kernels are held against the plain versions in
test_torch_cuda.py."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwamem_tpu.api.options import MemOptions
from bwamem_tpu.engine.chain import sample_ks
from bwamem_tpu.engine.fmindex import FMIndex
from bwamem_tpu.engine.seed import collect_intv, seed_strategy1, smem1a
from bwamem_tpu.index.build import build_index
from bwamem_tpu.ops import fmindex_tpu as ft
from bwamem_tpu.ops import seed_fused, seed_tpu, smem_tpu
from bwamem_tpu.utils.fasta import Fasta, FastaContig
from bwamem_tpu_torch.api.options import MemOptions as PortOptions
from bwamem_tpu_torch.engine import native_fm, pipeline
from bwamem_tpu_torch.engine.exec_ctx import ExecConfig
from bwamem_tpu_torch.engine.fmindex import FMIndex as PortFMIndex
from bwamem_tpu_torch.engine.seed_device import SEED_STATS, seed_batch
from bwamem_tpu_torch.ops import fmindex as fmops
from bwamem_tpu_torch.ops import seed as so
from bwamem_tpu_torch.ops.fmindex import DeviceFMIndex
from bwamem_tpu_torch.index.build import build_index as port_build_index
from bwamem_tpu_torch.utils import fasta as port_fasta
from bwamem_tpu_torch.utils import seed_cases as cases

OPT = MemOptions()
PORT_OPT = PortOptions()
PARAMS = so.SeedParams.from_opt(OPT)
READ_LEN = cases.READ_LEN


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops lose to thread start-up, and the suite runs several
    workers at once: keep torch to one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(404)
    contigs, kread = cases.genome(rng)
    fasta = Fasta([FastaContig(f"c{i}", "", c) for i, c in enumerate(contigs)])
    fms = {iv: FMIndex(build_index(fasta, sa_intv=iv)) for iv in (8, 32)}
    # the port's own index of the same genome, for its engine-level entries
    fms["port"] = PortFMIndex(port_build_index(port_fasta.Fasta(
        [port_fasta.FastaContig(f"c{i}", "", c.copy())
         for i, c in enumerate(contigs)]), sa_intv=8))
    reads = cases.reads(contigs, kread, rng)
    return fms, reads, len(reads) - 1


@pytest.fixture(scope="module", params=(8, 32), ids=("intv8", "intv32"))
def fm(request, data):
    return data[0][request.param]


def _lane_batch(reads, lanes):
    qseq, qlen = so.pad_reads([reads[i] for i, _, _ in lanes], "cpu")
    x = torch.tensor([x for _, x, _ in lanes], dtype=torch.int32)
    mi = torch.tensor([m for _, _, m in lanes], dtype=torch.int64)
    return qseq, qlen, x, mi


def _np(t):
    return np.asarray(t).astype(np.int64)


def _jax_dfm(fm, big=False):
    return ft.DeviceFMIndex.from_host(fm, force_big=big)


def test_smem1a_with_the_largest_budget_matches_oracle(data):
    """K = K_MAX: the K-overflow read's lanes are no longer flagged and
    equal the oracle's SMEMs."""
    fms, reads, kidx = data
    fm = fms[8]
    lanes = [ln for ln in cases.lanes(reads, 1) if ln[0] == kidx]
    qseq, qlen, x, mi = _lane_batch(reads, lanes)
    got = so.smem1a(DeviceFMIndex.from_host(fm, "cpu"), qseq, qlen, x, mi,
                    so.K_MAX)
    assert not got.ovf.any()
    assert got.x0.shape == (len(lanes), so.K_MAX)
    for b, (i, xs, m) in enumerate(lanes):
        ret, mems = smem1a(fm, reads[i], xs, m)
        mine = [tuple(int(v[b, j]) for v in got[1:6])
                for j in range(int(got.m_cnt[b]))]
        assert int(got.ret[b]) == ret and mine[::-1] == [tuple(p) for p in mems]


def test_smem1a_matches_jax_and_oracle(fm, data):
    _, reads, kidx = data
    lanes = cases.lanes(reads, 1)
    qseq, qlen, x, mi = _lane_batch(reads, lanes)
    got = so.smem1a(DeviceFMIndex.from_host(fm, "cpu"), qseq, qlen, x, mi,
                    so.K_SLOTS)
    ref = smem_tpu.smem1a_batch(_jax_dfm(fm), jnp.asarray(qseq.numpy(), jnp.int32),
                                jnp.asarray(qlen.numpy()), jnp.asarray(x.numpy()),
                                jnp.asarray(mi.numpy(), jnp.int32))
    ref = [_np(r) for r in ref]
    ovf = got.ovf.numpy()
    assert np.array_equal(ovf, ref[7].astype(bool))
    assert np.array_equal(_np(got.ret), ref[0])
    ok = ~ovf
    for g, r in zip(got[1:7], ref[1:7]):
        assert np.array_equal(_np(g)[ok], r[ok])
    # the K-overflow read overflows from x = 0, and no other read does
    assert ovf[lanes.index((kidx, 0, 1))]
    assert {lanes[b][0] for b in np.flatnonzero(ovf)} == {kidx}
    for b, (i, xs, m) in enumerate(lanes):
        if xs >= len(reads[i]) or reads[i][xs] > 3:
            assert int(got.ret[b]) == xs + 1 and int(got.m_cnt[b]) == 0
            continue
        ret, mems = smem1a(fm, reads[i], xs, m)
        assert int(got.ret[b]) == ret
        if not ovf[b]:
            k = int(got.m_cnt[b])
            mine = [tuple(int(v[b, j]) for v in got[1:6]) for j in range(k)]
            assert mine[::-1] == [tuple(p) for p in mems], b


def test_strategy1_matches_jax_and_oracle(fm, data):
    _, reads, _ = data
    lanes = cases.lanes(reads, 2)
    qseq, qlen, x, _ = _lane_batch(reads, lanes)
    got = so.strategy1(DeviceFMIndex.from_host(fm, "cpu"), qseq, qlen, x,
                       OPT.min_seed_len, OPT.max_mem_intv)
    ref = seed_tpu.seed_strategy1(_jax_dfm(fm), jnp.asarray(qseq.numpy(), jnp.int32),
                                  jnp.asarray(qlen.numpy()), jnp.asarray(x.numpy()),
                                  OPT.min_seed_len, OPT.max_mem_intv)
    for g, r in zip(got, ref):
        assert np.array_equal(_np(g), _np(r))
    assert got.found.any() and not got.found.all()
    for b, (i, xs, _) in enumerate(lanes):
        if xs >= len(reads[i]) or reads[i][xs] > 3:
            assert not got.found[b] and int(got.nxt[b]) == xs + 1
            continue
        nxt, m = seed_strategy1(fm, reads[i], xs, OPT.min_seed_len,
                                OPT.max_mem_intv)
        assert int(got.nxt[b]) == nxt and bool(got.found[b]) == (m is not None)
        if m is not None:
            assert tuple(int(v[b]) for v in got[1:6]) == tuple(m)


def _jax_seed_sa(jdfm, reads, M):
    """seed_fused.seed_sa_fused on the padded batch, decoded per read:
    (n, ovf, rows per read, rbegs per row)."""
    B = len(reads)
    qseq, qlen = so.pad_reads(reads, "cpu")
    r_per_read = 256
    # a flagged read's count goes on growing in round 3 (one hit per start
    # at most), and the flat table's layout follows the counts: room for M
    # rows and a read's length of round-3 hits keeps every row in the table
    flat, extra = seed_fused.seed_sa_fused(
        jdfm, jnp.asarray(qseq.numpy().astype(np.int8)), jnp.asarray(qlen.numpy()),
        min_seed_len=OPT.min_seed_len, split_len=OPT.split_len,
        split_width=OPT.split_width, max_mem_intv=OPT.max_mem_intv,
        max_occ=OPT.max_occ, M=M, r_per_read=r_per_read,
        f_per_read=M + READ_LEN)
    flat, extra = _np(flat), _np(extra)
    R_cap = B * r_per_read
    meta = extra[R_cap + 2:]
    n, ovf = meta & 0xFFFF, (meta >> 16) != 0
    assert extra[R_cap] <= R_cap  # no truncated walks
    cnt = np.minimum(flat[: int(extra[R_cap + 1]), 2], OPT.max_occ)
    offs = np.concatenate([[0], np.cumsum(cnt)])
    rows, rbegs, start = [], [], 0
    for r in range(B):
        rr = flat[start: start + n[r]]
        rows.append([(a, b, s, q >> 16, q & 0xFFFF) for a, b, s, q in rr.tolist()])
        rbegs.append([extra[offs[j]: offs[j + 1]].tolist()
                      for j in range(start, start + n[r])])
        start += n[r]
    return n, ovf, rows, rbegs


def _port_per_read(dfm, res, max_occ=OPT.max_occ):
    """seed_sa's flat table and the walks of its SA rows (as the pipeline
    walks them, ``fmindex.sa_lookup``), split per unflagged read."""
    iv = res.intervals
    ovf, n = iv.ovf.numpy(), iv.n.numpy().astype(np.int64)
    flat = res.flat.numpy()
    cnt = np.minimum(flat[:, 2], max_occ)
    offs = np.concatenate([[0], np.cumsum(cnt)])
    rb = fmops.sa_lookup(dfm, res.ks).numpy()
    rows, rbegs, start = [], [], 0
    for r in range(len(n)):
        k = 0 if ovf[r] else n[r]
        rows.append([tuple(v) for v in flat[start: start + k].tolist()])
        rbegs.append([rb[offs[j]: offs[j + 1]].tolist()
                      for j in range(start, start + k)])
        start += k
    assert start == len(flat) and offs[-1] == len(rb) == len(res.ks)
    return n, ovf, rows, rbegs


def _oracle(fm, read):
    ivs = collect_intv(OPT, fm, read)
    return ([tuple(p) for p in ivs],
            [fm.sa_lookup(np.asarray(sample_ks(p, OPT.max_occ), np.int64)).tolist()
             for p in ivs])


def _check_seed_sa(fm, jdfm, reads, M=so.M_SLOTS):
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    res = so.seed_sa_torch(dfm, *so.pad_reads(reads, "cpu"), PARAMS, M,
                           K=so.K_SLOTS)
    n, ovf, rows, rbegs = _port_per_read(dfm, res)
    jn, jovf, jrows, jrbegs = _jax_seed_sa(jdfm, reads, M)
    assert np.array_equal(ovf, jovf)
    ok = ~ovf
    assert np.array_equal(n[ok], jn[ok])
    for r in np.flatnonzero(ok):
        assert rows[r] == jrows[r], r
        assert rbegs[r] == jrbegs[r], r
        assert (rows[r], rbegs[r]) == _oracle(fm, reads[r]), r
    nks = res.intervals.nks.numpy()
    assert np.array_equal(nks, [sum(len(x) for x in rb) for rb in rbegs])
    return res, ovf


def test_seed_sa_matches_jax_and_oracle(fm, data):
    _, reads, kidx = data
    res, ovf = _check_seed_sa(fm, _jax_dfm(fm), reads)
    assert np.flatnonzero(ovf).tolist() == [kidx]  # the K-overflow read
    # round 2 ran: some read has an interval that round 1 alone lacks
    assert any(len(_oracle(fm, r)[0]) > _round1_count(fm, r) for r in reads)


def _round1_count(fm, read):
    x, n = 0, 0
    while x < len(read):
        if read[x] < 4:
            x, found = smem1a(fm, read, x, 1)
            n += sum(m.qlen >= OPT.min_seed_len for m in found)
        else:
            x += 1
    return n


def test_seed_sa_int64_domain_matches_jax(data):
    """The JAX package's forced int64 domain gives the same intervals and
    walks as the port, which is int64 at every size."""
    fms, reads, _ = data
    fm = fms[8]
    _check_seed_sa(fm, _jax_dfm(fm, big=True), reads[::3] + reads[-3:])


def test_seed_sa_with_the_largest_budget_matches_oracle(data):
    """K = K_MAX: no read is flagged, the K-overflow read included, and
    every read's intervals and walks equal the oracle's."""
    fms, reads, _ = data
    fm = fms[32]
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    res = so.seed_sa_torch(dfm, *so.pad_reads(reads, "cpu"), PARAMS, K=so.K_MAX)
    n, ovf, rows, rbegs = _port_per_read(dfm, res)
    assert not ovf.any()
    for r, read in enumerate(reads):
        assert (rows[r], rbegs[r]) == _oracle(fm, read), r


def test_seed_sa_m_overflow_matches_jax(data):
    """With M = 4 slots the reads with more than 4 intervals overflow, on
    both sides alike."""
    fms, reads, kidx = data
    fm = fms[32]
    _, ovf = _check_seed_sa(fm, _jax_dfm(fm), reads, M=4)
    expect = [len(collect_intv(OPT, fm, r)) > 4 for r in reads]
    expect[kidx] = True
    assert ovf.tolist() == expect and 0 < sum(expect) < len(reads) - 1


def test_collect_intv_work_counts_like_the_kernel(data):
    """The plain version fills the kernel's work table: with the JAX
    package's K the K-overflow read reports cause 1, with M = 4 slots the
    reads of more than 4 intervals cause 2, the others 0; with neither
    budget in the way a read's bwt_extend calls are the oracle's rank
    queries, counted interval by interval.  ``seed_batch`` counts them on
    the CPU too."""
    fms, reads, kidx = data
    fm = fms[32]
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    qseq, qlen = so.pad_reads(reads, "cpu")
    n_intv = [len(collect_intv(OPT, fm, r)) for r in reads]
    for M, K, expect in ((so.M_SLOTS, so.K_SLOTS,
                          [int(i == kidx) for i in range(len(reads))]),
                         (4, so.K_MAX, [2 * (n > 4) for n in n_intv])):
        work = torch.zeros((len(reads), 5), dtype=torch.int32)
        iv = so.collect_intv(dfm, qseq, qlen, PARAMS, M, K, work=work)
        assert work[:, 3].tolist() == expect
        assert np.array_equal(work[:, 3].numpy() != 0, iv.ovf.numpy())
    work = torch.zeros((len(reads), 5), dtype=torch.int32)
    so.collect_intv(dfm, qseq, qlen, PARAMS, so.M_SLOTS, so.K_MAX, work=work)
    calls = []
    extend = fm.extend
    for r in reads:
        n = [0]

        def counted(x0, *args):
            n[0] += len(x0)
            return extend(x0, *args)

        fm.extend = counted
        try:
            collect_intv(OPT, fm, r)
        finally:
            del fm.extend
        calls.append(n[0])
    assert work[:, 2].tolist() == calls
    assert (work[:, 0] >= 1).all()  # a call at every start, N or not
    assert (work[:, 4] >= 1).tolist() == [bool((r < 4).any()) for r in reads]
    SEED_STATS.reset()
    seed_batch(PORT_OPT, fms["port"], reads, "cpu", K=so.K_SLOTS)
    assert (SEED_STATS.k_overflows, SEED_STATS.m_overflows) == (1, 0)
    assert SEED_STATS.smem1a_calls > 0 and SEED_STATS.extend_calls > 0


def test_sample_ks_matches_oracle():
    """bwa sample_ks on sizes around max_occ, and rows past nrows or of a
    flagged read left out."""
    rows = torch.zeros((3, 4, 5), dtype=torch.long)
    sizes = [[1, 7, 8, 9], [0, 16, 17, 3], [5, 5, 5, 5]]
    for b in range(3):
        for j in range(4):
            rows[b, j] = torch.tensor([100 * b + 10 * j, 0, sizes[b][j], j, j + 20])
    nrows = torch.tensor([4, 3, 0], dtype=torch.int32)
    nks = torch.tensor([1 + 7 + 8 + 8, 0 + 8 + 8, 0])
    flat, ks = so.sample_ks(rows, nrows, nks, 8)
    assert flat.tolist() == rows[0].tolist() + rows[1, :3].tolist()
    exp = [k for r in flat.tolist()
           for k in sample_ks(types.SimpleNamespace(x0=r[0], s=r[2]), 8)]
    assert ks.tolist() == exp


def test_seed_batch_seeds_overflowed_reads_on_host(data, monkeypatch):
    """``seed_batch`` with the JAX package's K budget: every
    read's rows equal the oracle's, the K-overflow read seeded on the host
    and counted, with the host C++ natives and without them; with its own
    budget (K_MAX) every read is seeded on the device."""
    fms, reads, kidx = data
    fm = fms["port"]
    expect = [_oracle(fms[8], r)[0] for r in reads]
    for natives, K in ((True, so.K_SLOTS), (False, so.K_SLOTS),
                       (True, so.K_MAX)):
        if not natives:
            monkeypatch.setattr(native_fm, "available", lambda: False)
        SEED_STATS.reset()
        seeds = seed_batch(PORT_OPT, fm, reads, "cpu", K=K)
        n_host = int(K == so.K_SLOTS)
        assert (SEED_STATS.device_reads, SEED_STATS.host_reads) == (
            len(reads) - n_host, n_host)
        assert SEED_STATS.launches == 0  # the CPU launches no kernel
        assert seeds.on_host.tolist() == [
            i == kidx and n_host == 1 for i in range(len(reads))]
        off = np.concatenate([[0], np.cumsum(seeds.n_intv)])
        got = [[tuple(v) for v in seeds.rows[off[i]: off[i + 1]].tolist()]
               for i in range(len(reads))]
        assert got == expect


@pytest.mark.parametrize("K", (so.K_SLOTS, so.K_MAX), ids=("k24", "kmax"))
@pytest.mark.parametrize("walk_on_device", (False, True), ids=("host_sa", "dev_sa"))
def test_seed_stage_matches_host_seed_sa(data, monkeypatch, walk_on_device, K):
    """The pipeline's seed+SA step with the seed stage on the device equals
    the host C++ step array for array; with the JAX package's K budget the
    overflowed read's rows and walks are spliced in among the device-seeded
    reads'."""
    import functools

    from bwamem_tpu_torch.engine.pipeline import SA_STATS

    fms, reads, _ = data
    monkeypatch.setattr(pipeline, "seed_batch",
                        functools.partial(seed_batch, K=K))
    eng = types.SimpleNamespace(fm=fms["port"])
    host = pipeline._seed_sa(PORT_OPT, eng, reads, ExecConfig(device="cpu"))
    SA_STATS.reset()
    got = pipeline._seed_sa(PORT_OPT, eng, reads, ExecConfig(
        device="cpu", device_seed=True, device_sa_lookup=walk_on_device))
    for g, h in zip(got, host):
        assert np.array_equal(g, h)
    if walk_on_device:
        assert SA_STATS.host_sa_rows == 0
        assert SA_STATS.device_sa_rows == len(host[3])
    else:
        assert SA_STATS.device_sa_rows == 0


def test_cpu_dispatch_launches_nothing_and_kernels_need_the_card(data):
    fms, reads, _ = data
    dfm = DeviceFMIndex.from_host(fms[8], "cpu")
    qseq, qlen = so.pad_reads(reads[:3], "cpu")
    before = dict(so.LAUNCHES)
    so.seed_sa(dfm, qseq, qlen, PARAMS)
    assert so.LAUNCHES == before
    x = torch.zeros(3, dtype=torch.int32)
    for call in (lambda: so.smem1a_cuda(dfm, qseq, qlen, x, x.long()),
                 lambda: so.strategy1_cuda(dfm, qseq, qlen, x, 19, 20),
                 lambda: so.collect_intv_cuda(dfm, qseq, qlen, PARAMS),
                 lambda: so.sample_ks_cuda(torch.zeros((1, 1, 5), dtype=torch.long),
                                           x[:1], x[:1].long(), 500)):
        with pytest.raises(ValueError):
            call()
    for M, K in ((0, so.K_SLOTS), (so.M_SLOTS + 1, so.K_SLOTS),
                 (so.M_SLOTS, 0), (so.M_SLOTS, so.K_MAX + 1)):
        with pytest.raises(ValueError):
            so.collect_intv(dfm, qseq, qlen, PARAMS, M, K)
    with pytest.raises(ValueError):
        so.smem1a(dfm, qseq, qlen, x, x.long(), so.K_MAX + 1)
