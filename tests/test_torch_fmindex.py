"""The port's device FM index against the JAX package's and the host
oracle, exactly (integers, no tolerance): the fused lines bit for bit, and
the plain PyTorch occ4 / bwt_extend / SA walk against
``fmindex_tpu.occ4``, ``extend_device`` and ``sa_lookup`` on the CPU and
against ``engine.fmindex.FMIndex``; and the plain backward search against
``seed_tpu.backward_search_batch`` and the host FMIndex's exact match.  The
CUDA kernels are held against the plain versions in test_torch_cuda.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwamem_tpu.engine.fmindex import FMIndex
from bwamem_tpu.index.build import build_index
from bwamem_tpu.ops import fmindex_tpu as ft
from bwamem_tpu.ops import seed_tpu
from bwamem_tpu.utils.fasta import Fasta, FastaContig
from bwamem_tpu_torch.engine.state import device_fm
from bwamem_tpu_torch.ops import fmindex as fmops

SPANS = (128, 256, 512)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops lose to thread start-up, and the suite runs several
    workers at once: keep torch to one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _genome(seed, n):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    if n >= 1000:
        codes[n // 4: n // 4 + 300] = codes[100:400]  # a repeat: wide intervals
    return codes


@pytest.fixture(scope="module", params=(8, 32), ids=("intv8", "intv32"))
def fm(request):
    codes = _genome(44, 5000)
    return FMIndex(build_index(Fasta([FastaContig("c", "", codes)]),
                               sa_intv=request.param))


def _edge_rows(fm):
    return [0, 1, fm.primary - 1, fm.primary, fm.primary + 1, fm.seq_len - 1,
            fm.seq_len]


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


@pytest.mark.parametrize("span", SPANS)
def test_lines_match_jax_bit_for_bit(fm, span):
    dfm = fmops.DeviceFMIndex.from_host(fm, "cpu", span=span)
    ref = ft.DeviceFMIndex.from_host(fm, span=span)
    assert dfm.lines.dtype == torch.int32
    assert np.array_equal(dfm.lines.numpy(),
                          np.asarray(ref.lines).view(np.int32))
    assert dfm.L2.dtype == dfm.sa.dtype == torch.int64
    assert np.array_equal(dfm.L2.numpy(), np.asarray(ref.L2))
    assert np.array_equal(dfm.sa.numpy(), np.asarray(ref.sa))
    assert dfm.sa[0] == -1
    assert (dfm.primary, dfm.seq_len, dfm.sa_intv, dfm.span) == (
        ref.primary, ref.seq_len, ref.sa_intv, ref.span)


def test_int64_tables_match_jax_big_domain(fm):
    """The JAX package's int64 domain (force_big) holds the same tables
    as the port's, which is int64 at every size."""
    dfm = fmops.DeviceFMIndex.from_host(fm, "cpu")
    big = ft.DeviceFMIndex.from_host(fm, force_big=True)
    assert big.big
    assert np.array_equal(np.asarray(big.L2), dfm.L2.numpy())
    assert np.array_equal(np.asarray(big.sa), dfm.sa.numpy())
    assert np.array_equal(np.asarray(big.lines).view(np.int32),
                          dfm.lines.numpy())
    rows = np.random.default_rng(3).integers(0, fm.seq_len + 1, 256)
    rows = np.concatenate([rows, _edge_rows(fm)])
    assert np.array_equal(np.asarray(ft.sa_lookup(big, rows)),
                          fmops.sa_lookup(dfm, _t(rows)).numpy())
    assert np.array_equal(np.asarray(ft.occ4(big, rows)),
                          fmops.occ4(dfm, _t(rows)).numpy())


def test_from_host_rejects_bad_span(fm):
    for span in (64, 192, 384):
        with pytest.raises(ValueError):
            fmops.DeviceFMIndex.from_host(fm, "cpu", span=span)


@pytest.mark.parametrize("span", SPANS)
def test_occ4_matches_jax_and_host(fm, span):
    rng = np.random.default_rng(0)
    ks = np.concatenate([rng.integers(-1, fm.seq_len + 1, 2000), [-1],
                         _edge_rows(fm)]).astype(np.int64)
    dfm = fmops.DeviceFMIndex.from_host(fm, "cpu", span=span)
    got = fmops.occ4(dfm, _t(ks))
    assert got.dtype == torch.int32 and got.shape == (len(ks), 4)
    assert np.array_equal(got.numpy(), fm.occ4(ks))
    ref = ft.DeviceFMIndex.from_host(fm, span=span)
    assert np.array_equal(got.numpy(), np.asarray(ft.occ4(ref, ks)))


def _bi_intervals(fm, rng, n):
    """Bi-intervals from set_intv, then a random walk of extensions."""
    x0, x1, s = fm.set_intv(rng.integers(0, 4, n))
    out = [(x0, x1, s)]
    for is_back in (False, True, False, True):
        ex0, ex1, esz = fm.extend(x0, x1, s, is_back)
        c = rng.integers(0, 4, n)
        keep = esz[np.arange(n), c] > 0
        x0 = np.where(keep, ex0[np.arange(n), c], x0)
        x1 = np.where(keep, ex1[np.arange(n), c], x1)
        s = np.where(keep, esz[np.arange(n), c], s)
        out.append((x0, x1, s))
    x0, x1, s = (np.concatenate(v) for v in zip(*out))
    # intervals around the sentinel row, and the whole matrix
    p = fm.primary
    extra = np.array([[p, p, 1], [p - 1, 3, 3], [p + 1, 5, 2],
                      [0, 0, fm.seq_len + 1], [1, 1, 0]], dtype=np.int64)
    return (np.concatenate([x0, extra[:, 0]]), np.concatenate([x1, extra[:, 1]]),
            np.concatenate([s, extra[:, 2]]))


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("is_back", (True, False), ids=("back", "fwd"))
def test_extend_matches_jax_and_host(fm, span, is_back):
    rng = np.random.default_rng(1)
    x0, x1, s = _bi_intervals(fm, rng, 300)
    dfm = fmops.DeviceFMIndex.from_host(fm, "cpu", span=span)
    got = fmops.extend(dfm, _t(x0), _t(x1), _t(s), is_back)
    assert [g.dtype for g in got] == [torch.int64, torch.int64, torch.int32]
    exp = fm.extend(x0, x1, s, is_back)
    ref = ft.DeviceFMIndex.from_host(fm, span=span)
    jx = ft.extend_device(ref.lines, ref.L2, jnp.asarray(x0, jnp.int32),
                          jnp.asarray(x1, jnp.int32), jnp.asarray(s, jnp.int32),
                          primary=ref.primary, seq_len=ref.seq_len,
                          span=ref.span, is_back=is_back)
    for g, e, j in zip(got, exp, jx):
        assert np.array_equal(g.numpy(), e)
        assert np.array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize("span", SPANS)
def test_sa_lookup_matches_host(fm, span):
    rng = np.random.default_rng(2)
    ks = np.concatenate([_edge_rows(fm), rng.integers(0, fm.seq_len + 1, 600)])
    dfm = fmops.DeviceFMIndex.from_host(fm, "cpu", span=span)
    got = fmops.sa_lookup(dfm, _t(ks))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), fm.sa_lookup(ks))


def test_sa_lookup_matches_jax(fm):
    rng = np.random.default_rng(4)
    ks = np.concatenate([_edge_rows(fm), rng.integers(0, fm.seq_len + 1, 505)])
    dfm = fmops.DeviceFMIndex.from_host(fm, "cpu")
    ref = ft.DeviceFMIndex.from_host(fm)
    assert np.array_equal(fmops.sa_lookup(dfm, _t(ks)).numpy(),
                          np.asarray(ft.sa_lookup(ref, ks.astype(np.int32))))


def test_rows_outside_the_index_raise(fm):
    dfm = fmops.DeviceFMIndex.from_host(fm, "cpu")
    for bad in (-2, fm.seq_len + 1):
        with pytest.raises(ValueError):
            fmops.occ4(dfm, _t([0, bad]))
    for bad in (-1, fm.seq_len + 1):
        with pytest.raises(ValueError):
            fmops.sa_lookup(dfm, _t([bad]))
    with pytest.raises(ValueError):  # xq - 1 + s past seq_len
        fmops.extend(dfm, _t([1]), _t([1]), _t([fm.seq_len + 1]), True)


def test_walk_past_seq_len_raises():
    """A broken index whose LF steps stay on an unsampled row (an all-A
    BWT with L2[0] = -1 and no sentinel row maps k to k): the walk stops
    after seq_len steps and raises instead of returning garbage."""
    fm = FMIndex(build_index(Fasta([FastaContig("c", "", _genome(5, 60))])))
    dfm = fmops.DeviceFMIndex.from_host(fm, "cpu")
    L2 = dfm.L2.clone()
    L2[0] = -1
    broken = dataclasses.replace(dfm, lines=torch.zeros_like(dfm.lines), L2=L2,
                                 primary=fm.seq_len + 1)
    with pytest.raises(RuntimeError):
        fmops.sa_lookup(broken, _t([5]))


def test_cpu_dispatch_launches_nothing(fm):
    dfm = fmops.DeviceFMIndex.from_host(fm, "cpu")
    before = dict(fmops.LAUNCHES)
    fmops.occ4(dfm, _t([0, 5]))
    fmops.extend(dfm, _t([1]), _t([1]), _t([2]), False)
    fmops.sa_lookup(dfm, _t([0, 5]))
    assert fmops.LAUNCHES == before
    with pytest.raises(ValueError):  # the kernels take no CPU index
        fmops.sa_lookup_cuda(dfm, _t([0, 5]))


def test_device_fm_is_cached_on_the_index(fm):
    a = device_fm(fm, "cpu")
    assert device_fm(fm, torch.device("cpu")) is a
    assert np.array_equal(a.lines.numpy(),
                          fmops.DeviceFMIndex.from_host(fm, "cpu").lines.numpy())


def test_device_fm_builds_one_table_under_threads(fm):
    """Aligners on several threads share one index: the first use from
    all of them at once builds the device tables once."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    fresh = FMIndex(fm.idx)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as ex:
            got = list(ex.map(lambda _: device_fm(fresh, "cpu"), range(64),
                              timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert all(g is got[0] for g in got)
    assert list(fresh._torch_device_fms) == [torch.device("cpu")]


def _host_exact_match(fm, read):
    """bwa bwt_match_exact on the host FMIndex: the last non-empty
    interval and the bases matched from the read's end."""
    k, l, n = 0, fm.seq_len, 0
    for c in read[::-1].tolist():
        if c > 3:
            break
        k2 = int(fm.L2[c] + fm.occ(np.array([k - 1]), np.array([c]))[0] + 1)
        l2 = int(fm.L2[c] + fm.occ(np.array([l]), np.array([c]))[0])
        if k2 > l2:
            break
        k, l, n = k2, l2, n + 1
    return k, l, n


def _search_reads(fm, rng, n=48, width=40):
    """Reads of the genome of 1 to ``width`` bases: a third as they are, a
    third with one base changed (they stop early), a third with an N."""
    text = fm.idx.get_seq(0, fm.idx.bns.l_pac)
    reads = []
    for i in range(n):
        ln = int(rng.integers(1, width + 1))
        st = int(rng.integers(0, len(text) - ln))
        r = text[st: st + ln].copy()
        if i % 3 == 1:
            p = int(rng.integers(0, ln))
            r[p] = (r[p] + 1 + rng.integers(0, 3)) % 4
        elif i % 3 == 2:
            r[int(rng.integers(0, ln))] = 4
        reads.append(r.astype(np.uint8))
    return reads


def test_backward_search_matches_jax_and_host(fm):
    """``backward_search_torch`` against ``backward_search_batch`` on the
    same right-aligned reads, and against the host's exact match per read;
    sa_intv 8 and 32 (the search reads no SA sample, so both agree)."""
    reads = _search_reads(fm, np.random.default_rng(17))
    dfm = fmops.DeviceFMIndex.from_host(fm, "cpu")
    qseq, qlen = fmops.right_align_reads(reads, "cpu")
    before = dict(fmops.LAUNCHES)
    k, l, matched = fmops.backward_search(dfm, qseq, qlen)
    assert fmops.LAUNCHES == before
    assert (k.dtype, l.dtype, matched.dtype) == (
        torch.int64, torch.int64, torch.int32)
    jk, jl, jm = seed_tpu.backward_search(
        ft.DeviceFMIndex.from_host(fm), jnp.asarray(qseq.numpy(), jnp.int32),
        jnp.asarray(qlen.numpy()))
    assert np.array_equal(k.numpy(), np.asarray(jk))
    assert np.array_equal(l.numpy(), np.asarray(jl))
    assert np.array_equal(matched.numpy(), np.asarray(jm))
    host = [_host_exact_match(fm, r) for r in reads]
    assert list(zip(k.tolist(), l.tolist(), matched.tolist())) == host
    full = [m == len(r) for (_, _, m), r in zip(host, reads)]
    assert any(full) and not all(full)  # whole matches and early stops
    assert any(m < len(r) and r[len(r) - 1 - m] == 4
               for (_, _, m), r in zip(host, reads))  # stopped on an N


def test_backward_search_stops_at_qlen_and_needs_the_card(fm):
    """A ``qlen`` below the read's width stops the search there, as the
    JAX program's ``i < qlen``; the CUDA wrapper refuses CPU tensors."""
    reads = [r for r in _search_reads(fm, np.random.default_rng(18), 12)
             if len(r) > 4 and r.max() < 4]
    dfm = fmops.DeviceFMIndex.from_host(fm, "cpu")
    qseq, qlen = fmops.right_align_reads(reads, "cpu")
    short = torch.clamp(qlen - 3, min=1)
    k, l, matched = fmops.backward_search_torch(dfm, qseq, short)
    jk, jl, jm = seed_tpu.backward_search(
        ft.DeviceFMIndex.from_host(fm), jnp.asarray(qseq.numpy(), jnp.int32),
        jnp.asarray(short.numpy()))
    assert np.array_equal(k.numpy(), np.asarray(jk))
    assert np.array_equal(l.numpy(), np.asarray(jl))
    assert np.array_equal(matched.numpy(), np.asarray(jm))
    assert (matched <= short).all()
    with pytest.raises(ValueError):
        fmops.backward_search_cuda(dfm, qseq, qlen)
