"""The port on the card: the CUDA kernels (SW extension, occ4, bwt_extend,
SA walk, op probe) against their plain PyTorch versions on the same CUDA
tensors, exactly, the FM kernels also against the host FMIndex, and the
aligner with device="cuda" (with and without the device SA stage) against
bwamem_tpu's host aligner.

Imports nothing of JAX, so that it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Skipped where torch.cuda.is_available() is false (checked at test time).
"""
import numpy as np
import pytest
import torch

from bwamem_tpu_torch.benchmarks import op_probe
from bwamem_tpu_torch.ops import extend as ext
from bwamem_tpu_torch.ops import fmindex as fmops
from bwamem_tpu_torch.utils.extend_cases import ARRAYS, CASES, jobs, make_case

needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernel_matches_plain(name):
    case = make_case(name)
    args = [torch.from_numpy(case[k]).cuda() for k in ARRAYS]
    before = ext.LAUNCHES
    got = ext.ksw_extend(*args, **case["statics"])
    assert ext.LAUNCHES == before + 1
    plain = ext.ksw_extend_torch(*args, **case["statics"])
    for k in ext.KEYS:
        assert torch.equal(got[k], plain[k]), k


@pytest.mark.cuda
@needs_card
def test_cuda_wave_entry_matches_host_ksw():
    from bwamem_tpu.api.options import MemOptions
    from bwamem_tpu.engine import native_ksw
    from bwamem_tpu_torch.engine.state import device_scoring

    case = make_case("edges")
    js, h0s, ws, bons = jobs(case)
    opt = MemOptions()
    got = ext.ksw_extend_batch_np([q for q, _ in js], [t for _, t in js],
                                  device_scoring(opt, "cuda"), h0s, ws, bons)
    host = native_ksw.extend_batch(js, opt.mat, opt.o_del, opt.e_del, opt.o_ins,
                                   opt.e_ins, opt.zdrop, h0s, ws, bons)
    assert got == host


@pytest.fixture(scope="module", params=(8, 32), ids=("intv8", "intv32"))
def host_fm(request):
    from bwamem_tpu.engine.fmindex import FMIndex
    from bwamem_tpu.index.build import build_index
    from bwamem_tpu.utils.fasta import Fasta, FastaContig

    rng = np.random.default_rng(44)
    codes = rng.integers(0, 4, 20000).astype(np.uint8)
    codes[5000:5300] = codes[100:400]
    return FMIndex(build_index(Fasta([FastaContig("c", "", codes)]),
                               sa_intv=request.param))


def _rows(fm, lo, n, seed):
    rng = np.random.default_rng(seed)
    edges = [0, 1, fm.primary - 1, fm.primary, fm.primary + 1, fm.seq_len - 1,
             fm.seq_len] + ([-1] if lo < 0 else [])
    return np.concatenate([edges, rng.integers(lo, fm.seq_len + 1, n)])


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("span", (128, 256, 512))
def test_cuda_fm_kernels_match_plain_and_host(host_fm, span):
    fm = host_fm
    dfm = fmops.DeviceFMIndex.from_host(fm, "cuda", span=span)
    ks = _rows(fm, -1, 5000, 1)
    kt = torch.from_numpy(ks).cuda()
    before = dict(fmops.LAUNCHES)
    got = fmops.occ4(dfm, kt)
    assert torch.equal(got, fmops.occ4_torch(dfm, kt))
    assert np.array_equal(got.cpu().numpy(), fm.occ4(ks))
    rows = _rows(fm, 0, 5000, 2)
    rt = torch.from_numpy(rows).cuda()
    got = fmops.sa_lookup(dfm, rt)
    assert torch.equal(got, fmops.sa_lookup_torch(dfm, rt))
    assert np.array_equal(got.cpu().numpy(), fm.sa_lookup(rows))
    rng = np.random.default_rng(3)
    x0, x1, s = fm.set_intv(rng.integers(0, 4, 2000))
    for is_back in (False, True, False, True):
        args = [torch.from_numpy(np.asarray(a, np.int64)).cuda()
                for a in (x0, x1, s)]
        got = fmops.extend(dfm, *args, is_back)
        plain = fmops.extend_torch(dfm, *args, is_back)
        exp = fm.extend(x0, x1, s, is_back)
        for g, p_, e in zip(got, plain, exp):
            assert torch.equal(g, p_)
            assert np.array_equal(g.cpu().numpy(), e)
        c = rng.integers(0, 4, len(x0))
        ar = np.arange(len(x0))
        keep = exp[2][ar, c] > 0
        x0 = np.where(keep, exp[0][ar, c], x0)
        x1 = np.where(keep, exp[1][ar, c], x1)
        s = np.where(keep, exp[2][ar, c], s)
    assert {k: fmops.LAUNCHES[k] - before[k] for k in before} == {
        "occ4": 1, "bwt_extend": 4, "sa_lookup": 1}


@pytest.mark.cuda
@needs_card
def test_cuda_fm_kernels_raise_on_bad_rows(host_fm):
    import dataclasses

    fm = host_fm
    dfm = fmops.DeviceFMIndex.from_host(fm, "cuda")
    with pytest.raises(ValueError):
        fmops.occ4_cuda(dfm, torch.tensor([0, fm.seq_len + 1], device="cuda"))
    with pytest.raises(ValueError):
        fmops.sa_lookup_cuda(dfm, torch.tensor([-1], device="cuda"))
    # an all-A BWT with L2[0] = -1 and no sentinel row maps k to k: the
    # walk never reaches a sample and stops after seq_len steps
    L2 = dfm.L2.clone()
    L2[0] = -1
    broken = dataclasses.replace(dfm, lines=torch.zeros_like(dfm.lines), L2=L2,
                                 primary=fm.seq_len + 1)
    with pytest.raises(RuntimeError):
        fmops.sa_lookup_cuda(broken, torch.tensor([5], device="cuda"))


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("name", [p.name for p in op_probe.PROBES])
def test_cuda_op_probe_matches_plain(name):
    p = next(q for q in op_probe.PROBES if q.name == name)
    x = torch.from_numpy(np.random.default_rng(5).integers(
        -5000, 5000, p.shape)).to(p.dtype).cuda()
    before = op_probe.LAUNCHES
    got = op_probe.run_probe(p, x, 64)
    assert op_probe.LAUNCHES == before + 1
    assert torch.equal(got, op_probe.probe_torch(p, x, 64))


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("stages", [(), ("sa_lookup",)], ids=("host_sa", "card_sa"))
def test_cuda_aligner_matches_host(tmp_path, stages):
    from bwamem_tpu import BwaMemAligner as HostAligner
    from bwamem_tpu import BwaMemIndex
    from bwamem_tpu.index import image
    from bwamem_tpu.index.build import build_index
    from bwamem_tpu.utils.fasta import Fasta, FastaContig
    from bwamem_tpu.utils.synth import simulate_pairs, synthetic_genome
    from bwamem_tpu_torch import BwaMemAligner
    from bwamem_tpu_torch.engine.extend_batch import STATS
    from bwamem_tpu_torch.engine.pipeline import SA_STATS

    codes = synthetic_genome(200_000, np.random.default_rng(7))
    img = str(tmp_path / "g.img")
    image.write_image(img, build_index(Fasta([FastaContig("chr", "", codes)])))
    index = BwaMemIndex(img)
    reads = simulate_pairs(codes, np.random.default_rng(9), 200)
    host = HostAligner(index)
    port = BwaMemAligner(index, device="cuda", min_device_jobs=1,
                         device_stages=stages)
    for a in (host, port):
        a.align_pairs()
    STATS.reset()
    SA_STATS.reset()
    before = ext.LAUNCHES
    sa_before = fmops.LAUNCHES["sa_lookup"]
    got = port.align_seqs(reads)
    assert ext.LAUNCHES - before == STATS.device_extend_waves > 0
    if stages:
        assert fmops.LAUNCHES["sa_lookup"] > sa_before
        assert SA_STATS.device_sa_rows > 0 and SA_STATS.host_sa_rows == 0
    else:
        assert SA_STATS.device_sa_rows == 0
    ref = host.align_seqs(reads)
    assert [[vars(a) for a in r] for r in got] == [
        [vars(a) for a in r] for r in ref]
    index.close()
