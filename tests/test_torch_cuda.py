"""The port on the card: the CUDA extension kernel against the plain PyTorch
version on the same CUDA tensors, exactly, and the aligner with
device="cuda" against bwamem_tpu's host aligner.

Imports nothing of JAX, so that it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Skipped where torch.cuda.is_available() is false (checked at test time).
"""
import numpy as np
import pytest
import torch

from bwamem_tpu_torch.ops import extend as ext
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


@pytest.mark.cuda
@needs_card
def test_cuda_aligner_matches_host(tmp_path):
    from bwamem_tpu import BwaMemAligner as HostAligner
    from bwamem_tpu import BwaMemIndex
    from bwamem_tpu.index import image
    from bwamem_tpu.index.build import build_index
    from bwamem_tpu.utils.fasta import Fasta, FastaContig
    from bwamem_tpu.utils.synth import simulate_pairs, synthetic_genome
    from bwamem_tpu_torch import BwaMemAligner
    from bwamem_tpu_torch.engine.extend_batch import STATS

    codes = synthetic_genome(200_000, np.random.default_rng(7))
    img = str(tmp_path / "g.img")
    image.write_image(img, build_index(Fasta([FastaContig("chr", "", codes)])))
    index = BwaMemIndex(img)
    reads = simulate_pairs(codes, np.random.default_rng(9), 200)
    host, port = HostAligner(index), BwaMemAligner(index, device="cuda",
                                                   min_device_jobs=1)
    for a in (host, port):
        a.align_pairs()
    STATS.reset()
    before = ext.LAUNCHES
    got = port.align_seqs(reads)
    assert ext.LAUNCHES - before == STATS.device_extend_waves > 0
    ref = host.align_seqs(reads)
    assert [[vars(a) for a in r] for r in got] == [
        [vars(a) for a in r] for r in ref]
    index.close()
