"""The port's BwaMemAligner (extension waves, and with ``device_stages`` the
seeding, the SA walks and the chaining, on the CPU through the plain PyTorch
versions) against bwamem_tpu's host aligner: equal records, read for read
and field for field, on a synthetic genome and on the golden rotavirus
reads.  Each package opens its own index on the same image.  A CPU aligner
with no device stage takes the whole-batch host route; the tests of the
wave driver set ``force_waves`` (``_waves``) to keep it on the waves."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import bwamem_tpu
from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex, BwaMemPairEndStats
from bwamem_tpu_torch.engine import native_chain, native_fm
from bwamem_tpu_torch.engine.extend_batch import STATS
from bwamem_tpu_torch.engine.pipeline import CHAIN_STATS, SA_STATS
from bwamem_tpu_torch.engine.seed_device import SEED_STATS
from bwamem_tpu_torch.index import image
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.ops import chain as chainops
from bwamem_tpu_torch.ops import extend as ext
from bwamem_tpu_torch.ops import seed as seedops
from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig
from bwamem_tpu_torch.utils.synth import simulate_pairs, synthetic_genome

ROTAVIRUS = os.path.join(os.path.dirname(__file__), "fixtures",
                         "rotavirus.bwa.img")
# BwaMemIndexTest.java's reads (tests/test_api_golden.py)
READ_L1 = b"GGCTTTTAATGCTTTTCAGTGGTTGCTGCTCAAGATGGAGTCTACTCAGCAGATGGTAAGCTCTATTATT"
READ_SNV = b"GGCTTTTAATGCTTTTCAGTGCTAGGTGCTCAAGATGGAGTCTACTCAGCAGATGGTAAGCTCTATTATT"
READ_RC = b"AATAATAGAGCTTACCATCTGCTGAGTAGACTCCATCTTGAGCAGCAACCACTGAAAAGCATTAAAAGCC"
READ_DEL = b"AATACTTCTTTTGAAGCTGCAGTTGTTGCTGCCTTCAACATTAGAATTAATGGGTATTCAATATGATT"
READ_P2 = b"TTGTTTTTAACACCAGAGTCATCCATCACATAATCAAATTTACTTTTAACTCTGGTAAATACTTCATTGT"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version's small row ops lose to thread start-up, and the
    suite runs several workers at once: keep torch to one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _waves(aligner):
    """``aligner`` with its extension in the cross-read waves (the
    reference's ``force_waves``), not the whole-batch host route."""
    aligner._exec_cfg = dataclasses.replace(aligner._exec_cfg, force_waves=True)
    return aligner


def _records(aligner, reads):
    return [[vars(a) for a in r] for r in aligner.align_seqs(reads)]


HostAligner = bwamem_tpu.BwaMemAligner


class _Indexes:
    """One image opened by each package: ``port`` for the port's aligner,
    ``ref`` for bwamem_tpu's."""

    def __init__(self, path):
        self.port = BwaMemIndex(path)
        self.ref = bwamem_tpu.BwaMemIndex(path)

    def close(self):
        self.port.close()
        self.ref.close()


def _pe_mode(aligner, mode, stats=(350, 35)):
    aligner.align_pairs()
    if mode == "fixed":
        stats_cls = (BwaMemPairEndStats if isinstance(aligner, BwaMemAligner)
                     else bwamem_tpu.BwaMemPairEndStats)
        aligner.set_proper_pair_end_stats(stats_cls.of(*stats))
    elif mode == "none":
        aligner.dont_infer_pair_end_stats()


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    codes = synthetic_genome(200_000, np.random.default_rng(7))
    img = str(tmp_path_factory.mktemp("g") / "g.img")
    image.write_image(img, build_index(Fasta([FastaContig("chr", "", codes)])))
    index = _Indexes(img)
    yield index, simulate_pairs(codes, np.random.default_rng(9), 200)
    index.close()


@pytest.mark.parametrize("mode", ["se", "inferred", "fixed"])
def test_records_match_host_aligner(genome, mode):
    index, reads = genome
    host = HostAligner(index.ref)
    port = _waves(BwaMemAligner(index.port, device="cpu", min_device_jobs=1))
    if mode != "se":
        _pe_mode(host, mode)
        _pe_mode(port, mode)
    STATS.reset()
    before = ext.LAUNCHES
    got = _records(port, reads)
    assert ext.LAUNCHES == before  # the CPU never launches the kernel
    assert STATS.device_extend_jobs > 0 and STATS.host_extend_jobs == 0
    assert got == _records(host, reads)


@pytest.mark.parametrize("mode", ["se", "fixed"])
def test_device_sa_lookup_matches_host_aligner(genome, mode):
    """device_stages=("sa_lookup",): every SA walk of the batch through the
    port's plain walk on the CPU, none on the host C++."""
    index, reads = genome
    host = HostAligner(index.ref)
    port = BwaMemAligner(index.port, device="cpu", min_device_jobs=1,
                         device_stages=("sa_lookup",))
    if mode != "se":
        _pe_mode(host, mode)
        _pe_mode(port, mode)
    SA_STATS.reset()
    got = _records(port, reads)
    assert SA_STATS.device_sa_rows > 0 and SA_STATS.host_sa_rows == 0
    assert got == _records(host, reads)


def test_device_sa_lookup_in_the_python_oracle_branch(genome, monkeypatch):
    """Without the native libraries the Python seeding oracle feeds the
    same device SA stage."""
    index, reads = genome
    expected = _records(HostAligner(index.ref), reads[:24])
    monkeypatch.setattr(native_fm, "available", lambda: False)
    monkeypatch.setattr(native_chain, "available", lambda: False)
    port = BwaMemAligner(index.port, device="cpu", min_device_jobs=1,
                         device_stages=("sa_lookup",))
    SA_STATS.reset()
    assert _records(port, reads[:24]) == expected
    assert SA_STATS.device_sa_rows > 0 and SA_STATS.host_sa_rows == 0


@pytest.mark.parametrize("natives", [True, False], ids=("native", "python"))
@pytest.mark.parametrize("stages", [("seed",), ("seed", "sa_lookup")],
                         ids=("seed", "seed_sa"))
def test_device_seed_matches_host_aligner(genome, monkeypatch, stages, natives):
    """device_stages with "seed": every read seeded by the port's plain
    seeding on the CPU (no read of this genome overflows a budget), the SA
    walks on the host or through the port's plain walk; with the host C++
    natives, and without them (the Python seeding and chaining branch)."""
    index, reads = genome
    if not natives:
        reads = reads[:24]
    host = HostAligner(index.ref)
    port = BwaMemAligner(index.port, device="cpu", min_device_jobs=1,
                         device_stages=stages)
    for a in (host, port):
        _pe_mode(a, "fixed")
    expected = _records(host, reads)
    if not natives:
        monkeypatch.setattr(native_fm, "available", lambda: False)
        monkeypatch.setattr(native_chain, "available", lambda: False)
    SEED_STATS.reset()
    SA_STATS.reset()
    before = dict(seedops.LAUNCHES)
    got = _records(port, reads)
    assert seedops.LAUNCHES == before  # the CPU never launches the kernels
    assert (SEED_STATS.device_reads, SEED_STATS.host_reads) == (len(reads), 0)
    if "sa_lookup" in stages:
        assert SA_STATS.device_sa_rows > 0 and SA_STATS.host_sa_rows == 0
    else:
        assert SA_STATS.device_sa_rows == 0 and SA_STATS.host_sa_rows > 0
    assert got == expected


def test_sa_walks_stay_on_host_by_default(genome):
    index, reads = genome
    SA_STATS.reset()
    BwaMemAligner(index.port, device="cpu").align_seqs(reads[:20])
    assert SA_STATS.host_sa_rows > 0 and SA_STATS.device_sa_rows == 0


@pytest.mark.parametrize("natives", [True, False], ids=("native", "python"))
@pytest.mark.parametrize(
    "stages", [("chain",), ("seed", "chain"), ("sa_lookup", "chain"),
               ("seed", "sa_lookup", "chain")],
    ids=("chain", "seed_chain", "sa_chain", "all"))
def test_device_chain_matches_host_aligner(genome, monkeypatch, stages, natives):
    """device_stages with "chain": every read chained by the port's plain
    chaining on the CPU (no read of this genome needs more than 128 chain
    slots), alone and after the device seed and SA stages; with the host C++
    natives, and without them (the Python seeding oracle)."""
    index, reads = genome
    if not natives:
        reads = reads[:24]
    host = HostAligner(index.ref)
    port = BwaMemAligner(index.port, device="cpu", min_device_jobs=1,
                         device_stages=stages)
    for a in (host, port):
        _pe_mode(a, "fixed")
    expected = _records(host, reads)
    if not natives:
        monkeypatch.setattr(native_fm, "available", lambda: False)
        monkeypatch.setattr(native_chain, "available", lambda: False)
    CHAIN_STATS.reset()
    SA_STATS.reset()
    before = dict(chainops.LAUNCHES)
    got = _records(port, reads)
    assert chainops.LAUNCHES == before  # the CPU never launches the kernels
    assert (CHAIN_STATS.device_reads, CHAIN_STATS.host_reads) == (len(reads), 0)
    assert CHAIN_STATS.c_overflows == 0
    if "sa_lookup" in stages:
        assert SA_STATS.device_sa_rows > 0 and SA_STATS.host_sa_rows == 0
    assert got == expected


def test_device_chain_single_end(genome):
    index, reads = genome
    port = BwaMemAligner(index.port, device="cpu", min_device_jobs=1,
                         device_stages=("seed", "sa_lookup", "chain"))
    assert _records(port, reads[:60]) == _records(HostAligner(index.ref),
                                                 reads[:60])


@pytest.mark.parametrize("stages", [("extend",), ("seed", "extend"),
                                    ("pipeline",), ("Chain",)])
def test_device_stages_the_port_lacks_raise(rotavirus, stages):
    """Only "seed", "sa_lookup" and "chain" name a device stage."""
    with pytest.raises(ValueError):
        BwaMemAligner(rotavirus.port, device="cpu", device_stages=stages)


def test_default_threshold_routes_small_waves_to_host(genome):
    index, reads = genome
    port = _waves(BwaMemAligner(index.port, device="cpu"))
    STATS.reset()
    got = _records(port, reads[:40])
    assert STATS.host_extend_jobs > 0 and STATS.device_extend_jobs == 0
    assert got == _records(HostAligner(index.ref), reads[:40])


@pytest.fixture(scope="module")
def rotavirus():
    index = _Indexes(ROTAVIRUS)
    yield index
    index.close()


def test_golden_single_end(rotavirus):
    reads = [READ_L1, READ_SNV, READ_RC, READ_DEL]
    port = _waves(BwaMemAligner(rotavirus.port, device="cpu", min_device_jobs=1))
    got = port.align_seqs(reads)
    assert [len(r) for r in got] == [1, 1, 1, 1]
    assert [(a[0].ref_start, a[0].ref_end, a[0].cigar, a[0].n_mismatches,
             a[0].sam_flag) for a in got] == [
        (0, 70, "70M", 0, 0), (0, 70, "70M", 3, 0), (0, 70, "70M", 0, 0x10),
        (70, 140, "32M2D36M", 2, 0)]
    assert [[vars(a) for a in r] for r in got] == _records(
        HostAligner(rotavirus.ref), reads)


@pytest.mark.parametrize("mode", ["inferred", "fixed", "none"])
def test_golden_pair(rotavirus, mode):
    port = _waves(BwaMemAligner(rotavirus.port, device="cpu", min_device_jobs=1))
    host = HostAligner(rotavirus.ref)
    for a in (port, host):  # BwaMemIndexTest.java's stats for this pair
        _pe_mode(a, mode, stats=(200, 10, 1, 600))
    got = port.align_seqs([READ_L1, READ_P2])
    a0, a1 = got[0][0], got[1][0]
    assert (a0.ref_start, a0.mate_ref_start, a0.template_len) == (0, 140, 210)
    assert (a1.ref_start, a1.mate_ref_start, a1.template_len) == (140, 0, -210)
    assert a0.sam_flag == (0x63 if mode == "fixed" else 0x61)
    assert [[vars(a) for a in r] for r in got] == _records(
        host, [READ_L1, READ_P2])


def test_cuda_device_without_card_raises(rotavirus):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        BwaMemAligner(rotavirus.port, device="cuda")


def test_device_is_required(rotavirus):
    """``device`` defaults to the card: without one the aligner raises and
    does not fall back to the CPU; with one it is a card aligner on the
    fused path."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            BwaMemAligner(rotavirus.port)
        return
    cfg = BwaMemAligner(rotavirus.port)._exec_cfg
    assert cfg.device.type == "cuda" and cfg.device_pipeline
