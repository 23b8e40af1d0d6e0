"""bench.py's "midlen" configuration at a small size: pairs of 300 bases,
insert 700 (fixed PE statistics 700 +- 70, as the bench sets them), on a
200 kbp genome of the bench's generator.  The port's aligner on the CPU,
on the whole-batch host route and on every route its plain versions serve
(the waves, the device seed and SA stages, all three device stages, the
fused path), against
bwamem_tpu's aligner: equal records, read for read and field for field,
paired and single-end.  Both packages open the one image."""
import dataclasses

import numpy as np
import pytest
import torch

import bwamem_tpu
from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex, BwaMemPairEndStats
from bwamem_tpu_torch.engine.pipeline_device import FUSED_STATS
from bwamem_tpu_torch.engine.seed_device import SEED_STATS
from bwamem_tpu_torch.index import image
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig
from bwamem_tpu_torch.utils.synth import simulate_pairs, synthetic_genome

READ_LEN, ISIZE, N_PAIRS = 300, 700, 16
ALL = ("seed", "sa_lookup", "chain")
ROUTES = {"host": {}, "waves": dict(force_waves=True),
          "staged": dict(device_stages=ALL),
          "seed_sa": dict(device_stages=("seed", "sa_lookup")),
          "fused": dict(device_pipeline=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def midlen(tmp_path_factory):
    """The image opened by each package, and the reads: 16 pairs of 300
    bases and, as the bench draws them, from the same generator."""
    rng = np.random.default_rng(1234)
    codes = synthetic_genome(200_000, rng)
    path = str(tmp_path_factory.mktemp("midlen") / "midlen.img")
    image.write_image(path, build_index(Fasta([FastaContig("chr", "", codes)]),
                                        sa_intv=8))
    reads = simulate_pairs(codes, np.random.default_rng(1235), N_PAIRS,
                           read_len=READ_LEN, isize_mean=ISIZE)
    port, ref = BwaMemIndex(path), bwamem_tpu.BwaMemIndex(path)
    yield port, ref, reads
    port.close()
    ref.close()


def _aligner(index, route):
    opts = dict(ROUTES[route])
    waves = opts.pop("force_waves", False)
    a = BwaMemAligner(index, device="cpu", min_device_jobs=1, **opts)
    if waves:
        a._exec_cfg = dataclasses.replace(a._exec_cfg, force_waves=True)
    return a


def _pe(a, cls):
    a.align_pairs()
    a.set_proper_pair_end_stats(cls.of(ISIZE, ISIZE // 10))
    return a


def _records(recs):
    return [[vars(a) for a in r] for r in recs]


@pytest.mark.parametrize("mode", ("pe", "se"))
@pytest.mark.parametrize("route", ROUTES)
def test_midlen_records_match_the_reference(midlen, route, mode):
    port_idx, ref_idx, reads = midlen
    ref = bwamem_tpu.BwaMemAligner(ref_idx)
    port = _aligner(port_idx, route)
    if mode == "pe":
        _pe(ref, bwamem_tpu.BwaMemPairEndStats)
        _pe(port, BwaMemPairEndStats)
    FUSED_STATS.reset()
    SEED_STATS.reset()
    want = _records(ref.align_seqs(reads))
    got = _records(port.align_seqs(reads))
    assert got == want
    assert {len(r) for r in reads} == {READ_LEN}
    mapped = sum(1 for r in got if not r[0]["sam_flag"] & 0x4)
    assert mapped == len(reads)
    if route == "fused":
        fs = FUSED_STATS
        assert fs.device_reads + fs.host_reads == len(reads)
        assert fs.host_reads == (fs.host_seeded + fs.c_overflows
                                 + fs.fcs_reads + fs.long_reads)
        assert fs.fcs_reads == 0  # 5.5 ln 300 > 0.05 x 300: fcs is a no-op
    if route in ("fused", "staged", "seed_sa"):
        assert SEED_STATS.device_reads + SEED_STATS.host_reads == len(reads)
        assert SEED_STATS.host_reads == (SEED_STATS.k_overflows
                                         + SEED_STATS.m_overflows)

