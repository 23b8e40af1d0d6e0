"""The port's binary wire codec (api/wire.py, the reference's buffer
layouts) and ``BwaMemAligner.align_seqs_packed`` against the JAX package's,
on the rotavirus fixture image: round trips of the sequence and contig-name
buffers, the packed records equal to the object API's, and the packed bytes
equal to the JAX aligner's on SE and PE batches, unmapped reads included,
through the host whole-batch route and the plain versions of the staged and
fused device routes on the CPU."""
import struct

import numpy as np
import pytest

import bwamem_tpu
from bwamem_tpu.api import wire as j_wire
from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex, BwaMemPairEndStats
from bwamem_tpu_torch.api import wire
from test_torch_sam import ROTAVIRUS, rotavirus_genome

READ_L1 = b"GGCTTTTAATGCTTTTCAGTGGTTGCTGCTCAAGATGGAGTCTACTCAGCAGATGGTAAGCTCTATTATT"
READ_P2 = b"TTGTTTTTAACACCAGAGTCATCCATCACATAATCAAATTTACTTTTAACTCTGGTAAATACTTCATTGT"
ROUTES = {"host": {}, "staged": dict(device_stages=("seed", "sa_lookup", "chain")),
          "fused": dict(device_pipeline=True)}


@pytest.fixture(scope="module")
def index():
    idx = BwaMemIndex(ROTAVIRUS)
    yield idx
    idx.close()


@pytest.fixture(scope="module")
def jax_index():
    idx = bwamem_tpu.BwaMemIndex(ROTAVIRUS)
    yield idx
    idx.close()


def _batch(n_pairs=24, seed=3):
    """Pairs from the rotavirus genome (insert 180-300, one substitution a
    read, so that every read is extended) with a few junk reads that map
    nowhere."""
    fwd = rotavirus_genome()
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_pairs):
        isize = int(rng.integers(180, 300))
        s = int(rng.integers(0, len(fwd) - isize - 1))
        r1, r2 = fwd[s: s + 70], (3 - fwd[s + isize - 70: s + isize])[::-1]
        r1, r2 = r1.copy(), r2.copy()
        for r in (r1, r2):
            k = int(rng.integers(5, 65))
            r[k] = (r[k] + 1) % 4
        if i % 7 == 3:
            r2 = rng.integers(0, 4, 70)
        out += [bases[r1].tobytes(), bases[r2].tobytes()]
    return out


def test_seq_buffer_roundtrip():
    seqs = [b"ACGT", b"", b"TTTTTT"]
    buf = wire.encode_seqs(seqs)
    assert buf[:4] == struct.pack("<i", 3)
    assert buf == j_wire.encode_seqs(seqs)
    assert wire.decode_seqs(buf) == seqs
    with pytest.raises(ValueError):
        wire.encode_seqs([b"AC\x00GT"])


def test_contig_names_roundtrip(index):
    names = index.get_reference_contig_names()
    buf = wire.encode_contig_names(names)
    assert buf == j_wire.encode_contig_names(names)
    assert struct.unpack_from("<i", buf, 0)[0] == 1
    assert struct.unpack_from("<i", buf, 4)[0] == len("rotavirus")
    assert wire.decode_contig_names(buf) == ["rotavirus"]


def test_packed_alignment_matches_object_api(index, jax_index):
    aligners = [BwaMemAligner(index, device="cpu"),
                bwamem_tpu.BwaMemAligner(jax_index)]
    for a in aligners:
        a.align_pairs()
        a.set_proper_pair_end_stats(BwaMemPairEndStats.of(200, 10, 1, 600))
    port = aligners[0]
    obj = port.align_seqs([READ_L1, READ_P2])
    buf = port.align_seqs_packed(wire.encode_seqs([READ_L1, READ_P2]))
    dec = wire.decode_alignments(buf, 2)
    assert [[vars(g) for g in r] for r in dec] == [[vars(e) for e in r]
                                                   for r in obj]
    assert buf == aligners[1].align_seqs_packed(
        j_wire.encode_seqs([READ_L1, READ_P2]))


def test_packed_unmapped_and_se(index, jax_index):
    rng = np.random.default_rng(3)
    junk = bytes(np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 70)])
    port = BwaMemAligner(index, device="cpu")
    obj = port.align_seqs([READ_L1, junk])
    buf = port.align_seqs_packed(wire.encode_seqs([READ_L1, junk]))
    dec = wire.decode_alignments(buf, 2)
    assert vars(dec[0][0]) == vars(obj[0][0])
    assert dec[1][0].sam_flag & 0x4 and vars(dec[1][0]) == vars(obj[1][0])
    assert buf == bwamem_tpu.BwaMemAligner(jax_index).align_seqs_packed(
        j_wire.encode_seqs([READ_L1, junk]))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("mode", ("se", "pe"))
def test_packed_bytes_equal_the_jax_aligners(index, jax_index, mode, route):
    seqs = _batch()
    port = BwaMemAligner(index, device="cpu", min_device_jobs=1, **ROUTES[route])
    ref = bwamem_tpu.BwaMemAligner(jax_index)
    if mode == "pe":
        for a in (port, ref):
            a.align_pairs()
    got = port.align_seqs_packed(wire.encode_seqs(seqs))
    want = ref.align_seqs_packed(j_wire.encode_seqs(seqs))
    assert got == want
    dec = wire.decode_alignments(got, len(seqs))
    assert any(r[0].sam_flag & 0x4 for r in dec)  # the junk reads
    assert sum(1 for r in dec if not r[0].sam_flag & 0x4) >= len(seqs) * 0.8
