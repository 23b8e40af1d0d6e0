"""The port's SAM text (api/sam.py, mem_aln2sam semantics) against the JAX
package's, on the rotavirus fixture image: the header, forward and reverse
lines, an unmapped read, a supplementary record's hard clip and a
secondary record, each line the JAX package's string for string; and the
byte-level snapshot: the port's ``mem`` (``python -m bwamem_tpu_torch``, a
fresh interpreter) on the four golden reads prints exactly
``tests/test_sam_snapshot.py``'s ``EXPECTED`` lines.  The rotavirus FASTA is
written from the image's own pac."""
import copy
import os
import subprocess
import sys

import numpy as np
import pytest

import bwamem_tpu
from bwamem_tpu.api import sam as j_sam
import bwamem_tpu_torch
from bwamem_tpu_torch import BwaMemIndex
from bwamem_tpu_torch.api import sam as p_sam
from bwamem_tpu_torch.api.options import MEM_F_ALL, MEM_F_SOFTCLIP, MemOptions
from bwamem_tpu_torch.utils.encoding import revcomp_codes, seq_to_codes
from test_sam_snapshot import EXPECTED

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROTAVIRUS = os.path.join(ROOT, "tests", "fixtures", "rotavirus.bwa.img")
READ_L1 = "GGCTTTTAATGCTTTTCAGTGGTTGCTGCTCAAGATGGAGTCTACTCAGCAGATGGTAAGCTCTATTATT"


def rotavirus_genome() -> np.ndarray:
    """The rotavirus image's forward strand, codes 0-3."""
    index = BwaMemIndex(ROTAVIRUS)
    idx = index._require().idx
    fwd = np.asarray(idx.get_seq(0, idx.bns.l_pac), dtype=np.uint8)
    index.close()
    return fwd


def write_rotavirus_fasta(path) -> np.ndarray:
    """The rotavirus FASTA from the image's pac; returns its codes."""
    fwd = rotavirus_genome()
    seq = "".join("ACGTN"[c] for c in fwd)
    with open(path, "w") as fh:
        fh.write(">rotavirus\n")
        for i in range(0, len(seq), 70):
            fh.write(seq[i: i + 70] + "\n")
    return fwd


class Side:
    """One package's index, engine records and SAM emitter."""

    def __init__(self, top, sam):
        self.index = top.BwaMemIndex(ROTAVIRUS)
        self.top, self.sam = top, sam
        self.anns = self.index._require().idx.bns.anns

    def records(self, codes):
        """The engine records of one read, single-end, on the host."""
        a = (self.top.BwaMemAligner(self.index) if self.top is bwamem_tpu
             else self.top.BwaMemAligner(self.index, device="cpu"))
        seq = "".join("ACGTN"[c] for c in codes).encode()
        return [p for p, _ in a.align_seqs_raw([seq])[0]]

    def line(self, opt, name, codes, qual, aln, which):
        return self.sam.aln2sam(opt, self.anns, name, codes, qual, aln, which)


@pytest.fixture(scope="module")
def sides():
    out = (Side(bwamem_tpu, j_sam), Side(bwamem_tpu_torch, p_sam))
    yield out
    for s in out:
        s.index.close()


def _lines(sides, codes, qual=None, opt=None, which=0, name="r", edit=None):
    """Line ``which`` of the read on each side (the port's last), after
    ``edit`` of the record; the two must be equal."""
    opt = opt or MemOptions()
    got = []
    for s in sides:
        alns = s.records(codes)
        aln = copy.deepcopy(alns[which])
        if edit:
            edit(aln)
        got.append(s.line(opt, name, codes, qual, aln, which))
    assert got[0] == got[1]
    return got[1]


def test_header(sides):
    hdr = p_sam.sam_header(sides[1].anns)
    assert hdr == j_sam.sam_header(sides[0].anns)
    assert hdr.startswith("@SQ\tSN:rotavirus\tLN:1074\n")
    assert "@PG\tID:bwamem_tpu" in hdr


def test_simple_sam_line(sides):
    line = _lines(sides, seq_to_codes(READ_L1), name="read1")
    f = line.split("\t")
    assert f[:9] == ["read1", "0", "rotavirus", "1", "60", "70M", "*", "0", "0"]
    assert f[9] == READ_L1 and f[10] == "*"
    assert "NM:i:0" in line and "MD:Z:70" in line and "AS:i:70" in line
    assert "XS:i:0" in line


def test_reverse_strand_seq_flipped(sides):
    rc = revcomp_codes(seq_to_codes(READ_L1))
    f = _lines(sides, rc, qual="I" * 70).split("\t")
    assert int(f[1]) & 0x10
    assert f[9] == READ_L1 and f[10] == "I" * 70  # forward-strand SEQ


def test_unmapped_line(sides):
    codes = np.random.default_rng(5).integers(0, 4, 70).astype(np.uint8)
    f = _lines(sides, codes, name="u").split("\t")
    assert f[1] == "4" and f[2] == "*" and f[3] == "0" and f[5] == "*"


@pytest.mark.parametrize("softclip", (False, True), ids=("hard", "soft"))
def test_supplementary_hard_clip(sides, softclip):
    """A chimeric read (two halves from distant loci): its supplementary
    record hard-clips and trims SEQ, unless MEM_F_SOFTCLIP."""
    fwd = rotavirus_genome()
    read = np.concatenate([fwd[0:60], fwd[500:560]])
    opt = MemOptions(flag=MEM_F_SOFTCLIP) if softclip else MemOptions()
    alns = sides[1].records(read)
    assert len(alns) >= 2 and alns[1].flag & 0x800
    line0 = _lines(sides, read, name="c", which=0)
    line1 = _lines(sides, read, opt=opt, name="c", which=1)
    assert "S" in line0.split("\t")[5]
    cig, seq = line1.split("\t")[5], line1.split("\t")[9]
    if softclip:
        assert "H" not in cig and len(seq) == len(read)
    else:
        assert "H" in cig and len(seq) < len(read)


def test_secondary_line_no_seq(sides):
    def secondary(aln):
        aln.flag |= 0x100

    f = _lines(sides, seq_to_codes(READ_L1), opt=MemOptions(flag=MEM_F_ALL),
               name="s", edit=secondary).split("\t")
    assert int(f[1]) & 0x100
    assert f[9] == "*" and f[10] == "*"


def test_sam_text_snapshot(tmp_path):
    """``python -m bwamem_tpu_torch mem ref.fa reads.fq --device cpu``
    (auto-indexing the FASTA) prints the snapshot's lines exactly."""
    fwd = write_rotavirus_fasta(tmp_path / "ref.fa")
    seq = "".join("ACGT"[c] for c in fwd)
    r1 = seq[:70]
    snv = list(r1)
    snv[9], snv[29], snv[59] = "A", "C", "G"
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rc = "".join(comp[c] for c in reversed(seq[100:170]))
    dele = seq[70:102] + seq[104:140]
    with open(tmp_path / "reads.fq", "w") as f:
        for i, s in enumerate((r1, "".join(snv), rc, dele)):
            f.write(f"@g{i}\n{s}\n+\n{'I' * len(s)}\n")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "bwamem_tpu_torch", "mem", "--device", "cpu",
         str(tmp_path / "ref.fa"), str(tmp_path / "reads.fq")],
        capture_output=True, text=True, timeout=280, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[0] == "@SQ\tSN:rotavirus\tLN:1074"
    assert lines[1].startswith("@PG\tID:bwamem_tpu")
    assert [ln for ln in lines if not ln.startswith("@")] == [
        e.format(q70="I" * 70, q68="I" * 68) for e in EXPECTED]
    assert os.path.exists(tmp_path / "ref.fa.img")
