"""The port stands alone: no module of bwamem_tpu_torch, and not
chip_smoke.py, imports JAX or anything of bwamem_tpu, and an image load, an
index build and SE and PE alignments through the port (with the host C++
natives and without them, with and without the device stages and through
the fused device path) leave both out of sys.modules.  The check runs in a fresh interpreter, since this test
process has JAX loaded."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "bwamem_tpu_torch")

_SCRIPT = r"""
import os, sys, tempfile
import numpy as np
import bwamem_tpu_torch
from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex
from bwamem_tpu_torch.ops import extend
from bwamem_tpu_torch.utils.synth import simulate_pairs
index = BwaMemIndex(sys.argv[1])  # an image load (index/bwa_img.py)
al = BwaMemAligner(index, device="cpu", min_device_jobs=1)
al.align_pairs()
recs = al.align_seqs([
    b"GGCTTTTAATGCTTTTCAGTGGTTGCTGCTCAAGATGGAGTCTACTCAGCAGATGGTAAGCTCTATTATT",
    b"TTGTTTTTAACACCAGAGTCATCCATCACATAATCAAATTTACTTTTAACTCTGGTAAATACTTCATTGT",
])
assert recs[0][0].cigar == "70M" and recs[1][0].template_len == -210, recs
# an index build from a FASTA file, then SE and PE through every stage set
codes = np.random.default_rng(5).integers(0, 4, 30000).astype(np.uint8)
with tempfile.TemporaryDirectory() as d:
    fa = os.path.join(d, "g.fa")
    with open(fa, "w") as f:
        f.write(">g\n" + "".join("ACGT"[c] for c in codes) + "\n")
    BwaMemIndex.create_index_image_from_fasta_file(fa, os.path.join(d, "g.img"))
    built = BwaMemIndex(os.path.join(d, "g.img"))
    reads = simulate_pairs(codes, np.random.default_rng(6), 6)
    ref = None
    for stages, fused in (((), False), (("sa_lookup",), False),
                          (("seed", "sa_lookup", "chain"), False), ((), True)):
        al = BwaMemAligner(built, device="cpu", min_device_jobs=1,
                           device_stages=stages, device_pipeline=fused)
        se = al.align_seqs(reads)
        al.align_pairs()
        got = (se, al.align_seqs(reads))
        ref = ref or got
        assert got == ref, (stages, fused)
    built.close()
assert extend.LAUNCHES == 0
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "bwamem_tpu")))
"""


def _run_fresh(disable_native):
    img = os.path.join(ROOT, "tests", "fixtures", "rotavirus.bwa.img")
    env = dict(os.environ, PYTHONPATH=ROOT,
               BWAMEM_TPU_DISABLE_NATIVE=disable_native)
    res = subprocess.run([sys.executable, "-c", _SCRIPT, img], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_alignment_through_port_loads_no_jax():
    _run_fresh("0")


def test_alignment_without_natives_loads_no_jax():
    _run_fresh("1")


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _offenders(pattern):
    pat = re.compile(pattern, re.M)
    offenders = []
    for p in _sources():
        with open(p) as fh:
            if pat.search(fh.read()):
                offenders.append(os.path.relpath(p, ROOT))
    return offenders


def test_no_port_module_imports_jax():
    """Statically: no ``.py`` under bwamem_tpu_torch/, nor chip_smoke.py,
    imports JAX, at any indentation."""
    assert _offenders(r"^\s*(import\s+jax|from\s+jax)\b") == []


def test_no_port_module_imports_bwamem_tpu():
    """Nor anything of the JAX package, not even a module free of JAX."""
    assert _offenders(r"^\s*(import|from)\s+bwamem_tpu(\.|\s)") == []
