"""The port runs without JAX: no module of bwamem_tpu_torch imports it, and
a CPU alignment through the port leaves it out of sys.modules.  The check
runs in a fresh interpreter, since this test process has JAX loaded."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "bwamem_tpu_torch")

_SCRIPT = r"""
import sys
import bwamem_tpu_torch
from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex
from bwamem_tpu_torch.ops import extend
index = BwaMemIndex(sys.argv[1])
al = BwaMemAligner(index, device="cpu", min_device_jobs=1)
al.align_pairs()
recs = al.align_seqs([
    b"GGCTTTTAATGCTTTTCAGTGGTTGCTGCTCAAGATGGAGTCTACTCAGCAGATGGTAAGCTCTATTATT",
    b"TTGTTTTTAACACCAGAGTCATCCATCACATAATCAAATTTACTTTTAACTCTGGTAAATACTTCATTGT",
])
assert recs[0][0].cigar == "70M" and recs[1][0].template_len == -210, recs
assert extend.LAUNCHES == 0
print("jax" in sys.modules, any(m.startswith("jax") for m in sys.modules))
"""


def test_alignment_through_port_loads_no_jax():
    img = os.path.join(ROOT, "tests", "fixtures", "rotavirus.bwa.img")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _SCRIPT, img], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False"]


def test_no_port_module_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.M)
    offenders = []
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(d, f)
                with open(p) as fh:
                    if pat.search(fh.read()):
                        offenders.append(os.path.relpath(p, ROOT))
    assert offenders == []
