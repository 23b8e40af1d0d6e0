"""The port stands alone: no module of bwamem_tpu_torch, and not
chip_smoke.py, imports JAX or anything of bwamem_tpu, and an image load, an
index build and SE and PE alignments through the port (with the host C++
natives and without them, with and without the device stages and through
the fused device path) leave both out of sys.modules, and so do the
command line's ``index`` and ``mem`` (``python -m bwamem_tpu_torch``).  The
checks run in fresh interpreters, since this test process has JAX
loaded."""
import os
import re
import subprocess
import sys

import numpy as np

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


def test_command_line_loads_no_jax(tmp_path):
    """``python -m bwamem_tpu_torch index`` and ``mem`` (SE and PE, the
    host route and the plain versions of the staged and fused routes) in
    fresh interpreters: ``-X importtime`` lists every module each run
    imported, and none is of JAX or bwamem_tpu."""
    codes = np.random.default_rng(5).integers(0, 4, 30000)
    seq = "".join("ACGT"[c] for c in codes)
    (tmp_path / "g.fa").write_text(">g\n" + seq + "\n")
    rng = np.random.default_rng(6)
    with open(tmp_path / "r1.fq", "w") as f1, open(tmp_path / "r2.fq", "w") as f2:
        for i, s in enumerate(rng.integers(0, 29000, 20)):
            r2 = seq[s + 230: s + 300][::-1].translate(str.maketrans("ACGT", "TGCA"))
            f1.write(f"@p{i}\n{seq[s: s + 70]}\n+\n{'I' * 70}\n")
            f2.write(f"@p{i}\n{r2}\n+\n{'I' * 70}\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    fa, img = str(tmp_path / "g.fa"), str(tmp_path / "g.img")
    runs = (["index", fa, "-o", img],
            ["mem", img, str(tmp_path / "r1.fq"), "--device", "cpu"],
            ["mem", img, str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq"),
             "--device", "cpu", "--device-stages", "seed,sa_lookup,chain"],
            ["mem", img, str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq"),
             "--device", "cpu", "--device-pipeline"])
    for argv in runs:
        res = subprocess.run(
            [sys.executable, "-X", "importtime", "-m", "bwamem_tpu_torch", *argv],
            cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-2000:]
        imported = {ln.rsplit("|", 1)[1].strip() for ln in res.stderr.splitlines()
                    if ln.startswith("import time:") and "|" in ln}
        assert "bwamem_tpu_torch.api.index" in imported
        assert not {m for m in imported
                    if m.split(".")[0] in ("jax", "jaxlib", "bwamem_tpu")}, argv
        if argv[0] == "mem":
            assert "bwamem_tpu_torch.api.sam" in imported
            assert res.stdout.startswith("@SQ\tSN:g\tLN:30000\n")


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


_PARALLEL = r"""
import sys
import torch
torch.set_num_threads(1)
from bwamem_tpu_torch.ops import sa
from bwamem_tpu_torch.parallel import (dataparallel, distributed, dryrun, mesh,
                                       pipeline)
out = dryrun.dryrun_multichip(["cpu"] * 2, big_len=128 * 1024, n_pairs=2,
                              n_sub=2, min_seed_len=10)
assert out["mesh"] == {"data": 1, "idx": 2}, out
import numpy as np
assert len(sa.suffix_array_device(np.zeros(5, np.uint8), "cpu")) == 6
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "bwamem_tpu")))
"""


def test_parallel_loads_no_jax():
    """The sub-package ``parallel`` (mesh, data-parallel steps, the mesh
    pipeline, torch.distributed, the dry run) and the device SA builder run
    in a fresh interpreter with nothing of JAX or bwamem_tpu loaded."""
    assert {os.path.basename(p) for p in _sources()
            if os.sep + "parallel" + os.sep in p} >= {
        "mesh.py", "dataparallel.py", "pipeline.py", "distributed.py",
        "dryrun.py"}
    res = subprocess.run([sys.executable, "-c", _PARALLEL], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_no_port_module_imports_jax():
    """Statically: no ``.py`` under bwamem_tpu_torch/, nor chip_smoke.py,
    imports JAX, at any indentation."""
    assert _offenders(r"^\s*(import\s+jax|from\s+jax)\b") == []


def test_no_port_module_imports_bwamem_tpu():
    """Nor anything of the JAX package, not even a module free of JAX."""
    assert _offenders(r"^\s*(import|from)\s+bwamem_tpu(\.|\s)") == []
