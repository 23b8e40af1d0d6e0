"""The port's command line (``bwamem_tpu_torch.__main__``) against the JAX
package's (``bwamem_tpu.__main__``), both run in process on the rotavirus
genome (its FASTA written from the fixture image's pac) and 300 simulated
pairs: the SAM text byte for byte, header included, single-end and
paired-end, with inferred and given insert statistics, chunked by ``-K``,
interleaved (``-p``, an odd final read dropped with a warning), through the
host whole-batch route (``--device cpu``) and the plain versions of the
staged (``--device-stages seed,sa_lookup,chain``) and fused
(``--device-pipeline``) device routes; ``--shard`` outputs merging to the
unsharded SAM on the host and fused routes (on a genome with exact
repeats, where the hash tie-breaks take the stream ordinals); a bad
``--shard``; ``--device
cuda`` without a card; the chunker; and ``index`` writing the JAX package's
image and bwa files byte for byte.  The interpreter entry
(``python -m bwamem_tpu_torch``) runs in tests/test_torch_sam.py's
snapshot."""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from bwamem_tpu import __main__ as j_main
from bwamem_tpu_torch import __main__ as p_main
from test_torch_sam import write_rotavirus_fasta
from test_torch_wire import _batch

N_PAIRS = 300
STAGED = ["--device", "cpu", "--device-stages", "seed,sa_lookup,chain"]
ROUTES = {"host": ["--device", "cpu"], "staged": STAGED,
          "fused": ["--device", "cpu", "--device-pipeline"]}
CASES = {
    "se": ["{r1}"],
    "pe": ["{r1}", "{r2}"],
    "pe_stats": ["{r1}", "{r2}", "--insert-mean", "240"],
    "pe_chunks": ["{r1}", "{r2}", "--insert-mean", "240", "-K", "6000"],
    "se_chunks": ["{r1}", "-K", "3000"],
    "smart": ["{inter}", "-p", "--insert-mean", "240"],
    "smart_odd": ["{odd}", "-p", "--insert-mean", "240"],
}


def _run(main, argv):
    """``main(argv)`` with its stdout and stderr captured."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The FASTA, its index image by each package's ``index`` command, and
    the FASTQ files: two mates files, one interleaved, and the interleaved
    one with a dangling final read."""
    d = tmp_path_factory.mktemp("cli")
    write_rotavirus_fasta(d / "ref.fa")
    seqs = _batch(N_PAIRS, seed=9)
    paths = {k: str(d / f"{k}.fq") for k in ("r1", "r2", "inter", "odd")}
    with open(paths["r1"], "w") as f1, open(paths["r2"], "w") as f2, \
            open(paths["inter"], "w") as fi:
        for i in range(N_PAIRS):
            recs = [f"@p{i}\n{s.decode()}\n+\n{'I' * len(s)}\n"
                    for s in seqs[2 * i: 2 * i + 2]]
            f1.write(recs[0])
            f2.write(recs[1])
            fi.write(recs[0] + recs[1])
    with open(paths["inter"]) as f, open(paths["odd"], "w") as g:
        g.write(f.read() + "@dangling\n" + "ACGT" * 7 + "\n+\n" + "I" * 28 + "\n")
    for name, main in (("port", p_main.main), ("jax", j_main.main)):
        img = str(d / f"{name}.img")
        assert _run(main, ["index", str(d / "ref.fa"), "-o", img])[0] == 0
        paths[name] = img
    return paths


def _argv(files, case, img):
    return ["mem", img] + [a.format(**files) for a in CASES[case]]


@pytest.fixture(scope="module")
def jax_sam(files):
    """The JAX CLI's output per case, made once."""
    cache = {}

    def get(case):
        if case not in cache:
            rc, out, err = _run(j_main.main, _argv(files, case, files["jax"]))
            assert rc == 0, err
            cache[case] = out
        return cache[case]

    return get


def _port(files, case, route="host", extra=()):
    rc, out, err = _run(p_main.main, _argv(files, case, files["port"])
                        + ROUTES[route] + list(extra))
    assert rc == 0, err
    return out, err


def _body(sam):
    return [ln for ln in sam.splitlines() if not ln.startswith("@")]


@pytest.mark.parametrize("route", ("host", "staged"))
@pytest.mark.parametrize("case", CASES)
def test_cli_sam_equals_the_jax_clis(files, jax_sam, case, route):
    out, err = _port(files, case, route)
    assert out == jax_sam(case)
    n_reads = N_PAIRS if case.startswith("se") else 2 * N_PAIRS
    assert len(_body(out)) >= n_reads
    chunks = sum("processed" in ln for ln in err.splitlines())
    assert chunks >= 5 if case.endswith("chunks") else chunks == 1


@pytest.mark.parametrize("case", ("se", "pe_stats"))
def test_fused_cli_sam_equals_the_jax_clis(files, jax_sam, case):
    assert _port(files, case, "fused")[0] == jax_sam(case)


def test_smart_pairing_drops_the_odd_read(files):
    out, err = _port(files, "smart_odd")
    assert "dropping unpaired final read 'dangling'" in err
    assert not any(ln.startswith("dangling\t") for ln in _body(out))
    assert out == _port(files, "smart")[0]
    assert out == _port(files, "pe_stats")[0]  # -p equals two mates files


@pytest.fixture(scope="module")
def repeat_files(tmp_path_factory):
    """A 20 kbp genome holding three exact copies of a 1 kbp block, and 150
    pairs of which half start in a copy: their equal hits are broken by
    the hash of the read's (SE) or pair's (PE) ordinal, so a route that
    ignored the stream ordinals would place them differently."""
    d = tmp_path_factory.mktemp("repeats")
    rng = np.random.default_rng(21)
    g = rng.integers(0, 4, 20_000)
    g[8_000:9_000] = g[15_000:16_000] = g[2_000:3_000]
    seq = "".join("ACGT"[c] for c in g)
    (d / "ref.fa").write_text(">rep\n" + seq + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    paths = {k: str(d / f"{k}.fq") for k in ("r1", "r2", "inter")}
    with open(paths["r1"], "w") as f1, open(paths["r2"], "w") as f2, \
            open(paths["inter"], "w") as fi:
        for i in range(150):
            isize = int(rng.integers(180, 300))
            s = int(rng.integers(2_000, 3_000 - isize) if i % 2
                    else rng.integers(0, len(g) - isize))
            r1, r2 = seq[s: s + 70], seq[s + isize - 70: s + isize][::-1]
            recs = [f"@p{i}\n{r}\n+\n{'I' * 70}\n"
                    for r in (r1, r2.translate(comp))]
            f1.write(recs[0])
            f2.write(recs[1])
            fi.write(recs[0] + recs[1])
    paths["port"] = str(d / "ref.img")
    assert _run(p_main.main, ["index", str(d / "ref.fa"), "-o",
                              paths["port"]])[0] == 0
    return paths


@pytest.mark.parametrize("route", ("host", "fused", "python"))
def test_shard_outputs_merge_to_unsharded(repeat_files, route, monkeypatch):
    """--shard I/N with ids from the original stream ordinals: the shards'
    lines merge to the unsharded run's, single-end (the Wang hash of the
    read id) and paired-end with given insert statistics, on reads with
    equal hits in three copies of a block; on the host route, the fused
    route and, with the host C++ off, the Python tail."""
    if route == "python":
        monkeypatch.setenv("BWAMEM_TPU_DISABLE_NATIVE", "1")
        route = "host"
    for case, n in (("se", 3), ("pe_stats", 2), ("smart", 2)):
        full = _body(_port(repeat_files, case, route)[0])
        assert sum(ln.split("\t")[4] == "0" for ln in full) >= 20  # ties
        parts = [_body(_port(repeat_files, case, route,
                             ["--shard", f"{i}/{n}"])[0]) for i in range(n)]
        assert sorted(sum(parts, [])) == sorted(full), case
        assert all(parts)


@pytest.mark.parametrize("spec", ("3/2", "x", "1/0", "-1/2"))
def test_shard_rejects_bad_spec(files, spec):
    rc, out, err = _run(p_main.main, ["mem", files["port"], files["r1"],
                                      "--device", "cpu", f"--shard={spec}"])
    assert rc == 2 and "bad --shard" in err and out == ""


def test_cuda_without_a_card_fails(files):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, out, err = _run(p_main.main, ["mem", files["port"], files["r1"]])
    assert rc != 0 and "CUDA is not available" in err
    assert "@SQ" not in out


def test_chunks_group_by_bases_and_keep_pairs():
    """The chunker cuts on base count and never splits pairs."""

    class R:
        def __init__(self, n):
            self.seq = "A" * n

    chunks = list(p_main._chunker(zip(iter([R(100)] * 10), iter([R(100)] * 10)),
                                  500, paired=True))
    assert [len(c) for c in chunks] == [3, 3, 3, 1]
    chunks = list(p_main._chunker(iter([R(50), R(400), R(400), R(50)]), 450,
                                  paired=False))
    assert [sum(len(r.seq) for r in c) for c in chunks] == [450, 450]


def test_index_command_writes_the_jax_packages_files(tmp_path, monkeypatch):
    """``index --sa-intv 8 --bwa-files``: the same image and bwa files."""
    monkeypatch.setenv("BWAMEM_TPU_SA_INTV", "32")  # restored afterwards
    made = {}
    for name, main in (("port", p_main.main), ("jax", j_main.main)):
        d = tmp_path / name
        d.mkdir()
        write_rotavirus_fasta(d / "ref.fa")
        rc, _, err = _run(main, ["index", "--sa-intv", "8", "--bwa-files",
                                 str(d / "ref.fa")])
        assert rc == 0 and "wrote index image" in err
        made[name] = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
    assert sorted(made["port"]) == sorted(made["jax"])
    assert {"ref.fa.img", "ref.fa.bwt", "ref.fa.sa"} <= set(made["port"])
    for f in made["port"]:
        assert made["port"][f] == made["jax"][f], f
