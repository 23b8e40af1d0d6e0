"""The port's ``mem --devices N [--idx-shards K]`` (a mesh of the first N
cards, ``parallel.mesh.make_mesh(N, idx_shards=K)``, the aligner's
``mesh``) on the CPU, where no card exists: ``--devices`` with
``--device cpu``, ``--idx-shards`` without ``--devices``, an idx axis that
does not divide N and more cards than the machine has are errors (exit
code 2); no flag builds a virtual mesh.  With ``make_mesh`` replaced by a
virtual CPU mesh of the same shape, the command's SAM equals the host
route's (``--device cpu``) and the JAX package's ``mem --devices`` on its
virtual CPU devices, byte for byte, single-end and paired-end.  On the card
``--devices 1`` is held to ``--device cpu`` in chip_smoke.py phase 18."""
import pytest
import torch

from bwamem_tpu import __main__ as j_main
from bwamem_tpu_torch import __main__ as p_main
from bwamem_tpu_torch.parallel import mesh as mesh_mod
from test_torch_cli import _run
from test_torch_sam import write_rotavirus_fasta
from test_torch_wire import _batch

N_PAIRS = 40


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_dev")
    write_rotavirus_fasta(d / "ref.fa")
    seqs = _batch(N_PAIRS, seed=13)
    paths = {k: str(d / f"{k}.fq") for k in ("r1", "r2")}
    with open(paths["r1"], "w") as f1, open(paths["r2"], "w") as f2:
        for i in range(N_PAIRS):
            r1, r2 = (f"@p{i}\n{s.decode()}\n+\n{'I' * len(s)}\n"
                      for s in seqs[2 * i: 2 * i + 2])
            f1.write(r1)
            f2.write(r2)
    for name, main in (("port", p_main.main), ("jax", j_main.main)):
        paths[name] = str(d / f"{name}.img")
        assert _run(main, ["index", str(d / "ref.fa"), "-o", paths[name]])[0] == 0
    return paths


@pytest.mark.parametrize("argv,msg", (
    (["--devices", "1", "--device", "cpu"], "mesh of cards"),
    (["--idx-shards", "2"], "needs --devices"),
    (["--devices", "2", "--idx-shards", "3"], "must divide"),
), ids=("with_device_cpu", "idx_without_devices", "idx_not_dividing"))
def test_bad_device_flags_are_errors(files, argv, msg):
    rc, out, err = _run(p_main.main, ["mem", files["port"], files["r1"], *argv])
    assert rc == 2 and out == "" and msg in err


def test_more_cards_than_the_machine_has_is_an_error(files):
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    rc, out, err = _run(p_main.main, ["mem", files["port"], files["r1"],
                                      "--devices", str(have + 1)])
    assert rc == 2 and out == "" and f"{have + 1} cards asked for" in err


@pytest.mark.parametrize("n,k", ((2, 1), (4, 2)))
@pytest.mark.parametrize("pe", (False, True), ids=("se", "pe"))
def test_devices_sam_equals_host_and_jax(files, monkeypatch, n, k, pe):
    built = []

    def virtual(n_devices=None, idx_shards=1, devices=None):
        assert devices is None  # the CLI asks for cards, never a list
        built.append((n_devices, idx_shards))
        return mesh_orig(n_devices, idx_shards, ["cpu"] * n_devices)

    mesh_orig = mesh_mod.make_mesh
    monkeypatch.setattr(mesh_mod, "make_mesh", virtual)
    reads = [files["r1"], files["r2"]] if pe else [files["r1"]]
    extra = ["--insert-mean", "240"] if pe else []
    rc, got, err = _run(p_main.main, ["mem", files["port"], *reads, *extra,
                                      "--devices", str(n), "--idx-shards",
                                      str(k)])
    assert rc == 0, err
    assert built == [(n, k)]
    rc, host, _ = _run(p_main.main, ["mem", files["port"], *reads, *extra,
                                     "--device", "cpu"])
    assert rc == 0 and got == host
    rc, jax_sam, err = _run(j_main.main, ["mem", files["jax"], *reads, *extra,
                                          "--devices", str(n), "--idx-shards",
                                          str(k)])
    assert rc == 0, err
    assert got == jax_sam
