"""The port's parallel layer on a virtual CPU mesh (``cpu`` repeated: each
mesh "device" has its own shard, launches and thread), against the
single-device port and the JAX package's parallel layer on its virtual CPU
devices (tests/conftest.py): mesh shapes and errors, the batch split and
the host shard/merge helpers, the data-parallel extension and sharded
occ4 steps, and ``align_seqs_mesh`` and ``BwaMemAligner(mesh=...)`` on
every route (``parallel.dryrun`` is tests/test_torch_dryrun.py's).  Records are compared
field for field; every tolerance is 0 (integer results).  The mesh on a
card (``cuda:0`` repeated) is tests/test_torch_cuda.py's and
chip_smoke.py phase 18's."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import bwamem_tpu
from bwamem_tpu.engine import pipeline as j_pipeline
from bwamem_tpu.index import bwa_img as j_bwa_img
from bwamem_tpu.parallel import distributed as j_dist
from bwamem_tpu.parallel import mesh as j_mesh
from bwamem_tpu.parallel import pipeline as j_par
from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex
from bwamem_tpu_torch.api.options import MEM_F_PE, MemOptions
from bwamem_tpu_torch.engine import pipeline as p_pipeline
from bwamem_tpu_torch.engine.exec_ctx import mesh_exec
from bwamem_tpu_torch.engine.extend_batch import STATS
from bwamem_tpu_torch.index import bwa_img as p_bwa_img
from bwamem_tpu_torch.index import image
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.ops import extend as ext
from bwamem_tpu_torch.parallel import dataparallel, distributed
from bwamem_tpu_torch.parallel import pipeline as par
from bwamem_tpu_torch.parallel.mesh import (Mesh, make_mesh, replicate,
                                            run_shards, shard_batch, shards,
                                            split_offsets)
from bwamem_tpu_torch.utils import cudabuild
from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig
from bwamem_tpu_torch.utils.synth import simulate_pairs, synthetic_genome

ROTAVIRUS = os.path.join(os.path.dirname(__file__), "fixtures",
                         "rotavirus.bwa.img")
CPU4 = ["cpu"] * 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    g = synthetic_genome(200_000, np.random.default_rng(21))
    path = str(tmp_path_factory.mktemp("g") / "g.img")
    image.write_image(path, build_index(Fasta([FastaContig("g", "", g)])))
    reads = simulate_pairs(np.where(g > 3, 0, g), np.random.default_rng(22), 4,
                           read_len=100, isize_mean=250, isize_std=25)
    reads[5] = reads[5][:60] + b"N" * 8 + reads[5][68:]
    reads[2] = reads[2][:40]  # a short read
    index = BwaMemIndex(path)
    yield index, reads, path
    index.close()


# ------------------------------------------------------------------ the mesh

@pytest.mark.parametrize("n,k,shape", ((8, 2, (4, 2)), (8, 1, (8, 1)),
                                       (4, 4, (1, 4)), (1, 1, (1, 1))))
def test_make_mesh_shapes(n, k, shape):
    m = make_mesh(n, idx_shards=k, devices=["cpu"] * 8)
    jm = j_mesh.make_mesh(n, idx_shards=k)
    assert tuple(m.shape.values()) == shape == jm.devices.shape
    assert m.axis_names == tuple(jm.axis_names) == ("data", "idx")
    assert m.size == n and set(m.flat) == {torch.device("cpu")}


def test_make_mesh_errors():
    with pytest.raises(ValueError, match="divide"):
        make_mesh(devices=CPU4, idx_shards=3)
    with pytest.raises(ValueError):
        make_mesh(5, devices=CPU4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cards"):
            make_mesh()  # the cards by default: none here
        with pytest.raises(RuntimeError, match="not present"):
            make_mesh(devices=["cuda:0"] * 2)
    with pytest.raises(ValueError):
        Mesh(((torch.device("cpu"),), ()))


def test_shard_batch_and_offsets():
    mesh = make_mesh(devices=CPU4, idx_shards=2)
    x = torch.arange(10 * 3).reshape(10, 3)
    parts, off = shard_batch(mesh, x)
    assert off.tolist() == [0, 2, 5, 7, 10]
    assert [p.shape[0] for p in parts] == [2, 3, 2, 3]
    assert torch.equal(torch.cat(parts), x)
    assert [hi - lo for _, lo, hi in shards(mesh, 3)] == [1, 1, 1]
    assert split_offsets(0, 4).tolist() == [0] * 5
    got = replicate(mesh, lambda host, dev: (host, dev), "t")
    assert got == [("t", torch.device("cpu"))] * 4


def test_run_shards_order_tallies_and_errors():
    def fn(dev, part):
        cudabuild.tally()["seed"] += part
        return part * 10

    before = cudabuild.tally()["seed"]
    assert run_shards(fn, [("cpu", i) for i in range(1, 5)]) == [10, 20, 30, 40]
    assert cudabuild.tally()["seed"] - before == 10  # the shards' launches

    def bad(dev, part):
        if part == 2:
            raise KeyError("shard 2")
        return part

    with pytest.raises(KeyError, match="shard 2"):
        run_shards(bad, [("cpu", i) for i in range(4)])


@pytest.mark.parametrize("n", (0, 1, 7, 103, 120))
def test_host_shards_and_merge_match_jax(n):
    reads = [f"r{i}" for i in range(n)]
    for nproc in (1, 2, 3, 4):
        got = [distributed.shard_bounds(n, p, nproc) for p in range(nproc)]
        assert got == [j_dist.shard_bounds(n, p, nproc) for p in range(nproc)]
        hosts = [par.shard_reads_hosts(reads, p, nproc) for p in range(nproc)]
        assert hosts == [j_par.shard_reads_hosts(reads, p, nproc)
                         for p in range(nproc)]
        if n % 2 == 0:  # a paired batch: mates stay together
            assert all(lo % 2 == 0 for lo, _ in hosts)
        assert distributed.merge_shards(hosts, n) == reads
    if n:
        with pytest.raises(RuntimeError, match="incomplete"):
            distributed.merge_shards([(0, reads[:-1])], n)
    assert distributed.init_distributed(None) == (0, 1)
    assert distributed.gather_shards(3, ["x"]) == [(3, ["x"])]


# ----------------------------------------------------- data-parallel steps

def test_dp_extend_step_matches_single_device():
    opt = MemOptions()
    mesh = make_mesh(devices=CPU4, idx_shards=2)
    B, Q, T = 37, 32, 48
    rng = np.random.default_rng(0)
    args = dict(qseq=torch.from_numpy(rng.integers(0, 5, (B, Q))),
                tseq=torch.from_numpy(rng.integers(0, 5, (B, T))),
                qlen=torch.from_numpy(rng.integers(1, Q + 1, B)),
                tlen=torch.from_numpy(rng.integers(0, T + 1, B)),
                h0=torch.from_numpy(rng.integers(5, 40, B)),
                w=torch.full((B,), 20), end_bonus=torch.full((B,), 5))
    mat = torch.tensor(opt.mat, dtype=torch.int32).reshape(5, 5)
    step = dataparallel.make_dp_extend_step(mesh, 6, 1, 6, 1, 100, 1)
    got = step(**args, mat=mat)
    want = ext.ksw_extend(**args, mat=mat, o_del=6, e_del=1, o_ins=6, e_ins=1,
                          zdrop=100, max_sc=1)
    for k in ext.KEYS:
        assert torch.equal(got[k], want[k]), k


def test_sharded_occ_and_full_parallel_step(genome):
    index, _, _ = genome
    fm = index._require().fm
    mesh = make_mesh(devices=CPU4, idx_shards=2)
    tables = dataparallel.shard_tables(mesh, fm)
    assert [t.n_shards for t in tables] == [2, 2]
    ks = torch.from_numpy(np.random.default_rng(3).integers(-1, fm.seq_len + 1,
                                                            301))
    occ = dataparallel.make_sharded_occ_step(mesh)(tables, ks)
    assert np.array_equal(occ.numpy(), fm.occ4(ks.numpy()))
    opt = MemOptions()
    step = dataparallel.full_parallel_step(
        mesh, np.asarray(opt.mat).reshape(5, 5), opt)
    q = torch.randint(0, 4, (9, 20))
    e, o = step(dict(qseq=q, tseq=q, qlen=torch.full((9,), 20),
                     tlen=torch.full((9,), 20), h0=torch.full((9,), 10),
                     w=torch.full((9,), 10), end_bonus=torch.full((9,), 5),
                     mat=torch.tensor(opt.mat).reshape(5, 5)),
                dict(tables=tables, k=ks[:7]))
    assert e["score"].tolist() == [10 + 20] * 9  # exact matches
    assert torch.equal(o, occ[:7])


# ------------------------------------------------------- the mesh aligner

ROUTES = {"waves": dict(), "sa_lookup": dict(device_stages=("sa_lookup",)),
          "staged": dict(device_stages=("seed", "sa_lookup", "chain")),
          "fused": dict(device_pipeline=True)}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("pe", (True, False), ids=("pe", "se"))
def test_mesh_aligner_equals_single_device(genome, route, pe):
    index, reads, _ = genome

    def run(**kw):
        al = BwaMemAligner(index, min_device_jobs=1, **kw)
        if pe:
            al.align_pairs()
        return [[vars(a) for a in r] for r in al.align_seqs(reads)]

    mesh = make_mesh(devices=CPU4, idx_shards=2)
    STATS.reset()
    got = run(mesh=mesh, **ROUTES[route])
    assert got == run(device="cpu")
    if route != "fused":
        assert STATS.device_extend_waves > 0  # the waves ran on the mesh


def test_mesh_aligner_arguments(genome):
    index, _, _ = genome
    mesh = make_mesh(devices=CPU4)
    al = BwaMemAligner(index, mesh=mesh)
    assert al._exec_cfg.device == torch.device("cpu")
    assert al._exec_cfg.mesh is mesh and al._exec_cfg.want_force_waves()
    assert not al._exec_cfg.device_pipeline  # None: fused on a card only
    with pytest.raises(ValueError, match="first device"):
        BwaMemAligner(index, mesh=mesh, device="cuda:0")
    with pytest.raises(ValueError, match="unknown"):
        mesh_exec(mesh, ("bogus",))
    cfg = mesh_exec(mesh, ("seed", "chain"))
    assert (cfg.device_seed, cfg.device_chain, cfg.device_sa_lookup) == (
        True, True, False)
    one = cfg.on(torch.device("cpu"))
    assert one.mesh is None and one.device_seed and one.force_waves


def _jax_mesh_records(idx, reads, is_pe, stages=()):
    opt = bwamem_tpu.MemOptions(flag=MEM_F_PE if is_pe else 0)
    return j_par.align_seqs_mesh(opt, j_pipeline.Engine(idx), reads,
                                 j_mesh.make_mesh(8, idx_shards=2), is_pe=is_pe,
                                 device_stages=stages)


def _port_mesh_records(idx, reads, is_pe, stages=()):
    opt = MemOptions(flag=MEM_F_PE if is_pe else 0)
    return par.align_seqs_mesh(opt, p_pipeline.Engine(idx), reads,
                               make_mesh(devices=CPU4, idx_shards=2),
                               is_pe=is_pe, device_stages=stages)


def _fields(recs):
    return [[dataclasses.astuple(a) for a in r] for r in recs]


def _codes(seqs):
    from bwamem_tpu_torch.utils.encoding import seq_to_codes_batch

    return seq_to_codes_batch(seqs)


@pytest.mark.parametrize("src", ("rotavirus", "built"))
def test_align_seqs_mesh_matches_jax(genome, src):
    """The port's and the JAX package's ``align_seqs_mesh``, each on its
    virtual CPU mesh, give the same records, field for field."""
    if src == "rotavirus":
        j_idx = j_bwa_img.read_bwa_image(ROTAVIRUS)
        p_idx = p_bwa_img.read_bwa_image(ROTAVIRUS)
        fwd = p_idx.get_seq(0, p_idx.bns.l_pac)
        seqs = simulate_pairs(np.where(fwd > 3, 0, fwd),
                              np.random.default_rng(9), 8, read_len=70,
                              isize_mean=250, isize_std=20)
    else:
        from bwamem_tpu.index import image as j_image

        _, seqs, path = genome
        j_idx, p_idx = j_image.read_image(path), image.read_image(path)
    reads = _codes(seqs)
    for is_pe in (True, False):
        want = _jax_mesh_records(j_idx, reads, is_pe)
        got = _port_mesh_records(p_idx, reads, is_pe)
        assert _fields(got) == _fields(want), (src, is_pe)


def test_full_stage_stack_mesh_matches_jax(genome):
    from bwamem_tpu.index import image as j_image

    _, seqs, path = genome
    reads = _codes(seqs[:4])
    stages = ("seed", "chain", "sa_lookup")
    want = _jax_mesh_records(j_image.read_image(path), reads, True, stages)
    got = _port_mesh_records(image.read_image(path), reads, True, stages)
    assert _fields(got) == _fields(want)
