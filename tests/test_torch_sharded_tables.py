"""The port's idx-sharded FM tables (``ops.fmindex.ShardedFMIndex``, D12) in
their plain versions on the CPU against the JAX package's
``sharded_tables`` + ``shard_map`` bodies on 4 virtual CPU devices, as
tests/test_sharded_tables.py runs them: occ4, the SA walk and the fused
seed+SA step, bit for bit (tolerance 0: integer results), and against the
port's unsharded functions and the host oracle.  Also
``utils.synth.synthetic_fmindex``, equal to the reference's for the same
seed, and the sharded forms on its index.  The kernels' sharded
instantiations are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 18)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bwamem_tpu.engine.fmindex import FMIndex as JaxFMIndex
from bwamem_tpu.index.build import build_index as jax_build_index
from bwamem_tpu.ops import fmindex_tpu as fmt
from bwamem_tpu.ops.fmindex_tpu import (DeviceFMIndex as JaxDFM, occ4_device,
                                        sa_lookup_body)
from bwamem_tpu.ops.seed_fused import M_SLOTS, seed_sa_fused_body
from bwamem_tpu.utils import synth as jax_synth
from bwamem_tpu.utils.fasta import Fasta as JFasta, FastaContig as JContig
from bwamem_tpu_torch.api.options import MemOptions
from bwamem_tpu_torch.engine.fmindex import FMIndex
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.ops import fmindex as fo
from bwamem_tpu_torch.ops import seed as so
from bwamem_tpu_torch.utils import synth
from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig

N_IDX = 4


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, 50_000).astype(np.uint8)
    codes[30_000:30_400] = codes[2_000:2_400]  # a repeat: multi-hit SMEMs
    jfm = JaxFMIndex(jax_build_index(JFasta([JContig("c", "", codes.copy())]),
                                     sa_intv=8))
    fm = FMIndex(build_index(Fasta([FastaContig("c", "", codes.copy())]),
                             sa_intv=8))
    jdfm = JaxDFM.from_host(jfm)
    mesh = Mesh(np.array(jax.devices("cpu")[:N_IDX]).reshape(N_IDX), ("idx",))
    lines_np, sa_np = np.asarray(jdfm.lines), np.asarray(jdfm.sa)
    bps, sps = -(-lines_np.shape[0] // N_IDX), -(-sa_np.shape[0] // N_IDX)
    lines_pad = np.zeros((bps * N_IDX, lines_np.shape[1]), np.uint32)
    lines_pad[: lines_np.shape[0]] = lines_np
    sa_pad = np.zeros(sps * N_IDX, sa_np.dtype)
    sa_pad[: sa_np.shape[0]] = sa_np
    lines_s = jax.device_put(lines_pad, NamedSharding(mesh, P("idx", None)))
    sa_s = jax.device_put(sa_pad, NamedSharding(mesh, P("idx")))
    sfm = fo.ShardedFMIndex.from_host(fm, ["cpu"] * N_IDX)
    reads = [codes[i: i + 120].copy() for i in range(1_000, 49_000, 2_500)]
    reads += [rng.integers(0, 4, 90).astype(np.uint8) for _ in range(4)]
    reads[3][40:45] = 4  # ambiguous bases break the seeds
    return dict(jfm=jfm, fm=fm, jdfm=jdfm, mesh=mesh, lines_s=lines_s,
                sa_s=sa_s, bps=bps, sps=sps, sfm=sfm, reads=reads)


def test_sharded_layout_pads_as_the_jax_test(tables):
    """The shards are the JAX test's padded tables cut in N_IDX pieces."""
    t = tables
    sfm = t["sfm"]
    assert (sfm.n_shards, sfm.blocks_per_shard, sfm.sa_per_shard) == (
        N_IDX, t["bps"], t["sps"])
    lines = torch.cat(sfm.line_shards).numpy().view(np.uint32)
    assert np.array_equal(lines, np.asarray(t["lines_s"]))
    assert np.array_equal(torch.cat(sfm.sa_shards).numpy(),
                          np.asarray(t["sa_s"]).astype(np.int64))


def test_occ4_sharded_bit_equal_to_jax_shard_map(tables):
    t = tables
    dfm = t["jdfm"]
    ks = np.random.default_rng(4).integers(-1, t["fm"].seq_len + 1, 512)
    with fmt.sharded_tables("idx", t["bps"], t["sps"]):
        want = shard_map(
            lambda l, L, k: occ4_device(l, L, k, dfm.primary, dfm.seq_len,
                                        dfm.span),
            mesh=t["mesh"], in_specs=(P("idx", None), P(), P()),
            out_specs=P())(t["lines_s"], dfm.L2, jnp.asarray(ks, jnp.int32))
    got = fo.occ4_sharded(t["sfm"], torch.from_numpy(ks))
    assert np.array_equal(got.numpy(), np.asarray(want))
    unsharded = fo.occ4(fo.DeviceFMIndex.from_host(t["fm"], "cpu"),
                        torch.from_numpy(ks))
    assert torch.equal(got, unsharded)
    assert np.array_equal(got.numpy(), t["fm"].occ4(ks))


def test_sa_lookup_sharded_bit_equal_to_jax_shard_map(tables):
    t = tables
    dfm = t["jdfm"]
    rows = np.random.default_rng(5).integers(0, t["fm"].seq_len, 512)
    with fmt.sharded_tables("idx", t["bps"], t["sps"]):
        want = shard_map(
            lambda l, L, s, k: sa_lookup_body(l, L, s, k, dfm.primary,
                                              dfm.seq_len, dfm.sa_intv,
                                              dfm.span),
            mesh=t["mesh"], in_specs=(P("idx", None), P(), P("idx"), P()),
            out_specs=P())(t["lines_s"], dfm.L2, t["sa_s"],
                           jnp.asarray(rows, jnp.int32))
    got = fo.sa_lookup_sharded(t["sfm"], torch.from_numpy(rows))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert np.array_equal(got.numpy(), t["fm"].sa_lookup(rows))


def _jax_fused(t, reads, opt):
    """The JAX fused seed+SA body on the sharded tables, decoded per read:
    (n, ovf, rows per read, positions per row)."""
    dfm = t["jdfm"]
    B, L = len(reads), max(len(r) for r in reads)
    qseq = np.full((B, L), 4, np.int8)
    for i, r in enumerate(reads):
        qseq[i, : len(r)] = r
    qlen = np.asarray([len(r) for r in reads], np.int32)
    R_cap, F_cap = B * 256, B * (M_SLOTS + L)
    kw = dict(primary=dfm.primary, seq_len=dfm.seq_len, sa_intv=dfm.sa_intv,
              span=dfm.span, min_seed_len=opt.min_seed_len,
              split_len=opt.split_len, split_width=opt.split_width,
              max_mem_intv=int(opt.max_mem_intv), max_occ=opt.max_occ,
              M=M_SLOTS, R_cap=R_cap, F_cap=F_cap)
    with fmt.sharded_tables("idx", t["bps"], t["sps"]):
        flat, extra = shard_map(
            lambda l, Lt, s, q, ql: seed_sa_fused_body(l, Lt, s, q, ql, **kw),
            mesh=t["mesh"], in_specs=(P("idx", None), P(), P("idx"), P(), P()),
            out_specs=(P(), P()))(t["lines_s"], dfm.L2, t["sa_s"],
                                  jnp.asarray(qseq), jnp.asarray(qlen))
    flat, extra = np.asarray(flat).astype(np.int64), np.asarray(extra).astype(
        np.int64)
    meta = extra[R_cap + 2:]
    n, ovf = meta & 0xFFFF, (meta >> 16) != 0
    assert extra[R_cap] <= R_cap
    cnt = np.minimum(flat[: int(extra[R_cap + 1]), 2], opt.max_occ)
    offs = np.concatenate([[0], np.cumsum(cnt)])
    rows, pos, start = [], [], 0
    for r in range(B):
        rr = flat[start: start + n[r]]
        rows.append([(a, b, s, q >> 16, q & 0xFFFF) for a, b, s, q in rr.tolist()])
        pos.append([extra[offs[j]: offs[j + 1]].tolist()
                    for j in range(start, start + n[r])])
        start += n[r]
    return n, ovf, rows, pos


def _port_fused(dfm, reads, opt):
    """``seed_sa_walk`` (K = the JAX package's 24 slots), decoded the same
    way, and its raw outputs."""
    q, ql = so.pad_reads(reads, "cpu")
    res, pos = so.seed_sa_walk(dfm, q, ql, so.SeedParams.from_opt(opt),
                               K=so.K_SLOTS)
    iv = res.intervals
    ovf, n = iv.ovf.numpy(), iv.n.numpy().astype(np.int64)
    flat, pos = res.flat.numpy(), pos.numpy()
    offs = np.concatenate([[0], np.cumsum(np.minimum(flat[:, 2], opt.max_occ))])
    rows, per, start = [], [], 0
    for r in range(len(n)):
        k = 0 if ovf[r] else n[r]
        rows.append([tuple(v) for v in flat[start: start + k].tolist()])
        per.append([pos[offs[j]: offs[j + 1]].tolist()
                    for j in range(start, start + k)])
        start += k
    return n, ovf, rows, per, (iv.rows, iv.n, iv.ovf, iv.nks, res.flat,
                               res.ks, torch.from_numpy(pos))


def test_seed_sa_sharded_bit_equal_to_jax_shard_map(tables):
    t = tables
    opt = MemOptions()
    n, ovf, rows, pos, raw = _port_fused(t["sfm"], t["reads"], opt)
    jn, jovf, jrows, jpos = _jax_fused(t, t["reads"], opt)
    assert np.array_equal(ovf, jovf)
    ok = ~ovf
    assert np.array_equal(n[ok], jn[ok]) and sum(n[ok]) > len(t["reads"])
    for r in np.flatnonzero(ok):
        assert rows[r] == jrows[r] and pos[r] == jpos[r], r
    # and every output bit-equal to the unsharded tables'
    *_, raw1 = _port_fused(fo.DeviceFMIndex.from_host(t["fm"], "cpu"),
                           t["reads"], opt)
    for a, b in zip(raw, raw1):
        assert torch.equal(a, b)


def test_synthetic_fmindex_equals_the_reference():
    seq_len = 128 * 512
    a = jax_synth.synthetic_fmindex(seq_len, np.random.default_rng(11),
                                    sa_intv=64)
    b = synth.synthetic_fmindex(seq_len, np.random.default_rng(11), sa_intv=64)
    for f in ("words", "ckpt", "L2", "sa"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.primary, a.seq_len, a.sa_intv, a.n_blocks) == (
        b.primary, b.seq_len, b.sa_intv, b.n_blocks)


@pytest.mark.parametrize("n_shards", (2, 3, 8))
def test_sharded_forms_on_synthetic_index(n_shards):
    """Shard counts that do not divide the tables (padding), up to the
    kernels' most: occ4, the walk and seed+SA equal the unsharded forms and
    the host oracle on a synthetic index."""
    fm = synth.synthetic_fmindex(128 * 1024, np.random.default_rng(2),
                                 sa_intv=32)
    sfm = fo.ShardedFMIndex.from_host(fm, ["cpu"] * n_shards)
    dfm = fo.DeviceFMIndex.from_host(fm, "cpu")
    rng = np.random.default_rng(n_shards)
    ks = torch.from_numpy(rng.integers(-1, fm.seq_len + 1, 400))
    assert np.array_equal(fo.occ4_sharded(sfm, ks).numpy(), fm.occ4(ks.numpy()))
    # LF on a random BWT is a random permutation: keep the rows whose cycle
    # reaches a sample within 4,096 steps (the others would walk forever,
    # in the oracle too)
    rows = torch.from_numpy(rng.integers(0, fm.seq_len + 1, 300))
    k, ok = rows.clone(), torch.zeros(rows.shape[0], dtype=torch.bool)
    for _ in range(4096):
        ok |= k % fm.sa_intv == 0
        k = torch.where(ok, k, fo._lf(dfm, k))
    rows = rows[ok]
    assert rows.numel() > 250
    assert np.array_equal(fo.sa_lookup_sharded(sfm, rows).numpy(),
                          fm.sa_lookup(rows.numpy()))
    opt = MemOptions(min_seed_len=8)
    reads = [rng.integers(0, 4, 48).astype(np.uint8) for _ in range(5)]
    *_, raw = _port_fused(sfm, reads, opt)
    *_, raw1 = _port_fused(dfm, reads, opt)
    assert raw[4].shape[0] > 0  # some intervals were found
    for a, b in zip(raw, raw1):
        assert torch.equal(a, b)


def test_sharded_forms_refuse_the_unsharded_index_and_too_many_shards(tables):
    dfm = fo.DeviceFMIndex.from_host(tables["fm"], "cpu")
    with pytest.raises(ValueError):
        fo.occ4_sharded(dfm, torch.zeros(1, dtype=torch.long))
    with pytest.raises(ValueError):
        fo.sa_lookup_sharded(dfm, torch.zeros(1, dtype=torch.long))
    with pytest.raises(ValueError):
        fo.ShardedFMIndex.from_host(tables["fm"], ["cpu"] * (fo.MAX_SHARDS + 1))
