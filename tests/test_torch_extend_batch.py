"""The port's wave-batched chain extension against the JAX package's,
region for region and field by field, on a repeat-rich synthetic genome
(several chains per read, band-doubling retries)."""
import numpy as np
import pytest
import torch

from bwamem_tpu.api.index import BwaMemIndex as JaxIndex
from bwamem_tpu.api.options import MemOptions as JaxOptions
from bwamem_tpu.engine import chain as jax_chain
from bwamem_tpu.engine import extend_batch as ref_batch
from bwamem_tpu.engine.exec_ctx import ExecConfig as JaxExecConfig
from bwamem_tpu_torch.api.index import BwaMemIndex
from bwamem_tpu_torch.api.options import MemOptions
from bwamem_tpu_torch.engine import extend_batch as port_batch
from bwamem_tpu_torch.engine import native_chain, native_fm
from bwamem_tpu_torch.engine.exec_ctx import ExecConfig
from bwamem_tpu_torch.engine.pipeline import _chains
from bwamem_tpu_torch.index import image
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.ops import extend as ext
from bwamem_tpu_torch.utils.encoding import revcomp_codes
from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig
from bwamem_tpu_torch.utils.synth import synthetic_genome


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version's small row ops lose to thread start-up, and the
    suite runs several workers at once: keep torch to one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reads(codes, rng, n, rlen=150):
    """Reads with substitutions, indels, and every fourth one 320 bp long
    across a 90 bp deletion: an extension that far off the diagonal pays
    for its gap only on a long flank, and needs the doubled band."""
    reads = []
    for k in range(n):
        ln = 320 if k % 4 == 0 else rlen
        start = int(rng.integers(0, len(codes) - 2 * ln))
        r = codes[start: start + ln + 90].copy()
        if k % 4 == 0:
            p = int(rng.integers(130, 190))
            r = np.concatenate([r[:p], r[p + 90:]])
        elif k % 4 == 1:  # 12 bp insertion
            p = int(rng.integers(30, 110))
            r = np.concatenate([r[:p], rng.integers(0, 4, 12).astype(np.uint8),
                                r[p:]])
        r = r[:ln].copy()
        flip = rng.random(ln) < 0.01
        r[flip] = (r[flip] + 1) % 4
        r[r > 3] = 0
        reads.append(revcomp_codes(r) if rng.random() < 0.5 else r)
    return reads


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    codes = synthetic_genome(200_000, np.random.default_rng(7))
    img = str(tmp_path_factory.mktemp("g") / "g.img")
    image.write_image(img, build_index(Fasta([FastaContig("chr", "", codes)])))
    index = BwaMemIndex(img)
    eng = index._require()
    opt = MemOptions()
    reads = _reads(codes, np.random.default_rng(8), 160)
    chains = _chains(opt, eng, reads, ExecConfig(device="cpu"))
    yield opt, eng, reads, chains
    index.close()


@pytest.fixture(scope="module")
def jax_setup(setup, tmp_path_factory):
    """The JAX package's own index of the same genome, and the same chains
    as its objects."""
    _, eng, _, chains = setup
    img = str(tmp_path_factory.mktemp("j") / "g.img")
    image.write_image(img, eng.idx)
    index = JaxIndex(img)
    jchains = [[jax_chain.Chain(
        rid=c.rid, is_alt=c.is_alt, frac_rep=c.frac_rep, w=c.w, kept=c.kept,
        first=c.first, seeds=[jax_chain.Seed(s.rbeg, s.qbeg, s.len, s.score)
                              for s in c.seeds]) for c in cs] for cs in chains]
    yield JaxOptions(), index._require(), jchains
    index.close()


def _fields(regs_list):
    return [[vars(a) for a in regs] for regs in regs_list]


@pytest.fixture(scope="module")
def port_regs(setup):
    opt, eng, reads, chains = setup
    port_batch.STATS.reset()
    before = ext.LAUNCHES
    regs = port_batch.chain2aln_batch(
        opt, eng.idx, reads, chains, ExecConfig(device="cpu", min_device_jobs=1)
    )
    stats = vars(port_batch.STATS).copy()
    assert ext.LAUNCHES == before  # CPU tensors never reach the kernel
    return regs, stats


def test_genome_exercises_chains_and_retries(setup, port_regs):
    opt, _, _, chains = setup
    regs, stats = port_regs
    assert max(len(c) for c in chains) > 1
    assert any(a.w > opt.w for r in regs for a in r)  # band doubled
    assert stats["host_extend_jobs"] == 0
    assert stats["device_extend_jobs"] > 0
    assert stats["device_extend_waves"] > 2


@pytest.mark.parametrize("device_extend", [False, True])
def test_regions_match_jax_package(setup, jax_setup, port_regs, device_extend):
    """device_extend=False: the reference's host waves (C++ ksw);
    True: its JAX waves on the CPU for waves of 48 jobs and more."""
    reads = setup[2]
    opt, eng, chains = jax_setup
    ref = ref_batch.chain2aln_batch(
        opt, eng.idx, reads, chains,
        exec_cfg=JaxExecConfig(device_extend=device_extend),
    )
    assert _fields(port_regs[0]) == _fields(ref)


def test_host_routing_counts_small_waves(setup, port_regs):
    """With the default threshold, waves under 48 jobs run on the host and
    are counted there; the regions do not change."""
    opt, eng, reads, chains = setup
    port_batch.STATS.reset()
    regs = port_batch.chain2aln_batch(opt, eng.idx, reads, chains,
                                      ExecConfig(device="cpu"))
    st = port_batch.STATS
    assert st.host_extend_jobs > 0 and st.device_extend_jobs > 0
    assert st.host_extend_jobs + st.device_extend_jobs == (
        port_regs[1]["device_extend_jobs"])
    assert _fields(regs) == _fields(port_regs[0])


def test_python_seeding_fallback_gives_same_chains(setup, monkeypatch):
    """The pipeline's no-native route (Python seeding and chaining) builds
    the chains the native route does."""
    opt, eng, reads, chains = setup
    monkeypatch.setattr(native_fm, "available", lambda: False)
    monkeypatch.setattr(native_chain, "available", lambda: False)
    py = _chains(opt, eng, reads[:24], ExecConfig(device="cpu"))

    def key(cs):
        return [[(c.rid, c.pos, [(s.rbeg, s.qbeg, s.len) for s in c.seeds])
                 for c in r] for r in cs]

    assert key(py) == key(chains[:24])
