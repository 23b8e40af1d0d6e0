"""Every ctypes entry of the port's ops runs under the device guard of its
operands' card (``utils.cudabuild.on_device``), so that the launchers'
``cudaGetDevice`` (csrc/chain.cu, chain2aln.cu and extend.cu size their
persistent grids from it) reads that card and not the calling thread's
current one: an aligner on ``cuda:1``, or a mesh shard, would otherwise
launch on a stream of card 1 while card 0 is current.

On the CPU: the operands are tensors that report ``cuda:1``, the library is
a fake that records the current device at each call, and a recorder
stands in for ``torch.cuda.device``.  Each ``*_launch`` (and each
occupancy or shared-memory query) must reach the library with ``cuda:1``
current; without the guard the recorder's current device is None."""
from types import SimpleNamespace

import pytest
import torch

from bwamem_tpu_torch.ops import chain as co
from bwamem_tpu_torch.ops import extend as ext
from bwamem_tpu_torch.ops import fmindex as fo
from bwamem_tpu_torch.ops import pipeline_fused as fu
from bwamem_tpu_torch.ops import seed as so

CARD = torch.device("cuda", 1)


class OnCard(torch.Tensor):
    """A CPU tensor that reports the card ``CARD``."""

    @property
    def device(self):
        return CARD


def t(*shape, dtype=torch.int64):
    return torch.zeros(shape, dtype=dtype).as_subclass(OnCard)


class Recorder:
    """Stands for ``torch.cuda.device``: entering makes ``dev`` current."""

    current = None

    def __init__(self, dev):
        self.dev = torch.device(dev)

    def __enter__(self):
        self.prev, Recorder.current = Recorder.current, self.dev
        return self

    def __exit__(self, *exc):
        Recorder.current = self.prev


class FakeLib:
    """Every entry records (name, the current device) and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, Recorder.current))
            return 0
        return entry


@pytest.fixture
def lib(monkeypatch):
    fake = FakeLib()
    for mod in (fo, so, co, fu, ext):
        monkeypatch.setattr(mod, "_lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", Recorder)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    for name in ("empty", "zeros"):
        orig = getattr(torch, name)

        def alloc(*a, _orig=orig, device=None, **k):
            out = _orig(*a, **k)
            return out.as_subclass(OnCard) if device is not None else out
        monkeypatch.setattr(torch, name, alloc)
    Recorder.current = None
    return fake


def _dfm():
    return fo.DeviceFMIndex(lines=t(4, 12, dtype=torch.int32), L2=t(5),
                            sa=t(8), primary=3, seq_len=500, sa_intv=8,
                            span=128)


def _sfm():
    return fo.ShardedFMIndex(
        line_shards=(t(2, 12, dtype=torch.int32), t(2, 12, dtype=torch.int32)),
        sa_shards=(t(4), t(4)), L2=t(5), primary=3, seq_len=500, sa_intv=8,
        span=128, blocks_per_shard=2, sa_per_shard=4)


def _fm_launches():
    d, s, i32 = _dfm(), _sfm(), torch.int32
    q, ql = t(2, 8, dtype=torch.uint8), t(2, dtype=i32)
    params = so.SeedParams(19, 28, 10, 20, 500)
    return {
        "occ4": lambda: fo.occ4_launch(d, t(3), t(3, 4, dtype=i32), t(1, dtype=i32)),
        "bwt_extend": lambda: fo.extend_launch(
            d, t(3), t(3), t(3), True, t(3, 4), t(3, 4), t(3, 4, dtype=i32),
            t(1, dtype=i32)),
        "sa_lookup": lambda: fo.sa_lookup_launch(d, t(3), t(3), t(1, dtype=i32)),
        "line_chase": lambda: fo.line_chase_launch(d, 0, 4, t(1)),
        "backward_search": lambda: fo.backward_search_launch(
            d, q, ql, t(2), t(2), t(2, dtype=i32)),
        "occ4_sharded": lambda: fo.occ4_launch(s, t(3), t(3, 4, dtype=i32),
                                               t(1, dtype=i32)),
        "sa_lookup_sharded": lambda: fo.sa_lookup_launch(s, t(3), t(3),
                                                         t(1, dtype=i32)),
        "smem1a": lambda: so.smem1a_launch(
            d, q, ql, t(2, dtype=i32), t(2), t(2, dtype=i32), t(2, 4, 5),
            t(2, dtype=i32), t(2, dtype=i32), t(1, dtype=i32)),
        "strategy1": lambda: so.strategy1_launch(
            d, q, ql, t(2, dtype=i32), 20, 20, t(2, dtype=i32), t(2, 5),
            t(2, dtype=i32), t(1, dtype=i32)),
        "collect_intv": lambda: so.collect_intv_launch(
            d, q, ql, params, 4, 4, t(2, 4, 5), t(2, dtype=i32),
            t(2, dtype=i32), t(2), t(1, dtype=i32)),
        "collect_intv_sharded": lambda: so.collect_intv_launch(
            s, q, ql, params, 4, 4, t(2, 4, 5), t(2, dtype=i32),
            t(2, dtype=i32), t(2), t(1, dtype=i32)),
        "sample_ks": lambda: so.sample_ks_launch(
            t(2, 4, 5), t(2, dtype=i32), t(2), t(2), 500, t(3, 5), t(6)),
    }


def _chain_launches():
    i32 = torch.int32
    ctg = SimpleNamespace(device=CARD, ctg_end=t(2), ctg_alt=t(2),
                          ctg_off=t(2), l_pac=100)
    tab = co.SeedTable(t(2, dtype=i32), t(3, 5), t(2), t(2), t(4), t(3), t(3))
    cp = SimpleNamespace(w=100, max_chain_gap=10000, min_chain_weight=0,
                         min_seed_len=19, max_chain_extend=50, max_occ=500,
                         mask_level=0.5, drop_ratio=0.5)
    chains = SimpleNamespace(chain_rows=t(2, 8), seed_rows=t(4, 4))
    lay = SimpleNamespace(chain_seed_off=t(2), chain_read=t(2, dtype=i32))
    ep = SimpleNamespace(a=1, o_del=6, e_del=1, o_ins=6, e_ins=1, zdrop=100,
                         w=100, pen_clip5=5, pen_clip3=5, max_sc=1)
    ref = SimpleNamespace(pac=t(25, dtype=torch.uint8), l_pac=100)
    q, ql = t(2, 8, dtype=torch.uint8), t(2, dtype=i32)
    return {
        "chain": lambda: co.chain_launch(
            ctg, tab, t(2), cp, 4, t(2, dtype=i32), t(4, dtype=i32),
            t(4, dtype=i32), t(4, 5, dtype=i32), t(2), t(2), t(2, dtype=torch.float64),
            t(2, dtype=i32), t(2, dtype=i32), t(1, dtype=i32)),
        "chain_emit": lambda: co.chain_emit_launch(
            ctg, tab, t(2), t(2, dtype=i32), t(4, dtype=i32), t(4, dtype=i32),
            t(4, 5, dtype=i32), t(2), t(2, dtype=torch.float64), t(2), t(2),
            t(2, 8), t(4, 4)),
        "chain2aln_prep": lambda: fu.chain2aln_prep_launch(
            ctg, chains, lay, ql, ep, t(2, 2), t(4, dtype=i32), t(1, dtype=i32)),
        "chain2aln": lambda: fu.chain2aln_launch(
            ref, chains, lay, t(2), t(2), t(2), t(2), t(2, 2), t(4, dtype=i32),
            t(4, dtype=torch.uint8), t(2, dtype=torch.uint8), q, ql,
            t(5, 5, dtype=i32), ep, 1 << 30, t(2, dtype=i32), 8,
            t(2, 16, 11), t(2, 16, 3), t(2, dtype=i32), t(2, 8, dtype=i32),
            t(1, dtype=i32)),
        "band_width": lambda: fu.band_width_cuda(
            t(3, dtype=i32), t(3, dtype=i32), t(3, dtype=i32), 1, 6, 1, 6, 1),
        "ksw_extend": lambda: ext.ksw_extend_launch(
            t(2, 8, dtype=torch.uint8), t(2, 8, dtype=torch.uint8),
            t(2, 4, dtype=i32), t(5, 5, dtype=i32), 8, 6, 1, 6, 1, 100,
            ext.WavePlan(t(2, dtype=i32), t(2, dtype=i32), 0, 8, 0,
                         t(2, dtype=i32))),
    }


def _cases():
    return sorted(set(_fm_launches()) | set(_chain_launches()))


@pytest.mark.parametrize("name", _cases())
def test_launch_runs_under_its_operands_device(lib, name):
    launch = {**_fm_launches(), **_chain_launches()}[name]
    launch()
    assert lib.calls, "the launcher did not reach the library"
    for entry, current in lib.calls:
        assert current == CARD, f"{entry} called with {current} current"
    assert Recorder.current is None  # the guard was left


@pytest.mark.parametrize("query", (
    lambda: ext.kernel_max_qlen(CARD),
    lambda: ext.warps_per_sm(64, CARD),
    lambda: so.warps_per_sm(device=CARD),
    lambda: co.warps_per_sm(CARD),
    lambda: fu.warps_per_sm(64, CARD),
    lambda: fu.kernel_max_qlen(torch.ones(5, 5, dtype=torch.int32), CARD),
), ids=("ksw_max_qlen", "ksw_warps", "seed_warps", "chain_warps",
        "chain2aln_warps", "chain2aln_max_qlen"))
def test_card_queries_run_under_the_named_device(lib, query):
    query()
    assert lib.calls and all(cur == CARD for _, cur in lib.calls)


def test_the_guard_is_torch_cuda_device(monkeypatch):
    """``on_device`` is ``torch.cuda.device`` of the operands' card."""
    from bwamem_tpu_torch.utils import cudabuild

    monkeypatch.setattr(torch.cuda, "device", Recorder)
    with cudabuild.on_device("cuda:1") as g:
        assert Recorder.current == CARD and isinstance(g, Recorder)
    assert Recorder.current is None
