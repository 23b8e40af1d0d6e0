"""The port's SW extension against the JAX package's, exactly (int32, no
tolerance): the plain PyTorch version against the XLA scan kernel, the
Pallas kernel in interpret mode and the scalar ksw_extend2 oracle; the
port's wave entry against the JAX package's.  The CUDA kernel is held
against the plain version in test_torch_cuda.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bwamem_tpu.api.options import MemOptions
from bwamem_tpu.engine import native_ksw
from bwamem_tpu.engine.extend import ksw_extend2
from bwamem_tpu.ops import extend_tpu
from bwamem_tpu.ops.extend_pallas import ksw_extend_pallas
from bwamem_tpu_torch.engine.state import device_scoring
from bwamem_tpu_torch.ops import extend as ext
from bwamem_tpu_torch.utils.extend_cases import ARRAYS, jobs, make_case

SMALL = ("square", "ragged", "edges", "zdrop0", "skewed")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version's small row ops lose to thread start-up, and the
    suite runs several workers at once: keep torch to one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(case, device="cpu"):
    args = [torch.from_numpy(case[k]).to(device) for k in ARRAYS]
    out = ext.ksw_extend(*args, **case["statics"])
    return {k: v.cpu().numpy() for k, v in out.items()}


def _assert_equal(ref, got):
    for k in ext.KEYS:
        assert np.array_equal(np.asarray(ref[k]), got[k]), k


@pytest.fixture(scope="module")
def results():
    return {name: (make_case(name), _torch(make_case(name))) for name in SMALL}


@pytest.mark.parametrize("name", SMALL)
def test_torch_matches_scan_kernel(results, name):
    case, got = results[name]
    ref = extend_tpu.ksw_extend_batch(
        *(jnp.asarray(case[k]) for k in ARRAYS), **case["statics"]
    )
    _assert_equal(ref, got)


@pytest.mark.parametrize("name", SMALL)
def test_torch_matches_pallas_interpret(results, name):
    case, got = results[name]
    ref = ksw_extend_pallas(
        *(jnp.asarray(case[k]) for k in ARRAYS), **case["statics"],
        interpret=True, b_tile=128,
    )
    _assert_equal(ref, got)


@pytest.mark.parametrize("name", SMALL)
def test_torch_matches_oracle(results, name):
    case, got = results[name]
    st = case["statics"]
    mat = case["mat"].reshape(-1).tolist()
    for b, (q, t) in enumerate(jobs(case)[0]):
        r = ksw_extend2(q, t, mat, st["o_del"], st["e_del"], st["o_ins"],
                        st["e_ins"], int(case["w"][b]),
                        int(case["end_bonus"][b]), st["zdrop"],
                        int(case["h0"][b]))
        assert {k: getattr(r, k) for k in ext.KEYS} == {
            k: int(got[k][b]) for k in ext.KEYS
        }, b


def test_torch_padded_target_width():
    """Target columns past every tlen change nothing: the row loop stops once
    every job is done, whatever the padded width."""
    case = make_case("ragged")
    wide = dict(case, tseq=np.pad(case["tseq"], ((0, 0), (0, 400))))
    _assert_equal(_torch(case), _torch(wide))


@pytest.mark.parametrize("seed", [2, 3])
def test_wave_entry_matches_jax(seed, monkeypatch):
    """Ragged job lists through the port's ksw_extend_batch_np and the JAX
    package's (scan route), with default and skewed scoring."""
    opt = MemOptions()
    if seed == 3:
        opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins = 2, 5, 5, 2, 7, 1
        opt.refresh_matrix()
    rng = np.random.default_rng(seed)
    n = 23
    qs = [rng.integers(0, 5, rng.integers(1, 70)).astype(np.uint8) for _ in range(n)]
    ts = [rng.integers(0, 5, rng.integers(0, 90)).astype(np.uint8) for _ in range(n)]
    h0s = rng.integers(1, 80, n).tolist()
    ws = rng.choice([1, 10, 100], n).tolist()
    bons = rng.choice([0, 5], n).tolist()
    sc = device_scoring(opt, "cpu")
    got = ext.ksw_extend_batch_np(qs, ts, sc, h0s, ws, bons)
    monkeypatch.setenv("BWAMEM_TPU_EXTEND_KERNEL", "scan")
    params = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop)
    ref = extend_tpu.ksw_extend_batch_np(qs, ts, opt.mat, params, h0s, ws, bons)
    assert got == [{k: int(v) for k, v in r.items()} for r in ref]
    if native_ksw.available():
        host = native_ksw.extend_batch(list(zip(qs, ts)), opt.mat, *params,
                                       h0s, ws, bons)
        assert got == host


def test_band_width_floor_division():
    """The shared band preamble matches the JAX kernels' floor division on
    negative numerators (qlen * max_sc + bonus < gap open)."""
    qlen = torch.tensor([0, 1, 3, 150], dtype=torch.int32)
    w = torch.tensor([100, 100, 100, 100], dtype=torch.int32)
    bonus = torch.tensor([0, 0, 5, 5], dtype=torch.int32)
    got = ext.band_width(qlen, w, bonus, 1, 6, 1, 7, 2)
    max_ins = np.maximum((qlen.numpy() + bonus.numpy() - 7) // 2 + 1, 1)
    max_del = np.maximum((qlen.numpy() + bonus.numpy() - 6) // 1 + 1, 1)
    assert got.tolist() == np.minimum(100, np.minimum(max_ins, max_del)).tolist()


def test_wrapper_refuses_cpu_tensors_for_kernel():
    case = make_case("ragged")
    args = [torch.from_numpy(case[k]) for k in ARRAYS]
    before = ext.LAUNCHES
    with pytest.raises(ValueError):
        ext.ksw_extend_cuda(*args, **case["statics"])
    assert ext.LAUNCHES == before
