"""The port's device suffix-array builder (``ops.sa.suffix_array_device``,
D11: prefix doubling over ``torch.sort``) on the CPU, against the JAX
package's ``suffix_array_device`` and the port's SA-IS, on tiny, fuzzed
and repeat-rich inputs (tolerance 0: integer results), as
tests/test_sa_device.py holds the JAX builder; and the ``index/sais.py``
route of ``BWAMEM_TPU_DEVICE_SA=1``, which builds on the card and raises
without one.  On the card the route's index is held byte-equal to the
host-built one (tests/test_torch_cuda.py, chip_smoke.py phase 18)."""
import numpy as np
import pytest

from bwamem_tpu.ops.sa_tpu import suffix_array_device as jax_sa
from bwamem_tpu_torch.index import native_sais
from bwamem_tpu_torch.index.sais import suffix_array, suffix_array_numpy
from bwamem_tpu_torch.ops import sa as saops
from bwamem_tpu_torch.ops.sa import suffix_array_device


def _oracle(codes):
    if native_sais.available():
        return native_sais.suffix_array(codes)
    return suffix_array_numpy(codes)


@pytest.mark.parametrize("codes", ([0], [0, 0], [3, 1, 2, 0], [1, 1, 1, 1, 1],
                                   [4, 4, 0], [5, 0, 5]))
def test_tiny(codes):
    arr = np.asarray(codes, dtype=np.uint8)
    got = suffix_array_device(arr, "cpu")
    assert got.dtype == np.int64 and len(got) == len(arr) + 1
    assert np.array_equal(got, _oracle(arr))
    assert np.array_equal(got, jax_sa(arr))


@pytest.mark.parametrize("style", ("random", "homopolymer", "periodic", "with_N"))
def test_fuzz(style):
    rng = np.random.default_rng(31 + len(style))
    for _ in range(10):
        n = int(rng.integers(1, 3000))
        if style == "random":
            codes = rng.integers(0, 4, n)
        elif style == "homopolymer":  # the longest chains of rank ties
            codes = np.zeros(n)
        elif style == "periodic":
            codes = np.tile(rng.integers(0, 4, int(rng.integers(1, 8))), n)[:n]
        else:
            codes = rng.integers(0, 6, n)
        codes = codes.astype(np.uint8)
        got = suffix_array_device(codes, "cpu")
        assert np.array_equal(got, _oracle(codes)), (style, n)
        assert np.array_equal(got, jax_sa(codes)), (style, n)


def test_repeat_rich_genome():
    """A doubled text with interspersed repeats, as the index builds it."""
    from bwamem_tpu_torch.index.build import revcomp_codes
    from bwamem_tpu_torch.utils.synth import synthetic_genome

    g = synthetic_genome(200_000, np.random.default_rng(4))
    g = np.where(g > 3, 0, g).astype(np.uint8)
    text = np.concatenate([g, revcomp_codes(g)]).astype(np.uint8)
    assert np.array_equal(suffix_array_device(text, "cpu"), _oracle(text))


def test_int32_domain_raises(monkeypatch):
    monkeypatch.setattr(saops, "INT32_LIMIT", 10)
    with pytest.raises(ValueError, match="int32"):
        suffix_array_device(np.zeros(9, np.uint8), "cpu")
    assert len(suffix_array_device(np.zeros(8, np.uint8), "cpu")) == 9


def test_index_route_needs_the_card(monkeypatch):
    """BWAMEM_TPU_DEVICE_SA=1 sends the index build's SA to the card; with
    no card it raises, and no host builder stands in."""
    codes = np.random.default_rng(1).integers(0, 4, 500).astype(np.uint8)
    monkeypatch.setenv("BWAMEM_TPU_DEVICE_SA", "0")
    assert np.array_equal(suffix_array(codes), _oracle(codes))
    monkeypatch.setenv("BWAMEM_TPU_DEVICE_SA", "1")
    calls = []
    monkeypatch.setattr(saops, "suffix_array_device",
                        lambda c, d: calls.append(d) or _oracle(c))
    assert np.array_equal(suffix_array(codes), _oracle(codes))
    assert calls == ["cuda"]
    monkeypatch.undo()
    monkeypatch.setenv("BWAMEM_TPU_DEVICE_SA", "1")
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            suffix_array(codes)
