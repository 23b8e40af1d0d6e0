"""The port's public names cover the JAX package's: ``__all__`` of the
package (``metrics`` included) and of its ``api`` sub-package, and each
name stands for the same thing."""
import enum

import pytest

import bwamem_tpu
import bwamem_tpu.api
import bwamem_tpu_torch
import bwamem_tpu_torch.api


@pytest.mark.parametrize("ref, port", [
    (bwamem_tpu, bwamem_tpu_torch), (bwamem_tpu.api, bwamem_tpu_torch.api)],
    ids=("package", "api"))
def test_all_covers_the_reference(ref, port):
    missing = set(ref.__all__) - set(port.__all__)
    assert not missing
    for name in port.__all__:
        assert hasattr(port, name), name


@pytest.mark.parametrize("name", [n for n in bwamem_tpu.__all__
                                  if n.startswith("MEM_F_")])
def test_flags_are_the_references(name):
    assert getattr(bwamem_tpu_torch, name) == getattr(bwamem_tpu, name)


def test_named_values_are_the_references():
    from bwamem_tpu_torch import (DO_NOT_INFER, FAILED, MEM_F_PE, Algorithm,
                                  BwaMemPairEndStats, exceptions)

    assert MEM_F_PE == bwamem_tpu.MEM_F_PE
    assert DO_NOT_INFER is FAILED and DO_NOT_INFER.failed
    assert isinstance(DO_NOT_INFER, BwaMemPairEndStats)
    assert ({k: repr(v) for k, v in vars(DO_NOT_INFER).items()}
            == {k: repr(v) for k, v in vars(bwamem_tpu.DO_NOT_INFER).items()})
    assert issubclass(Algorithm, enum.Enum)
    assert ([(m.name, m.value) for m in Algorithm]
            == [(m.name, m.value) for m in bwamem_tpu.Algorithm])
    assert bwamem_tpu_torch.__version__ == bwamem_tpu.__version__
    assert exceptions.__name__ == "bwamem_tpu_torch.api.exceptions"
    ref_exc = {n for n in dir(bwamem_tpu.exceptions)
               if isinstance(getattr(bwamem_tpu.exceptions, n), type)
               and issubclass(getattr(bwamem_tpu.exceptions, n), Exception)}
    assert ref_exc <= set(dir(exceptions))
