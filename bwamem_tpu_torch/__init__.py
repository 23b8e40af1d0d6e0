"""bwamem_tpu_torch: the PyTorch/CUDA port of bwamem_tpu.

A package of its own: it imports ``torch``, never ``jax`` and nothing of
``bwamem_tpu``; the host index, oracles and C++ natives it needs are its own
copies under the same module names.  The banded-SW extension waves, and by
``device_stages`` the seeding, the sampled-SA walks and the chaining, run in
hand-written Hopper kernels (``csrc/*.cu``) on the device the aligner is
given.  The public names are the JAX package's, ``metrics()`` included, and
``python -m bwamem_tpu_torch`` is its ``index``/``mem`` command line.
"""
from .api import (
    DO_NOT_INFER,
    FAILED,
    MEM_F_ALL,
    MEM_F_NO_MULTI,
    MEM_F_NO_RESCUE,
    MEM_F_NOPAIRING,
    MEM_F_PE,
    MEM_F_PRIMARY5,
    MEM_F_REF_HDR,
    MEM_F_SMARTPE,
    MEM_F_SOFTCLIP,
    Algorithm,
    BwaMemAligner,
    BwaMemAlignment,
    BwaMemIndex,
    BwaMemPairEndStats,
    MemOptions,
    exceptions,
)
from .api import __all__ as _api_all

__version__ = "0.2.0"

__all__ = [*_api_all, "metrics"]


def metrics():
    """Process-wide structured metrics snapshot (counters + stage timers);
    see utils/metrics.py for the env-gated dump/trace hooks."""
    from .utils import metrics as _m

    return _m.snapshot()
