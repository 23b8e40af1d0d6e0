"""bwamem_tpu_torch: the PyTorch/CUDA port of bwamem_tpu.

A package of its own: it imports ``torch``, never ``jax`` and nothing of
``bwamem_tpu``; the host index, oracles and C++ natives it needs are its own
copies under the same module names.  The banded-SW extension waves, and by
``device_stages`` the seeding, the sampled-SA walks and the chaining, run in
hand-written Hopper kernels (``csrc/*.cu``) on the device the aligner is
given.  The public names are the JAX package's, but for its ``metrics()``.
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
from .api import __all__

__version__ = "0.2.0"
