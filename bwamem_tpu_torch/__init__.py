"""bwamem_tpu_torch: the PyTorch/CUDA port of bwamem_tpu.

A package of its own: it imports ``torch``, never ``jax`` and nothing of
``bwamem_tpu``; the host index, oracles and C++ natives it needs are its own
copies under the same module names.  The banded-SW extension waves, and by
``device_stages`` the seeding, the sampled-SA walks and the chaining, run in
hand-written Hopper kernels (``csrc/*.cu``) on the device the aligner is
given.
"""
from .api import (
    BwaMemAligner, BwaMemAlignment, BwaMemIndex, BwaMemPairEndStats,
    MemOptions,
)

__all__ = [
    "BwaMemAligner", "BwaMemAlignment", "BwaMemIndex", "BwaMemPairEndStats",
    "MemOptions",
]
