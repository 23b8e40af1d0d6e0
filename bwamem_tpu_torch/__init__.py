"""bwamem_tpu_torch: the PyTorch/CUDA port of bwamem_tpu.

Host seeding, SA walks, chaining and record assembly are bwamem_tpu's own
(imported, JAX-free); the banded-SW extension waves run in a hand-written
Hopper kernel (``csrc/extend.cu``) on the device the aligner is given.
"""
from .api import (
    BwaMemAligner, BwaMemAlignment, BwaMemIndex, BwaMemPairEndStats,
    MemOptions,
)

__all__ = [
    "BwaMemAligner", "BwaMemAlignment", "BwaMemIndex", "BwaMemPairEndStats",
    "MemOptions",
]
