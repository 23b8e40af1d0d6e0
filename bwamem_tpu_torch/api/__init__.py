from bwamem_tpu.api.alignment import BwaMemAlignment
from bwamem_tpu.api.index import BwaMemIndex
from bwamem_tpu.api.options import MemOptions
from bwamem_tpu.api.pestats import BwaMemPairEndStats

from .aligner import BwaMemAligner

__all__ = [
    "BwaMemAligner", "BwaMemAlignment", "BwaMemIndex", "BwaMemPairEndStats",
    "MemOptions",
]
