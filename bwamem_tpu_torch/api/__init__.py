from .aligner import BwaMemAligner
from .alignment import BwaMemAlignment
from .index import BwaMemIndex
from .options import MemOptions
from .pestats import BwaMemPairEndStats

__all__ = [
    "BwaMemAligner", "BwaMemAlignment", "BwaMemIndex", "BwaMemPairEndStats",
    "MemOptions",
]
