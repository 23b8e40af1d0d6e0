from . import exceptions
from .aligner import BwaMemAligner
from .alignment import BwaMemAlignment
from .index import Algorithm, BwaMemIndex
from .options import (
    MEM_F_ALL,
    MEM_F_NO_MULTI,
    MEM_F_NO_RESCUE,
    MEM_F_NOPAIRING,
    MEM_F_PE,
    MEM_F_PRIMARY5,
    MEM_F_REF_HDR,
    MEM_F_SMARTPE,
    MEM_F_SOFTCLIP,
    MemOptions,
)
from .pestats import DO_NOT_INFER, FAILED, BwaMemPairEndStats

__all__ = [
    "BwaMemAligner", "BwaMemAlignment", "BwaMemIndex", "BwaMemPairEndStats",
    "Algorithm", "MemOptions", "exceptions", "DO_NOT_INFER", "FAILED",
    "MEM_F_PE", "MEM_F_ALL", "MEM_F_NOPAIRING", "MEM_F_NO_MULTI",
    "MEM_F_NO_RESCUE", "MEM_F_REF_HDR", "MEM_F_SOFTCLIP", "MEM_F_SMARTPE",
    "MEM_F_PRIMARY5",
]
