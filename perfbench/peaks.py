"""The yardstick of the rooflines: the card's published peaks, the least
time a kernel's work could take, and a kernel's device time by its name.

Peaks are NVIDIA's data sheet for the H100 SXM part at its 700 W limit:
HBM3 at 3.35 TB/s, and the int32 rate of its 64 integer lanes per SM (half
the float32 lanes, whose 67 TFLOP/s count a fused multiply-add as two).
A card that is not in the table has no roofline: its readers return
nothing rather than a guess.
"""
from __future__ import annotations

import re

PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_s=3.35e12, int32_ops_s=67e12 / 4),
}


def bound_s(kind: str, nbytes: float, ops: float):
    """The least seconds the card could take: ``nbytes`` (each input read
    once, each output written once) at the memory rate, or ``ops`` integer
    operations at the int32 rate, whichever is larger; None off the table."""
    p = PEAKS.get(kind)
    if p is None:
        return None
    return max(nbytes / p["hbm_bytes_s"], ops / p["int32_ops_s"])


def kernel_s(by_name: dict, kernel: str) -> float:
    """Device seconds of the kernels whose function is named ``kernel``
    (in any namespace, with any template arguments)."""
    pat = re.compile(r"(?:^|[\s:])" + re.escape(kernel) + r"\s*[<(]")
    return sum(s for name, s in by_name.items() if pat.search(name))
