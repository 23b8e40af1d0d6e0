"""Pair-end insert-size statistics.

Parity with BwaMemPairEndStats.java: the Java mirror of bwa's mem_pestat_t
with the same derivation rules (low/high = avg -/+ 4 sigma clamped >= 1,
default std = 0.1 * avg; BwaMemPairEndStats.java:24-33, 98-124) and the
FAILED / DO_NOT_INFER singleton semantics (:39-45).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

DEFAULT_LOW_AND_HIGH_SIGMA = 4
DEFAULT_STD_TO_AVERAGE_RATIO = 0.1


@dataclass(frozen=True)
class BwaMemPairEndStats:
    average: float
    std: float
    low: int
    high: int
    failed: bool = False

    def __post_init__(self):
        if self.failed:
            return
        if math.isnan(self.average) or math.isinf(self.average) or self.average < 1:
            raise ValueError(f"invalid input average: {self.average}")
        if math.isnan(self.std) or math.isinf(self.std) or self.std < 0:
            raise ValueError(f"invalid std. err: {self.std}")
        if self.low > self.average:
            raise ValueError("the low limit cannot be larger than the average")
        if self.high < self.average:
            raise ValueError("the high limit cannot be smaller than the average")

    @classmethod
    def of(cls, average: float, std: float | None = None, low: int | None = None,
           high: int | None = None) -> "BwaMemPairEndStats":
        """Mirrors the three public constructors (BwaMemPairEndStats.java:98-156)."""
        if std is None:
            std = average * DEFAULT_STD_TO_AVERAGE_RATIO
        if low is None:
            low = max(1, round(average - DEFAULT_LOW_AND_HIGH_SIGMA * std))
        if high is None:
            high = max(1, round(average + DEFAULT_LOW_AND_HIGH_SIGMA * std))
        return cls(average=float(average), std=float(std), low=int(low), high=int(high))

    def __str__(self):
        if self.failed:
            return "InsertSize ~ FAILED/DO_NOT_INFER"
        return (
            f"InsertSize ~ N({self.average:.2f}, {self.std:.2f})"
            f" in [{self.low}, {self.high}]"
        )


FAILED = BwaMemPairEndStats(
    average=float("nan"), std=float("nan"), low=(1 << 31) - 1, high=-(1 << 31),
    failed=True,
)
DO_NOT_INFER = FAILED
