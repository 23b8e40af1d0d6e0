"""Suffix-array construction on the device (D11): prefix doubling over a
library sort.

The counterpart of bwamem_tpu/ops/sa_tpu.py ``suffix_array_device``, the
route ``index/sais.py`` takes when ``BWAMEM_TPU_DEVICE_SA=1``.  Manber-Myers
prefix doubling: round 0 ranks single symbols; each later round sorts the
key pair (rank[i], rank[i + k]) as one int64 key with a stable
``torch.sort``, re-ranks with a ``cumsum`` of the key changes and a
scatter, and doubles k, until every rank differs.  The JAX program is
itself XLA's library sort outside any Pallas kernel, so the sort here is
``torch.sort`` and no hand-written kernel: O(n log n) work in log2(n)
rounds of a full-array sort, scan and scatter.  The one copy back is the
finished SA (and one scalar a round, the loop's exit test).

The SA is over ``codes + [sentinel]`` (the sentinel below every symbol),
length n + 1, equal to the host SA-IS's; the domain is int32, as the JAX
program's (fewer than 2^31 - 1 suffixes).
"""
from __future__ import annotations

import numpy as np
import torch

INT32_LIMIT = np.iinfo(np.int32).max
# builds and sort rounds (one torch.sort each) on a card; bumped only there
LAUNCHES = {"suffix_array": 0, "sort_rounds": 0}


def suffix_array_device(codes: np.ndarray, device="cuda") -> np.ndarray:
    """SA of ``codes`` + sentinel, built on ``device``; int64 [n + 1] on
    the host.  Raises past the int32 domain of the JAX builder."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if len(codes) + 1 >= INT32_LIMIT:
        raise ValueError("device SA builder is int32-domain (< 2 Gbp)")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the device SA builder needs a card: CUDA is not "
                           "available")
    total = len(codes) + 1
    # rank 0 is the sentinel's; symbols rank from 1
    rank = torch.zeros(total, dtype=torch.int64, device=dev)
    rank[:-1] = torch.from_numpy(codes).to(dev).long() + 1
    on_card = dev.type == "cuda"
    LAUNCHES["suffix_array"] += on_card
    k = 0
    while True:
        # second key: rank[i + k] + 1, or 0 past the end (below every rank)
        second = torch.zeros_like(rank)
        if k:
            second[: total - k] = rank[k:] + 1
        key = rank * (total + 1) + second
        key_s, sa = torch.sort(key, stable=True)
        LAUNCHES["sort_rounds"] += on_card
        bump = torch.zeros(total, dtype=torch.int64, device=dev)
        bump[1:] = key_s[1:] != key_s[:-1]
        new_sorted = torch.cumsum(bump, 0)
        rank = torch.empty_like(rank).scatter_(0, sa, new_sorted)
        if int(new_sorted[-1]) == total - 1:
            return sa.cpu().numpy()
        k = 1 if k == 0 else 2 * k
        if k >= total:  # unreachable: the sentinel makes all ranks differ
            raise RuntimeError("prefix doubling did not separate the suffixes")
