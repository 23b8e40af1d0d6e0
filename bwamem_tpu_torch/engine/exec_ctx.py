"""Where the port's pipeline runs its device stages.

The JAX package resolves its routing from environment variables and a
host-device link probe (bwamem_tpu/engine/exec_ctx.py); the port names its
device explicitly and has no probe.  ``min_device_jobs`` keeps the
reference's small-wave routing (bwamem_tpu/engine/extend_batch.py
HOST_FALLBACK_JOBS): a wave with fewer jobs runs on the host, where a launch
and two copies would cost more than the DP itself.  ``device_sa_lookup``
sends every sampled-SA walk of a batch to the device, ``device_seed`` the
three seeding rounds and ``device_chain`` the chaining and chain filter
(the JAX package's fields of the same names); they are set only through
the aligner's ``device_stages``, never from the environment.
``device_pipeline`` (the JAX field's name, set only by the aligner's keyword)
sends a batch through the fused device path, seeding to regions on the
device (``engine.pipeline_device``), whatever the three stage switches say.

``KEEP_LARGEST`` is a bench hook, off by default: when a caller sets it, the
stats objects keep the largest batch's device tensors and job lists
(``SA_STATS.largest_rows``, ``CHAIN_STATS.largest_table``,
``STATS.largest_wave``, ``FUSED_STATS.largest_batch``) so that a benchmark
can time the kernels on them; without it nothing outlives its batch.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

# below this many jobs a device wave's launch and two copies cost more than
# the DP on the host (bwamem_tpu/engine/extend_batch.py HOST_FALLBACK_JOBS)
HOST_FALLBACK_JOBS = 48
KEEP_LARGEST = False


@dataclass(frozen=True)
class ExecConfig:
    device: torch.device
    min_device_jobs: int = HOST_FALLBACK_JOBS
    device_sa_lookup: bool = False
    device_seed: bool = False
    device_chain: bool = False
    device_pipeline: bool = False

    def __post_init__(self):
        object.__setattr__(self, "device", torch.device(self.device))
