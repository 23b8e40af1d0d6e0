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

``force_waves`` (the JAX field's name; no aligner keyword and no
environment variable sets it) keeps a host-only configuration on the
extension waves of ``extend_batch`` instead of the fused host chain+extend
core (``engine.native_core``) and the whole-batch host route
(``engine.native_pipeline``); a configuration on a card always has it
(``want_force_waves``), so no batch of a card aligner runs all on the host.

``mesh`` (a ``parallel.mesh.Mesh``, the JAX field's name) splits the device
stages over several devices: the extension waves by jobs
(``ops.extend.ksw_extend_batch_mesh``), the seeding, SA walks and chaining
of the staged route and the whole fused path by reads, one contiguous
sub-batch a device (``engine.pipeline``, ``engine.pipeline_device``); the
merged region rows go to the one C++ tail.  ``mesh_exec`` builds such a
configuration (bwamem_tpu/engine/exec_ctx.py ``mesh_exec``): the extension
always in device waves, ``device`` the mesh's first device.  ``on(dev)`` is
the configuration of one shard: the same switches on ``dev``, no mesh.

``KEEP_LARGEST`` is a bench hook, off by default: when a caller sets it, the
stats objects keep the largest batch's device tensors and job lists
(``SA_STATS.largest_rows``, ``CHAIN_STATS.largest_table``,
``STATS.largest_wave``, ``FUSED_STATS.largest_batch``) so that a benchmark
can time the kernels on them; without it nothing outlives its batch.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

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
    force_waves: bool = False
    mesh: Any = None  # parallel.mesh.Mesh: split the device stages over it

    def __post_init__(self):
        object.__setattr__(self, "device", torch.device(self.device))

    def want_force_waves(self) -> bool:
        """Extension in the cross-read waves: asked for, or on a card."""
        return self.force_waves or self.device.type != "cpu"

    def on(self, device) -> "ExecConfig":
        """One shard's configuration: these switches on ``device``."""
        return replace(self, device=device, mesh=None)

    def any_device_stage(self) -> bool:
        """Whether any stage leaves the host-only whole-batch route
        (bwamem_tpu/engine/exec_ctx.py ``any_device_stage``)."""
        return (self.mesh is not None or self.want_force_waves()
                or self.device_seed
                or self.device_chain or self.device_sa_lookup
                or self.device_pipeline)


def mesh_exec(mesh, device_stages=(), min_device_jobs: int = HOST_FALLBACK_JOBS,
              device_pipeline: bool = False) -> ExecConfig:
    """The mesh execution profile: the extension always in device waves,
    split over ``mesh``; ``device_stages`` (any of "seed", "sa_lookup",
    "chain") and ``device_pipeline`` as the aligner takes them, each split
    over the mesh by reads.  Unknown stages raise."""
    stages = set(device_stages)
    unknown = stages - {"seed", "sa_lookup", "chain"}
    if unknown:
        raise ValueError(f"unknown device stages: {sorted(unknown)}")
    return ExecConfig(device=mesh.flat[0], min_device_jobs=min_device_jobs,
                      device_sa_lookup="sa_lookup" in stages,
                      device_seed="seed" in stages,
                      device_chain="chain" in stages,
                      device_pipeline=bool(device_pipeline),
                      force_waves=True, mesh=mesh)
