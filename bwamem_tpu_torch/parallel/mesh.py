"""The device mesh of the aligner's parallel axes.

The counterpart of bwamem_tpu/parallel/mesh.py.  A ``Mesh`` is a
``(data, idx)`` grid of ``torch.device``s with the JAX mesh's axis names:

  * ``data``: batches of reads (and the jobs of an extension wave), split
    in contiguous shards over every device of the mesh;
  * ``idx``: the FM tables split in contiguous slices over the devices of
    one row (``ops.fmindex.ShardedFMIndex``), for indexes past one card.

``make_mesh`` takes the cards ``cuda:0..n-1`` by default.  An explicit
``devices`` list may repeat a device: ``cuda:0`` four times, or ``cpu``,
is the virtual mesh of the tests and of ``chip_smoke.py``, in which each
"device" has its own shard, its own launches and its own thread, and
shares its card's tables and memory with the others.

``shard_batch`` splits dim 0 of an array into one contiguous shard per
device (sizes that differ by at most one), ``replicate`` builds a host
object's device form once per distinct device through the per-device
caches of ``engine/state.py``, and ``run_shards`` runs one call per shard,
each in its own thread, so that no shard's launches wait on another
shard's results (on distinct cards they overlap), and returns the results
in shard order.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import cudabuild

AXES = ("data", "idx")


@dataclass(frozen=True)
class Mesh:
    """A ``(data, idx)`` grid of devices: ``devices[i][j]`` is row ``i`` of
    the data axis, slice ``j`` of the idx axis."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = AXES

    def __post_init__(self):
        rows = tuple(tuple(torch.device(d) for d in row) for row in self.devices)
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        object.__setattr__(self, "devices", rows)

    @property
    def shape(self) -> dict:
        """{"data": rows, "idx": devices a row}, as the JAX mesh's."""
        return dict(zip(self.axis_names, (len(self.devices),
                                          len(self.devices[0]))))

    @property
    def flat(self) -> Tuple[torch.device, ...]:
        """Every device, row after row: the order of the batch's shards."""
        return tuple(d for row in self.devices for d in row)

    @property
    def size(self) -> int:
        return len(self.flat)


def make_mesh(n_devices: Optional[int] = None, idx_shards: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over (data, idx); ``idx_shards`` divides the device count.
    Without ``devices``, the cards ``cuda:0..n-1`` (all of them when
    ``n_devices`` is None); more than ``torch.cuda.device_count()`` raises.
    ``devices`` may name any devices, repeats included (a virtual mesh);
    a CUDA device that this machine lacks raises."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_devices is None else int(n_devices)
        if n_devices is not None and (idx_shards < 1 or n % idx_shards):
            raise ValueError(f"idx_shards {idx_shards} must divide device "
                             f"count {n}")
        if n < 1 or n > have:
            raise RuntimeError(f"a mesh of {n} cards asked for, {have} present")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [torch.device(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"{n_devices} devices asked for, "
                                 f"{len(devs)} given")
            devs = devs[:n_devices]
        for d in devs:
            if d.type == "cuda" and not (
                    torch.cuda.is_available()
                    and (d.index or 0) < torch.cuda.device_count()):
                raise RuntimeError(f"device {d} is not present")
    n = len(devs)
    if idx_shards < 1 or n % idx_shards:
        raise ValueError(f"idx_shards {idx_shards} must divide device count {n}")
    return Mesh(tuple(tuple(devs[r * idx_shards:(r + 1) * idx_shards])
                      for r in range(n // idx_shards)))


def split_offsets(n: int, parts: int) -> np.ndarray:
    """[parts + 1] int64 offsets of ``n`` items in ``parts`` contiguous
    shards whose sizes differ by at most one."""
    return (np.arange(parts + 1, dtype=np.int64) * n) // parts


def shard_batch(mesh: Mesh, x):
    """Dim 0 of ``x`` (a tensor or an array) in one contiguous shard per
    mesh device, each moved to its device: (shards, offsets [size + 1])."""
    t = torch.as_tensor(x)
    off = split_offsets(t.shape[0], mesh.size)
    return [t[lo:hi].to(d) for d, lo, hi in zip(mesh.flat, off[:-1], off[1:])], off


def replicate(mesh: Mesh, build: Callable, host) -> List:
    """``build(host, device)`` for every mesh device, in ``mesh.flat``
    order; ``build`` is one of ``engine/state.py``'s cached builders
    (``device_fm``, ``device_contigs``, ``device_ref``, ...), so a card's
    copy is made once however often the mesh names it."""
    return [build(host, d) for d in mesh.flat]


def shards(mesh: Mesh, n: int) -> List[Tuple[torch.device, int, int]]:
    """The non-empty shards of ``n`` items over the mesh:
    [(device, lo, hi)] in input order."""
    off = split_offsets(n, mesh.size)
    return [(d, int(lo), int(hi)) for d, lo, hi in
            zip(mesh.flat, off[:-1], off[1:]) if hi > lo]


def _in_thread(fn, dev, part):
    cudabuild._local.t = None  # a fresh tally for this shard
    out = fn(dev, part)
    return out, cudabuild.tally()


def run_shards(fn: Callable, work: Sequence[Tuple[torch.device, object]]) -> List:
    """``fn(device, part)`` for each (device, part) of ``work``: one thread
    per shard when there are several, so every shard's kernels are queued
    without waiting on another shard's; the results in ``work``'s order.
    The shards' launch tallies join the caller's (``cudabuild.tally``); the
    first shard that raised re-raises here."""
    if len(work) == 1:
        return [fn(*work[0])]
    with ThreadPoolExecutor(max_workers=len(work)) as pool:
        futs = [pool.submit(_in_thread, fn, d, p) for d, p in work]
        done = [f.result() for f in futs]
    for _, t in done:
        cudabuild.tally().update(t)
    return [out for out, _ in done]
