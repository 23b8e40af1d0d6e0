"""Several processes: one host's or one card's share of a batch each.

The counterpart of bwamem_tpu/parallel/distributed.py.  Processes join one
``torch.distributed`` group (``init_distributed``: the **gloo** backend,
whose collectives run on the host, so two processes may share one card,
which NCCL refuses); each opens the same index image, aligns its
contiguous shard of the batch (``shard_bounds``, ``align_shard``; for
paired reads ``parallel.pipeline.shard_reads_hosts`` keeps mates
together), and the records of every shard are gathered to every process
(``gather_shards``: ``all_gather_object`` of the record lists) and merged
in input order (``merge_shards``).  With ``coordinator=None`` it is one
process, as in the JAX package.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch.distributed as dist

from ..api.options import MEM_F_PE
from .pipeline import shard_reads_hosts


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Tuple[int, int]:
    """Joins the group at ``coordinator`` ("host:port", the first process
    listening) as ``process_id`` of ``num_processes``, with the gloo
    backend; None is a single process.  Returns (process_id,
    num_processes)."""
    if coordinator is None:
        return 0, 1
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_rank(), dist.get_world_size()


def shutdown() -> None:
    """Leaves the group, when one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_bounds(n_items: int, process_id: int,
                 num_processes: int) -> Tuple[int, int]:
    """Contiguous [lo, hi) shard of a batch for this process."""
    per = (n_items + num_processes - 1) // num_processes
    lo = min(process_id * per, n_items)
    return lo, min(lo + per, n_items)


def align_shard(aligner, reads: Sequence[bytes], process_id: int,
                num_processes: int) -> Tuple[int, List]:
    """Align this process's shard; returns (global_offset, records).  A
    paired aligner's shards keep mates together
    (``parallel.pipeline.shard_reads_hosts``), and each read or pair keeps
    its ordinal in the whole batch (the hash tie-breaks' input), so the
    merged shards are one process's records."""
    if aligner.options.flag & MEM_F_PE:
        lo, part = shard_reads_hosts(list(reads), process_id, num_processes)
        return lo, aligner.align_seqs(part, id_base=lo // 2)
    lo, hi = shard_bounds(len(reads), process_id, num_processes)
    return lo, aligner.align_seqs(list(reads[lo:hi]), id_base=lo)


def gather_shards(lo: int, records: List) -> List[Tuple[int, List]]:
    """Every process's (offset, records), gathered to every process over
    the gloo group (``all_gather_object``); this process's own alone when
    no group was joined."""
    if not dist.is_initialized():
        return [(lo, records)]
    out: List = [None] * dist.get_world_size()
    dist.all_gather_object(out, (lo, records))
    return out


def merge_shards(shards: Iterable[Tuple[int, List]], n_items: int) -> List:
    """Merge per-process results back into input order (every read's
    records at its original ordinal)."""
    out: List = [None] * n_items
    for lo, recs in shards:
        for i, r in enumerate(recs):
            out[lo + i] = r
    missing = sum(1 for r in out if r is None)
    if missing:
        raise RuntimeError(f"merge incomplete: {missing} reads unaccounted")
    return out
