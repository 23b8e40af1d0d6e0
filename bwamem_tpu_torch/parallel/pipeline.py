"""End-to-end alignment over a device mesh.

The counterpart of bwamem_tpu/parallel/pipeline.py.  The batch's device
work runs over a ``parallel.mesh.Mesh`` (``engine.exec_ctx.mesh_exec``):
always the extension waves, split by jobs, and, by ``device_stages``, the
seeding, SA walks and chaining, split by reads, one contiguous sub-batch a
mesh device, each in its own thread.  The region rows of the shards merge
in read order and go to the one C++ tail (``bwamem_tail_batch``), as on
every route of the aligner; on the CPU without the tail library the Python
tail (``api.aligner.python_tail``) serves instead.  The records equal the
single-device route's (tests/test_torch_parallel.py, ``dryrun``).

``shard_reads_hosts`` is the multi-host layer's split: a contiguous shard
of the batch a process, mates kept on one process.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..engine import native_pipeline
from ..engine.exec_ctx import mesh_exec
from ..engine.finalize import Aln
from ..engine.pipeline import Engine, align_regs_batch, align_regs_raw


def align_seqs_mesh(opt, eng: Engine, reads: List[np.ndarray], mesh,
                    is_pe: bool = False, pes: Optional[List] = None,
                    id_base: int = 0,
                    device_stages: Sequence[str] = ()) -> List[List[Aln]]:
    """Align a batch (codes 0-4) with the device stages split over
    ``mesh``: per read its records.  ``pes`` (a list of four
    ``pair.PeStat``) fixes the PE statistics, None infers them from the
    batch; read (SE) or pair (PE) ``i`` has the ordinal ``id_base + i``."""
    if is_pe and len(reads) % 2:
        raise ValueError("paired mesh alignment needs an even batch")
    cfg = mesh_exec(mesh, device_stages)
    if native_pipeline.available():
        rows, n_reg = align_regs_raw(opt, eng, reads, cfg)
        arrays = native_pipeline.tail_batch_arrays(
            opt, eng.idx, reads, rows, n_reg, is_pe=is_pe, pes=pes,
            id_base=id_base)
        return native_pipeline.records_from_arrays(len(reads), *arrays)
    from ..api.aligner import python_tail
    from ..engine import pair as pair_mod

    regs = align_regs_batch(opt, eng, reads, cfg)
    if not is_pe:
        return [[a for a, _ in r] for r in
                python_tail(opt, eng, reads, regs, id_base=id_base)]
    if pes is None:
        pes = pair_mod.pestat(opt, eng.idx.bns.l_pac, regs)
    out = []
    for i in range(len(reads) // 2):
        out.extend(pair_mod.sam_pe(
            opt, eng, pes, id_base + i, (reads[2 * i], reads[2 * i + 1]),
            [regs[2 * i], regs[2 * i + 1]]))
    return out


def shard_reads_hosts(reads: List, process_id: int,
                      num_processes: int) -> Tuple[int, List]:
    """Multi-host layer: this process's contiguous shard of the batch
    (an even count a process, so mates stay together) and its offset."""
    n = len(reads)
    per = (n + num_processes - 1) // num_processes
    per += per & 1  # keep mates on the same host
    lo = min(process_id * per, n)
    return lo, reads[lo: min(lo + per, n)]
