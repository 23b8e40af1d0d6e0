"""Data-parallel steps over a device mesh.

The counterpart of bwamem_tpu/parallel/dataparallel.py: the extension step
with the batch split over every mesh device (``make_dp_extend_step``), the
occ4 rank query on FM tables sharded over the mesh's ``idx`` axis
(``make_sharded_occ_step``, one ``ops.fmindex.ShardedFMIndex`` a row of the
``data`` axis, the queries split over the rows), and the two together
(``full_parallel_step``).  Each shard runs in its own thread
(``parallel.mesh.run_shards``): on a card the kernels (the wave kernel, the
sharded occ4 kernel), on the CPU their plain versions.  The results are
gathered on the mesh's first device, in input order; every kernel's result
for an item depends on that item alone, so they equal one device's.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..ops import fmindex as fmops
from ..ops.extend import KEYS, ksw_extend
from .mesh import Mesh, run_shards, shards

_EXT_ARGS = ("qseq", "tseq", "qlen", "tlen", "h0", "w", "end_bonus")


def make_dp_extend_step(mesh: Mesh, o_del, e_del, o_ins, e_ins, zdrop, max_sc):
    """The extension step with the batch split over every mesh device:
    ``step(qseq, tseq, qlen, tlen, h0, w, end_bonus, mat)`` (the layout of
    ``ops.extend.ksw_extend``, tensors on any device) -> the result dict of
    [B] int32 tensors on the mesh's first device."""

    def step(qseq, tseq, qlen, tlen, h0, w, end_bonus, mat):
        args = dict(zip(_EXT_ARGS, (qseq, tseq, qlen, tlen, h0, w, end_bonus)))
        work = [(d, (lo, hi)) for d, lo, hi in shards(mesh, qseq.shape[0])]

        def shard(dev, part):
            lo, hi = part
            a = {k: v[lo:hi].to(dev) for k, v in args.items()}
            return ksw_extend(**a, mat=mat.to(dev), o_del=o_del, e_del=e_del,
                              o_ins=o_ins, e_ins=e_ins, zdrop=zdrop,
                              max_sc=max_sc)

        parts = run_shards(shard, work)
        home = mesh.flat[0]
        return {k: torch.cat([p[k].to(home) for p in parts]) for k in KEYS}

    return step


def shard_tables(mesh: Mesh, fm) -> List[fmops.ShardedFMIndex]:
    """``fm`` (an ``engine.fmindex.FMIndex``) sharded over the ``idx`` axis:
    one ``ShardedFMIndex`` a row of the ``data`` axis, its shards on that
    row's devices."""
    return [fmops.ShardedFMIndex.from_host(fm, row) for row in mesh.devices]


def make_sharded_occ_step(mesh: Mesh):
    """occ4 with the line tables sharded over ``idx``
    (fmindex_tpu.py ``make_occ4_sharded``): ``step(tables, k)`` with
    ``tables`` from ``shard_tables`` and rows ``k`` [N] -> [N, 4] int32 on
    the mesh's first device; the queries are split over the data rows."""

    def step(tables: List[fmops.ShardedFMIndex], k: torch.Tensor):
        off = (np.arange(len(tables) + 1) * k.shape[0]) // len(tables)
        work = [(t.device, (t, lo, hi))
                for t, lo, hi in zip(tables, off[:-1], off[1:]) if hi > lo]

        def shard(dev, part):
            t, lo, hi = part
            return fmops.occ4_sharded(t, k[lo:hi].to(dev))

        home = mesh.flat[0]
        parts = run_shards(shard, work)
        if not parts:
            return torch.zeros((0, 4), dtype=torch.int32, device=home)
        return torch.cat([p.to(home) for p in parts])

    return step


def full_parallel_step(mesh: Mesh, opt_mat: np.ndarray, opts):
    """One combined step on both axes: the data-parallel extension and the
    idx-sharded rank queries.  ``step(ext_args, occ_args)`` takes the
    extension's keyword arguments (``make_dp_extend_step``'s, ``mat``
    included) and ``occ_args`` = {"tables": ..., "k": ...}."""
    extend_step = make_dp_extend_step(mesh, opts.o_del, opts.e_del,
                                      opts.o_ins, opts.e_ins, opts.zdrop,
                                      int(np.max(opt_mat)))
    occ_step = make_sharded_occ_step(mesh)

    def step(ext_args: Dict, occ_args: Dict):
        return extend_step(**ext_args), occ_step(**occ_args)

    return step
