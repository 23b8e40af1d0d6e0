"""BwaMemAligner for the port: the JAX package's aligner surface (options,
PE-stats modes, Java-style accessors, records) with the extension waves,
and optionally the seeding and the sampled-SA walks, on an explicit torch
device.

Every batch goes through the port's ``align_regs_batch``; the reference's
native-tail shortcut (``_align_seqs_fast``), which would align the whole
batch in host C++, is never taken.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, TypeVar

import torch

from bwamem_tpu.api.aligner import BwaMemAligner as _HostAligner
from bwamem_tpu.api.aligner import _aln_to_record
from bwamem_tpu.api.alignment import BwaMemAlignment
from bwamem_tpu.api.exceptions import InvalidInputException
from bwamem_tpu.api.index import BwaMemIndex
from bwamem_tpu.api.options import MEM_F_PE, MEM_F_PRIMARY5, MemOptions
from bwamem_tpu.engine import pair as pair_mod
from bwamem_tpu.engine.finalize import mark_primary_se, reorder_primary5
from bwamem_tpu.engine.pipeline import reg2sam_records
from bwamem_tpu.utils.encoding import seq_to_codes_batch

from ..engine.exec_ctx import HOST_FALLBACK_JOBS, ExecConfig
from ..engine.pipeline import align_regs_batch

T = TypeVar("T")


class BwaMemAligner(_HostAligner):
    def __init__(self, index: BwaMemIndex, options: Optional[MemOptions] = None,
                 *, device, min_device_jobs: int = HOST_FALLBACK_JOBS,
                 device_stages=()):
        """device: where the extension waves run ("cuda", "cuda:1", "cpu").
        A CUDA device with no card present raises; there is no fallback.
        min_device_jobs: waves with fewer jobs run on the host C++.
        device_stages: further stages to run on ``device``, by the JAX
        package's names; the port has "seed" (the three seeding rounds of
        a batch in the seeding kernels) and "sa_lookup" (every sampled-SA
        walk of a batch in one kernel call), not yet "chain"."""
        stages = set(device_stages)
        unknown = stages - {"seed", "chain", "sa_lookup"}
        if unknown:
            raise ValueError(f"unknown device stages: {sorted(unknown)}")
        missing = stages - {"seed", "sa_lookup"}
        if missing:
            raise ValueError(f"device stages {sorted(missing)} are not in the "
                             "port yet; it has 'seed' and 'sa_lookup'")
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not "
                               "available")
        super().__init__(index, options)
        self._exec_cfg = ExecConfig(device=dev, min_device_jobs=min_device_jobs,
                                    device_sa_lookup="sa_lookup" in stages,
                                    device_seed="seed" in stages)

    def align_seqs(self, sequences: Iterable[T],
                   func: Callable[[T], bytes] = lambda x: x,
                   ) -> List[List[BwaMemAlignment]]:
        """Align a batch; one result list per input sequence."""
        raw = self.align_seqs_raw([func(s) for s in sequences])
        return [[_aln_to_record(p, m) for p, m in per_read] for per_read in raw]

    def align_seqs_raw(self, sequences: List[bytes]):
        """Per read a list of (Aln, mate Aln | None) engine records."""
        if not self._open:
            raise RuntimeError("The aligner has been closed.")
        opt = self.options
        self._index.ref_index()
        try:
            eng = self._index._require()
            reads = seq_to_codes_batch(sequences)
            if opt.flag & MEM_F_PE:
                return self._align_pe(eng, opt, reads)
            return self._align_se(eng, opt, reads)
        finally:
            self._index.de_ref_index()

    def _align_se(self, eng, opt, reads):
        out = []
        regs_all = align_regs_batch(opt, eng, reads, self._exec_cfg)
        for i, (read, regs) in enumerate(zip(reads, regs_all)):
            mark_primary_se(opt, regs, i)
            if opt.flag & MEM_F_PRIMARY5:
                reorder_primary5(opt.T, regs)
            out.append([(a, None) for a in reg2sam_records(opt, eng, read, regs)])
        return out

    def _align_pe(self, eng, opt, reads):
        if len(reads) % 2:
            raise InvalidInputException(
                "paired alignment requires an even number of sequences"
            )
        regs = align_regs_batch(opt, eng, reads, self._exec_cfg)
        pes = self._resolve_pes(opt, eng, regs)
        out = []
        for i in range(len(reads) // 2):
            alns0, alns1 = pair_mod.sam_pe(
                opt, eng, pes, i, (reads[2 * i], reads[2 * i + 1]),
                [regs[2 * i], regs[2 * i + 1]],
            )
            m0 = alns0[0] if alns0 else None
            m1 = alns1[0] if alns1 else None
            out.append([(a, m1) for a in alns0])
            out.append([(a, m0) for a in alns1])
        return out
