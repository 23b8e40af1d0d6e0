#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bwamem_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit if it fails:

1. the card: its name and power limit as nvidia-smi reports them; no card
   (torch.cuda.is_available() false) exits at once;
2. build: compiles csrc/extend.cu, csrc/fmindex.cu, csrc/op_probe.cu,
   csrc/seed.cu, csrc/chain.cu and csrc/chain2aln.cu with nvcc for sm_90a,
   one nvcc per source, and the host C++ libraries (SA-IS, seeding,
   chaining, ksw, the chain+extend core and the whole-batch pipeline with
   its tail) with g++, all at once, and prints the compiler's register and
   spill report;
3. kernel against plain: the SW extension kernel against the plain
   PyTorch version on the card and the host C++ ksw_extend2, field for
   field and exactly, on seeded batches (a 4096-job main-path wave, the JAX
   tests' ragged shapes, edge cases, zdrop=0, non-default scoring);
4. main path: the port's BwaMemAligner(device="cuda", device_pipeline=False)
   (the extension waves on the card; every card aligner of phases 4-13 and
   16's default and staged routes says device_pipeline=False, since a card
   aligner takes the fused path by default) aligns 6,000 pairs of
   150 bp reads (and 2,000 reads single-end) on bench.py's 4.6 Mbp "ecoli"
   synthetic genome; every record must equal the host oracle's (the port's
   own aligner with device="cpu" and no device stage: the whole-batch host
   route, seeds to records in the port's host C++; the CPU tests hold that
   route record-equal to bwamem_tpu's aligner, and here the SE batch's
   oracle records are held against the Python route's, the port's host
   regions through its Python tail), the kernel must have run, and at least
   half of the extension jobs must have gone to the card; then the PE batch
   runs once more under torch.profiler for the card's busy and idle share and
   each kernel's device time and launches summed over the batch;
5. timing: the kernel (also from a cold L2) and the plain version on the
   largest wave of phase 4, with CUDA events after a warm-up, the wave's
   heaviest job alone, the jobs on the kernel's scalar path and its warps
   resident a SM;
6. FM kernels against their references on the 4.6 Mbp index, exactly:
   occ4, bwt_extend and the SA walk against the plain versions on the card
   and the host FMIndex, on seeded rows with the sentinel rows and on
   bi-intervals from set_intv extended both ways;
7. the device SA stage: the batches of phase 4 again with
   device_stages=("sa_lookup",): records equal to the host aligner's, the
   SA kernel launched, no SA row walked on the host; the SA kernel and the
   plain version timed on the largest SA batch, with its longest walk alone
   (profiled device time), the latency of one dependent line fetch (the
   line-chase kernel) and the latency floor it sets beside bound_ms;
8. at chr20 scale: bench.py's 64 Mbp "chr20" genome (seed 1234, sa_intv 8;
   48 MB of lines and 128 MB of sampled SA, past the card's 50 MB L2):
   2,000 pairs with the seeding, the SA walks, the chaining and the
   extension on the card, record-equal to the host oracle, with the seed
   checks of phase 11 and the chain checks of phase 13;
   the chain kernels against their plain version and the host C++
   chain_batch on that batch's own seeds, exactly; the SA kernel, the
   plain version and the host C++ walk timed on that batch's rows, as in
   phase 7; then
   seeding-shaped
   work for occ4 and
   bwt_extend, which no aligner stage launches yet: an exact-match backward
   search of every read (occ4 of both interval ends per base) and a forward
   bi-interval extension from each read's first base (bwt_extend per
   base), each step against the host FMIndex, the kernels timed on a
   mid-read step's queries; and the backward-search kernel (one launch for
   the whole search of every read) against that stepwise search and its
   plain version, and timed;
9. the op probe (the port of benchmarks/mosaic_probe.py): every probe's
   kernel against its plain version on the card at K=64, exactly, then
   ``python -m bwamem_tpu_torch.benchmarks.op_probe``'s own run: the SASS
   check of each kernel's K loop and the probe table;
10. seeding kernels, exactly, on the 4.6 Mbp index: smem1a_kernel (with
   the JAX package's K = 24) and strategy1_kernel (one lane per read of
   phase 4's PE batch from its first base, and three lanes per read of a
   seeded sample), and collect_intv_kernel (with the aligner's K = 160) +
   sample_ks_kernel + the SA walk on the whole PE batch, against the plain
   versions on the card and, on the sample plus
   edge reads (an N run, all N, 20 bp, both ends of the genome), against
   the host oracle (engine/seed.py smem1a, seed_strategy1, collect_intv;
   engine/chain.py sample_ks; FMIndex.sa_lookup), and collect_intv's work
   table against the plain version's, column by column; each kernel timed
   with CUDA events after a warm-up (collect_intv also from a cold L2, by
   batch size and on the read with the most rank queries alone, with its
   warps resident a SM), sample_ks as profiled device time on the whole
   batch and on the read with the most SA rows alone, each plain version
   once;
11. the device seed stage: phase 4's batches with device_stages=("seed",
   "sa_lookup") (PE and SE), then the PE batch with ("seed",): records equal
   to the host aligner's, the seeding kernels launched, at least 95 % of
   the reads seeded on the card (the rest, flagged by the M budget, on the
   host and counted; no read of up to 160 bases may overflow K = 160), no
   SA row walked on the host when the walks are
   on the card; the seed and sa_lookup stage seconds beside phase 4's host
   C++ seed stage, and the reads that needed more than the JAX package's
   24 K slots;
12. chain kernels, exactly, on phase 4's PE batch's real seeds (seeded and
   walked on the card, as the aligner's chain stage gets them):
   chain_kernel + chain_emit_kernel against the plain version on the card,
   chain for chain against the host C++ chain_batch on every read and
   against the host oracle (engine/chain.py chain_flt(mem_chain), with w,
   kept and first) on a sample plus the reads with the most seeds; the
   kernels timed with CUDA events (the count pass also from a cold L2, by
   batch size and on the heaviest read alone, with its warps resident a
   SM; the emit pass alone, also from a cold L2, and on the heaviest read
   alone as profiled device time), the plain version once;
13. the device chain stage: phase 4's batches with device_stages=("seed",
   "sa_lookup", "chain") (PE and SE), then the PE batch with ("chain",):
   records equal to the host oracle's, both chain kernels launched, at least
   95 % of the reads chained on the card (the rest, flagged by the C budget
   or seeded on the host, chained on the host and counted), no SA row walked
   on the host; the chain stage seconds beside phase 4's host C++ chain
   stage, and the reads the JAX package's S and C buckets would have sent to
   the host;
14. chain-to-region kernels, exactly, on phase 4's PE batch's real chains (as
   the fused path's entry leaves them on the card): chain2aln_prep_kernel +
   chain2aln_kernel against the plain version on the card, field for field,
   on a sample of ~1,000 reads plus the reads with the most seeds and the
   most chains, against the host wave runner (host C++ ksw) on that sample
   and against the host oracle (engine/extend.py chain2aln) on part of it;
   the prep kernel's own outputs (each chain's window and seed order)
   against the plain version's (chain_windows) on the whole batch, on the
   chain with the most seeds alone and on the 100 heaviest reads; the band
   preamble of csrc/extend.cuh against ops.extend.band_width; the loop
   kernel timed with CUDA events on the whole batch (also from a cold L2,
   by batch size, on the heaviest read alone and on the 100 heaviest reads
   alone, with its warps resident a SM), the prep kernel as profiled device
   time on the whole batch and on the chain with the most seeds alone, the
   plain versions once;
15. the fused device path: phase 4's batches (PE and SE) and phase 8's chr20
   batch with device_pipeline=True: records equal to the host oracle's, all
   the path's kernels launched, at least 95 % of the reads on the fused path
   (the rest, seeded on the host, flagged by the C budget or long enough for
   mem_flt_chained_seeds to act, on the staged path and counted by cause), no
   extension wave when no read left the path; the device_pipeline and
   native_tail seconds beside phase 13's stages; the PE batch once more under
   torch.profiler, in a fresh process, for the card's idle share and each
   kernel's device time and launches summed over the batch;
16. the C++ tail: phase 4's batches (PE and SE) and phase 8's chr20 pairs
   through four routes, the host whole-batch route (device="cpu"), the
   default route (extension waves on the card), the staged route (all three
   stages on the card) and the fused route: every record equal to the host
   whole-batch route's and to the Python route's (the same route's regions,
   align_regs_batch, through the Python tail python_tail); on each card
   route the tail ran in the timed native_tail stage and pair.sam_pe was
   never called; per route reads/s, the TIMERS stages, native_tail beside
   the Python tail's seconds on the same regions and the untimed rest, and
   for the fused ecoli PE batch the card's busy and idle share from phase
   15's profiled rerun of it; the card's name and power limit on each of
   those lines;
17. the command line on the card: bench.py's 4.6 Mbp "ecoli" genome as a
   FASTA and 40,000 simulated pairs of 150 bp reads (insert 350 +- 35) as
   FASTQ; ``python -m bwamem_tpu_torch index --sa-intv 8 ref.fa`` timed,
   then ``mem`` in fresh processes: with no device flag (the card, the fused
   path; two batches at the default -K, the first of 66,668 reads) under
   BWAMEM_TPU_METRICS and BWAMEM_TPU_TRACE, its SAM equal byte for byte to
   ``--device cpu``'s (the host route), its metrics dump counting 2
   batches, 80,000 reads and 2 fused batches, its own traces holding the
   seven fused-route kernels; the staged (``--no-device-pipeline
   --device-stages seed,sa_lookup,chain``) and waves
   (``--no-device-pipeline``, at least half the extension jobs on the card)
   routes equal to the host route's SAM too; with ``--insert-mean 350
   --insert-std 35``, ``-K 1000000``, ``-p`` on an interleaved file and
   ``--shard 0/2`` + ``1/2`` merged by read ordinal giving the unsharded
   run's lines; SE on the card equal to SE on the host; each timed run's
   reads/s and where its seconds went (the aligner's stages, the command's
   own, the rest) from its metrics dump; and, in this process,
   ``align_seqs_packed`` of the default ``BwaMemAligner(index)`` (no device
   given: the card, the fused path) on phase 4's PE batch equal to the host
   route's bytes, with no ``pair.sam_pe`` call;
18. several devices (the machine has one card, so every mesh of more than
   one device is virtual, cuda:0 repeated, each entry its own shard,
   launches and thread): (a) phase 4's PE and SE batches through
   ``BwaMemAligner(index, mesh=...)`` on ``make_mesh()`` (the real cards)
   and on a virtual (2, 2) mesh, with the fused path and with all three
   device stages on the waves, every record equal to the host route's,
   each route's kernels launched, reads/s; (b) ``parallel.dryrun``
   ``dryrun_multichip`` on four virtual devices (PE records on a (2, 2)
   mesh and the stage stack on a (4, 1) mesh equal to the single-device
   route's, the sharded occ4 step equal to the host oracle, the seed+SA
   step on a 1.55 Gbp ``synthetic_fmindex`` (past 2^31 rows, sa_intv 512)
   equal to the host oracle and, on its tables sharded over 2 and over 4
   shards on cuda:0, bit-equal to the unsharded kernels), then the sharded
   kernels (occ4 on 2^20 rows, the SA walk of the chr20 batch's SA rows
   from a cold L2, collect_intv on the chr20 batch) timed beside the
   unsharded ones in the same run, bit-equal to them and exactly equal to
   their plain versions; (c) two processes joined by ``torch.distributed``
   (gloo, localhost), each aligning its half of phase 4's PE batch on
   cuda:0, their merged records equal to one process's; (d) the device SA
   build (D11) on the 4.6 and 64 Mbp genomes equal to the host SA-IS, and
   the 4.6 Mbp index built with ``BWAMEM_TPU_DEVICE_SA=1`` equal to the
   host-built image byte for byte; (e) ``mem --devices 1`` on phase 17's
   FASTQ equal to its ``--device cpu`` SAM byte for byte, and ``--devices
   2`` refused (exit 2);
19. bench.py's third configuration, "midlen": 3,000 pairs of 300 bp reads
   (insert 700, fixed PE statistics 700 +- 70, as
   bwamem_tpu_torch/benchmarks/bench.py draws and sets them) on phase 4's
   4.6 Mbp genome (no new index) through the fused, staged and default
   routes, every record equal to the host whole-batch route's; the fused
   share (at least 95 %; below it the share and the reads that left by
   cause are printed before the run fails), FUSED_STATS by cause,
   SEED_STATS' K and M flags and the K slots the reads needed,
   CHAIN_STATS, reads/s of one call a route, the largest wave's Q and T and
   the wave kernel's scalar-path jobs; the fused batch and the default
   route's batch once more under torch.profiler in one fresh process (each
   path kernel's device time summed over the batch; the wave kernel's over
   the default route's waves); every kernel of the path against its plain
   version on the card on this batch (the plain chain-to-region version on
   64 of its reads), with the K slots the reads needed and the
   chain-to-region kernel's band cells and DP rows; one ``{"midlen": ...}``
   JSON line;
20. GRCh38-sized coordinates: (a) a ``synthetic_fmindex`` of 6.2e9 rows
   (GRCh38's 2 l_pac), sa_intv 32, on the card (its bytes printed): the
   seed+SA step on 32 random reads equal to the host oracle, with an
   interval bound and an SA position past 2^32 asserted; the SA walk of
   those rows, occ4 and bwt_extend on seeding-shaped work (each step
   against the host FMIndex) timed warm and cold (CUDA events queued
   behind a busy-wait of the card) beside their bounds;
   (b) ``utils.big_ref``: a random one-contig pac of 3.1 Gbp on the card
   (775 MB), 256 reads of 150 and 300 bases drawn from it with
   substitutions and an indel (forward ones past 2^31, reverse ones past
   2^32) seeded at their known positions: chain_kernel, chain_emit_kernel
   and the chain-to-region kernels against their plain versions on the
   card (the chain-to-region one on 64 reads) and the host oracle (16
   reads); one ``{"grch38_domain": ...}`` JSON line.  Then the main-path
   kernel times of this run, in one line, to set beside PERF.md section 6.

The launch counts in the ``kernels`` line come from the runs that drive
each kernel: phase 4's PE batch (ksw_extend), phase 7's PE batch
(sa_lookup), phase 8's seeding-shaped work (occ4, bwt_extend), phase 9's
probe run (op_probe), phase 11's PE batch with the seed and SA stages
(collect_intv, sample_ks), phase 13's PE batch with all three stages (chain,
chain_emit), phase 15's PE batch (chain2aln_prep, chain2aln) and phase 8's
one-launch search (backward_search, which no aligner stage calls),
phase 18's dry run (occ4_sharded, sa_lookup_sharded, collect_intv_sharded,
whose ``replaces`` is fmindex_tpu.py's sharded fetch) and phase 18's
index build with ``BWAMEM_TPU_DEVICE_SA=1`` (suffix_array, route "torch":
its ``launches`` are the build's sort rounds, ``plain_ms`` the host SA-IS,
``library_ms`` one ``torch.sort`` of as many int64 keys); each
count is set to 0 just before and read just after.  Every entry also carries ``bound_ms``, the least time the card could
take (this run's bytes at 3.35 TB/s or its integer operations at the int32
rate, whichever is larger, named in ``bound_by``), ``library_ms``, null
for every CUDA kernel: no single PyTorch call computes any of their
functions, and
``batch_ms`` and ``batch_launches``: the kernel's device time summed over
the profiled PE batches of phases 4 (the default route: the extension
waves) and 15 (the fused route: every other kernel of the aligner), and
its launches there (0 for a kernel neither route launches).  The
redesigned kernels (collect_intv, chain2aln, chain, chain_emit,
ksw_extend, sa_lookup, chain2aln_prep, sample_ks) also carry their slowest
unit alone in this run: ``slowest_read_ms``, ``slowest_job_ms`` for
ksw_extend, ``slowest_chain_ms`` for chain2aln_prep and
``slowest_row_ms`` (the longest walk, from a cold L2) for sa_lookup, whose
entry also gives ``latency_floor_ms``, that walk's steps times the measured
latency of one dependent line fetch from a cold L2.  Each of these times
(``ms``, ``slowest_*_ms``, ``latency_floor_ms``) has beside it, under the
same key with ``_by`` added, the method that took it: "events" (CUDA
events around the calls; for a launch of a few µs they time the host's
call),
"profiler" (the kernel's device time under torch.profiler) or "queued
events" (CUDA events around calls queued behind a busy-wait of the card,
taken where the profiler's traces held too few of the launches: the
card's dispatch and run, a few µs above the profiler's time); each
"profiled device time" of the phases above is taken so.  smem1a and
strategy1 run on the main path as __device__ functions
inside collect_intv_kernel; their own per-lane kernels (smem1a_kernel,
strategy1_kernel) exist to hold each function against its plain version
and time it (phase 10), and the main path launches them no time.  Their
entries give as ``launches`` the calls of the device function in phase
11's PE run, as collect_intv_kernel counts them on the card
(``SEED_STATS``), say so in ``launches_are``, and give the per-lane
kernel's own launch count in that run (0) as ``own_kernel_launches``.
The last three lines are that JSON object, the card's name and power
limit, and {"ok": true, "device": {...}}.  Nothing of JAX is imported.
"""
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
N_PAIRS = 6000
N_SE = 2000
SEED = 1234
ECOLI_LEN = 4_600_000
CHR20_LEN = 64_000_000
CHR20_PAIRS = 2000
SEED_SAMPLE = 256
SOURCES = ("extend", "fmindex", "op_probe", "seed", "chain", "chain2aln")
ALL_STAGES = ("seed", "sa_lookup", "chain")
# the card's published peaks (H100 SXM): device memory rate, and the int32
# rate of its 64 integer lanes per SM (half the float32 lanes, whose 67
# TFLOP/s count a fused multiply-add as two)
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 67e12 / 4


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


def _bound(nbytes: float, ops: float) -> dict:
    """The least ms the card could take: ``nbytes`` (each input read once,
    each output written once, as this run's data needs them) at the memory
    rate, or ``ops`` integer operations at the int32 rate, whichever is
    larger.  No kernel here has one PyTorch call that computes its function,
    so ``library_ms`` is null."""
    t_b, t_o = nbytes / HBM_BYTES_S * 1e3, ops / INT32_OPS_S * 1e3
    return dict(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations",
                library_ms=None)


def _line_bound(dfm, n_io_bytes: float, line_reads: float, extra_ops: float = 0):
    """``_bound`` of an FM-index kernel: its own inputs and outputs, the
    lines it reads (at most the whole table once) and ~14 integer
    operations per 16-char word of each line read."""
    line_b = dfm.lines.shape[1] * 4
    table_b = dfm.lines.numel() * 4
    return _bound(n_io_bytes + min(line_reads * line_b, table_b),
                  line_reads * (dfm.lines.shape[1] - 4) * 14 + extra_ops)


def _host_aligner(index):
    """The record oracle: the port's aligner on the CPU with no device
    stage, which takes the whole-batch host route (seeds to records in one
    host C++ call; held record-equal to bwamem_tpu's aligner by the CPU
    tests)."""
    from bwamem_tpu_torch import BwaMemAligner

    return BwaMemAligner(index, device="cpu", min_device_jobs=1 << 30)


def _python_route(aligner, seqs):
    """The Python route of ``aligner``'s configuration on ``seqs``: the
    regions of ``align_regs_batch`` through ``python_tail``, as records;
    and the Python tail's seconds."""
    import torch

    from bwamem_tpu_torch.api.aligner import _aln_to_record, python_tail
    from bwamem_tpu_torch.engine.pipeline import align_regs_batch
    from bwamem_tpu_torch.utils.encoding import seq_to_codes_batch

    eng = aligner.index._require()
    reads = seq_to_codes_batch(seqs)
    regs = align_regs_batch(aligner.options, eng, reads, aligner._exec_cfg)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = python_tail(aligner.options, eng, reads, regs, aligner._pe_stats)
    t_py = time.perf_counter() - t0
    return [[_aln_to_record(p, m) for p, m in r] for r in raw], t_py


def _equal(got, ref) -> int:
    """Reads whose records are all equal, field for field."""
    return sum([vars(x) for x in g] == [vars(x) for x in r]
               for g, r in zip(got, ref))


def _wave_tensors(wave, device):
    """A recorded wave (jobs, h0s, ws, bonuses) as the kernel's tensors."""
    import numpy as np
    import torch

    jobs, h0s, ws, bonuses = wave
    B = len(jobs)
    Q = max(len(q) for q, _ in jobs)
    T = max(max(len(t) for _, t in jobs), 1)
    qa = np.zeros((B, Q), np.int32)
    ta = np.zeros((B, T), np.int32)
    for b, (q, t) in enumerate(jobs):
        qa[b, : len(q)] = q
        ta[b, : len(t)] = t
    lens = [[len(q) for q, _ in jobs], [len(t) for _, t in jobs], h0s, ws,
            bonuses]
    per_job = [torch.tensor(v, dtype=torch.int32, device=device) for v in lens]
    return [torch.from_numpy(qa).to(device), torch.from_numpy(ta).to(device),
            *per_job]


def _max_err(a: dict, b: dict) -> int:
    return max(int((a[k].long() - b[k].long()).abs().max()) if a[k].numel()
               else 0 for k in a)


def _diff(a, b) -> int:
    """Largest |a - b| of two integer arrays or tensors (0 when empty)."""
    import numpy as np

    a, b = (np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.int64)
            for x in (a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    return int(np.abs(a - b).max()) if a.size else 0


def phase_build():
    """Phase 2: one nvcc per source and one g++ per host C++ library, all
    started together."""
    from bwamem_tpu_torch.engine import (native_chain, native_core, native_fm,
                                         native_ksw, native_pipeline)
    from bwamem_tpu_torch.index import native_sais
    from bwamem_tpu_torch.utils import cudabuild

    hosts = (native_sais, native_fm, native_chain, native_ksw, native_core,
             native_pipeline)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES) + len(hosts)) as ex:
        built = [ex.submit(m._ensure_built) for m in hosts]
        libs = list(ex.map(cudabuild.build, SOURCES))
        if not all(f.result() for f in built):
            raise AssertionError("a host C++ library did not build")
    print(f"[2] nvcc built {len(libs)} libraries and g++ {len(hosts)} host "
          f"libraries in {time.perf_counter() - t0:.2f} s")
    for name, lib in zip(SOURCES, libs):
        info = cudabuild.BUILD_INFO[name]
        print(f"  {os.path.relpath(lib, ROOT)} ({info['seconds']:.2f} s)")
        for line in info["log"].splitlines():
            print(f"    {line}")


def phase_kernel_vs_plain(dev, kernel_fn):
    """Phase 3: kernel = plain (on the card) = host C++ ksw_extend2."""
    import torch

    from bwamem_tpu_torch.engine import native_ksw
    from bwamem_tpu_torch.ops import extend as ext
    from bwamem_tpu_torch.utils.extend_cases import ARRAYS, CASES, jobs, make_case

    if not native_ksw.available():
        raise RuntimeError("host C++ ksw (engine/native/ksw.cpp) did not build")
    worst = 0
    for name in CASES:
        case = make_case(name)
        args = [torch.from_numpy(case[k]).to(dev) for k in ARRAYS]
        got = kernel_fn(*args, **case["statics"])
        plain = ext.ksw_extend_torch(*args, **case["statics"])
        st = case["statics"]
        js, h0s, ws, bons = jobs(case)
        host = native_ksw.extend_batch(
            js, case["mat"].reshape(-1).tolist(), st["o_del"], st["e_del"],
            st["o_ins"], st["e_ins"], st["zdrop"], h0s, ws, bons,
        )
        host_t = {k: torch.tensor([r[k] for r in host], dtype=torch.int32,
                                  device=dev) for k in ext.KEYS}
        err = max(_max_err(got, plain), _max_err(got, host_t))
        B, Q = case["qseq"].shape
        print(f"  {name:7s} B={B:5d} Q={Q:4d} T={case['tseq'].shape[1]:4d} "
              f"max|kernel-plain|,|kernel-host| = {err}")
        if err:
            raise AssertionError(f"kernel disagrees with its references on {name}")
        worst = max(worst, err)
    return worst


def _synthetic_index(length: int):
    """bench.py's synthetic genome of ``length`` bases (seed 1234) and its
    index image (sa_intv 8), built once into build/smoke/; returns the
    codes, the image path and the build seconds (0 when loaded)."""
    import numpy as np

    from bwamem_tpu_torch.index import image
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig
    from bwamem_tpu_torch.utils.synth import synthetic_genome

    codes = synthetic_genome(length, np.random.default_rng(SEED))
    img = os.path.join(ROOT, "build", "smoke", f"synth{length}_{SEED}_sa8.img")
    seconds = 0.0
    if not os.path.exists(img):
        os.makedirs(os.path.dirname(img), exist_ok=True)
        t0 = time.perf_counter()
        idx = build_index(Fasta([FastaContig("chr", "", codes)]), sa_intv=8)
        image.write_image(img + ".tmp", idx)
        os.replace(img + ".tmp", img)
        seconds = time.perf_counter() - t0
    return codes, img, seconds


# each entry of the kernels line: the __global__ function it times (the op
# probe's nine kernels run on no aligner route)
KERNEL_FN = {
    "ksw_extend": "ksw_extend_kernel", "occ4": "occ4_kernel",
    "bwt_extend": "extend_kernel", "sa_lookup": "sa_lookup_kernel",
    "backward_search": "backward_search_kernel",
    "smem1a": "smem1a_kernel", "strategy1": "strategy1_kernel",
    "collect_intv": "collect_intv_kernel", "sample_ks": "sample_ks_kernel",
    "chain": "chain_kernel", "chain_emit": "chain_emit_kernel",
    "chain2aln_prep": "chain2aln_prep_kernel", "chain2aln": "chain2aln_kernel",
}


def _names(event_name: str, fn: str) -> bool:
    """Whether a profiler event names the __global__ function ``fn``
    (demangled, or mangled with its length prefix)."""
    import re

    return (f"{len(fn)}{fn}" in event_name or re.search(
        rf"(?<![A-Za-z0-9_]){fn}(?![A-Za-z0-9_])", event_name) is not None)


def _kernel_of(event_name: str):
    """The entry of the kernels line whose __global__ function a profiler
    event names, or None."""
    for entry, fn in KERNEL_FN.items():
        if _names(event_name, fn):
            return entry
    return None


def _device_busy(aligner, reads, dev):
    """Seconds the card was busy (union of its kernels and copies in a
    torch.profiler trace) while ``aligner`` aligned ``reads``, the wall
    seconds of that call, and per entry of the kernels line its kernel's
    device ms summed over the trace and its launches there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        aligner.align_seqs(reads)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    if not spans:
        raise AssertionError("the profiler saw no work on the card")
    busy_us, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy_us += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    per = {}
    for e in dev_events:
        entry = _kernel_of(e.name)
        ms, n = per.get(entry or e.name, (0.0, 0))
        per[entry or e.name] = (
            ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    return (busy_us + hi - lo) / 1e6, wall, per


def _timed(aligner, reads, dev):
    import torch

    t0 = time.perf_counter()
    out = aligner.align_seqs(reads)
    torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def _pe_setup(aligner):
    from bwamem_tpu_torch import BwaMemPairEndStats

    aligner.align_pairs()
    aligner.set_proper_pair_end_stats(BwaMemPairEndStats.of(350, 35))


def _top_level(stages: dict) -> dict:
    """The top-level stages of a ``TIMERS.snapshot()``: a nested path
    subdivides its parent, and ``gc`` lies inside the others."""
    return {k: v for k, v in stages.items() if "." not in k and k != "gc"}


def _port_run(tag, port, batch, ref, t_host, dev, fused=False):
    """One timed batch through the port, counts set to 0 just before and
    read just after; the records held against ``ref``.  Returns the
    extension, SA-walk, seeding, chain and chain-to-region launch counts, the
    stats and the stage seconds.  ``fused``: the run takes the fused device
    path, where no extension wave is expected."""
    from bwamem_tpu_torch.utils.timers import TIMERS
    from bwamem_tpu_torch.engine.extend_batch import STATS
    from bwamem_tpu_torch.engine.pipeline import CHAIN_STATS, SA_STATS
    from bwamem_tpu_torch.engine.pipeline_device import FUSED_STATS
    from bwamem_tpu_torch.engine.seed_device import SEED_STATS
    from bwamem_tpu_torch.ops import chain as chainops
    from bwamem_tpu_torch.ops import extend as ext
    from bwamem_tpu_torch.ops import fmindex as fmops
    from bwamem_tpu_torch.ops import pipeline_fused as fusedops
    from bwamem_tpu_torch.ops import seed as seedops

    _reset_counts()
    got, t_port = _timed(port, batch, dev)
    launches, sa_launches = ext.LAUNCHES, fmops.LAUNCHES["sa_lookup"]
    seed_launches = dict(seedops.LAUNCHES)
    chain_launches = dict(chainops.LAUNCHES)
    fused_launches = dict(fusedops.LAUNCHES)
    stages = TIMERS.snapshot()
    ok = _equal(got, ref)
    aligned = sum(1 for r in got if r and not (r[0].sam_flag & 0x4))
    share = STATS.device_share()
    print(f"  {tag}: {len(batch)} reads, records equal {ok}/{len(batch)}, "
          f"aligned {aligned}; port {len(batch) / t_port:.1f} reads/s "
          f"({t_port:.2f} s), the oracle (the port's whole-batch host route) "
          f"{len(batch) / t_host:.1f} reads/s ({t_host:.2f} s)")
    print(f"  {tag}: extension kernel launches {launches}, device_extend_jobs "
          f"{STATS.device_extend_jobs} in {STATS.device_extend_waves} waves, "
          f"host_extend_jobs {STATS.host_extend_jobs} in "
          f"{STATS.host_extend_waves} waves, device share {share:.4f}; SA "
          f"kernel launches {sa_launches}, SA rows on the card "
          f"{SA_STATS.device_sa_rows}, on the host {SA_STATS.host_sa_rows}")
    if SEED_STATS.device_reads or SEED_STATS.host_reads:
        print(f"  {tag}: SEED_STATS: reads seeded on the card "
              f"{SEED_STATS.device_reads}, on the host {SEED_STATS.host_reads} "
              f"(flagged by K {SEED_STATS.k_overflows}, by M "
              f"{SEED_STATS.m_overflows}); {SEED_STATS.ref_k_overflows} reads "
              f"needed more than the JAX package's 24 K slots; seeding "
              f"launches " + ", ".join(
                  f"{k} {v}" for k, v in seed_launches.items())
              + f"; in collect_intv_kernel: smem1a {SEED_STATS.smem1a_calls}, "
              f"strategy1 {SEED_STATS.strategy1_calls}, bwt_extend "
              f"{SEED_STATS.extend_calls} calls")
    if CHAIN_STATS.device_reads or CHAIN_STATS.host_reads:
        print(f"  {tag}: CHAIN_STATS: reads chained on the card "
              f"{CHAIN_STATS.device_reads}, on the host {CHAIN_STATS.host_reads} "
              f"(flagged by C {CHAIN_STATS.c_overflows}); the JAX package's "
              f"budgets would send {CHAIN_STATS.ref_s_overflows} (S) + "
              f"{CHAIN_STATS.ref_c_overflows} (C) reads to the host; chain "
              "launches " + ", ".join(f"{k} {v}" for k, v in chain_launches.items()))
    fs = FUSED_STATS
    if fs.device_reads or fs.host_reads:
        print(f"  {tag}: FUSED_STATS: reads on the fused path {fs.device_reads}, "
              f"on the staged path {fs.host_reads} (seeded on the host "
              f"{fs.host_seeded}, flagged by C {fs.c_overflows}, fcs active "
              f"{fs.fcs_reads}, past the loop kernel's length {fs.long_reads}); "
              f"tasks extended {fs.tasks}, pruned {fs.pruned}, "
              f"extension jobs {fs.jobs}; the JAX package's budgets would flag "
              f"{fs.ref_s_overflows} (S) + {fs.ref_c_overflows} (C) + "
              f"{fs.ref_r_overflows} (R) + {fs.ref_t_overflows} (window) reads; "
              "chain-to-region launches " + ", ".join(
                  f"{k} {v}" for k, v in fused_launches.items())
              + "; seconds inside device_pipeline: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in fs.seconds.items()))
    rest = t_port - sum(_top_level(stages).values())
    waves = sum(v for k, v in stages.items()
                if k.rsplit(".", 1)[-1] == "extend_wave")
    print(f"  {tag}: port seconds by stage: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items())
        + f", untimed rest {rest:.3f}; extension waves {waves:.3f} (host "
        "and card; a card wave's include packing, copies and the kernel)")
    if ok != len(batch):
        raise AssertionError(f"{tag}: records differ from the host oracle's")
    if aligned < 0.95 * len(batch):
        raise AssertionError(f"{tag}: only {aligned} reads aligned")
    if not fused and (launches <= 0 or share < 0.5):
        raise AssertionError(f"{tag}: the extension did not run on the card")
    return dict(launches=launches, sa_launches=sa_launches,
                seed_launches=seed_launches, chain_launches=chain_launches,
                fused_launches=fused_launches, stages=stages, seconds=t_port,
                seed_stats=vars(SEED_STATS).copy(),
                chain_stats={k: v for k, v in vars(CHAIN_STATS).items()
                             if k != "largest_table"},
                fused_stats={k: v for k, v in vars(fs).items()
                             if k != "largest_batch"},
                waves=STATS.device_extend_waves + STATS.host_extend_waves)


def phase_main_path(dev, index, codes):
    """Phase 4: the port's aligner against the host aligner, PE and SE.
    Returns per mode the batch, the host records and seconds, the launch
    count and the largest wave."""
    import numpy as np

    from bwamem_tpu_torch.utils.synth import simulate_pairs
    from bwamem_tpu_torch import BwaMemAligner
    from bwamem_tpu_torch.engine.extend_batch import STATS

    rng = np.random.default_rng(SEED + 1)
    warm = simulate_pairs(codes, rng, 8)
    reads = simulate_pairs(codes, rng, N_PAIRS)
    runs = {}
    for mode, batch in (("pe", reads), ("se", reads[:N_SE])):
        host = _host_aligner(index)
        port = BwaMemAligner(index, device=dev, device_pipeline=False)
        if mode == "pe":
            for a in (host, port):
                _pe_setup(a)
        for a in (host, port):
            a.align_seqs(warm)
        ref, t_host = _timed(host, batch, dev)
        if mode == "se":
            py, _ = _python_route(host, batch)
            ok = _equal(ref, py)
            print(f"  se: the oracle's records against the Python route's "
                  f"(host regions, Python tail): equal {ok}/{len(batch)}")
            if ok != len(batch):
                raise AssertionError("the oracle differs from the Python route")
        res = _port_run(mode, port, batch, ref, t_host, dev)
        runs[mode] = dict(batch=batch, ref=ref, t_host=t_host, warm=warm,
                          launches=res["launches"], stages=res["stages"],
                          wave=STATS.largest_wave)
        if mode == "pe":
            busy, wall, per = _traced_batch("pe", port, batch, dev,
                                            {"ksw_extend": res["launches"]})
            runs["pe"]["batch_kernels"] = per
            print(f"  pe: again under torch.profiler: card busy {busy:.4f} s of "
                  f"{wall:.2f} s, idle share {1 - busy / wall:.4f}; kernels "
                  "summed over the batch: " + _per_kernel(per))
    return runs


def _traced_batch(tag, aligner, reads, dev, launches):
    """``_device_busy`` on a rerun of the batch, whose trace must show each
    kernel as often as the counted run launched it, or its summed time
    would miss launches.  Traces drop launches in bursts of a second or
    more: the rerun is traced again, up to six tries with pauses of 0.5, 1,
    2, 4 and 8 s between them, before the run fails."""
    for attempt in range(6):
        if attempt:
            time.sleep(0.25 * 2 ** attempt)
        busy, wall, per = _device_busy(aligner, reads, dev)
        seen = {k: per.get(k, (0.0, 0))[1] for k in launches}
        if seen == launches:
            return busy, wall, per
        other = sorted(((ms, n, k[:90]) for k, (ms, n) in per.items()
                        if k not in KERNEL_FN), reverse=True)[:6]
        print(f"  {tag}: a trace held launches {seen}, the run made "
              f"{launches}; traced again; its longest other device events "
              f"(ms, count, name): {other}")
    raise AssertionError(f"{tag}: the profiler saw launches {seen}, the run "
                         f"made {launches}, six times")


def _fresh_traced_batch(tag, route: dict, mode: str, launches: dict):
    """``_fresh_traced_batches`` of one route."""
    return _fresh_traced_batches(mode, [dict(tag=tag, route=route,
                                             launches=launches)])[0]


def _fresh_traced_batches(mode: str, runs: list):
    """``_traced_batch`` of phase 4's ecoli batch (``mode`` "pe" or "se"),
    or phase 19's 300-base pairs (``mode`` "midlen"), through each run's
    ``route`` (the aligner's keywords) in turn, in a fresh process: once a
    trace of a process has come back empty, that process's later traces
    of this batch have held every kernel but its first,
    collect_intv_kernel, six times running, and late in a run traces of
    the wave route have held one wave fewer than it launched, while a
    fresh process's hold them all.  The
    child builds nothing (kernels, host libraries and the image are in
    build/), makes the same reads from the same seeds, and must launch what
    each run's ``launches`` says in its own counted run before it traces a
    rerun.  Returns per run busy seconds, wall seconds and the per-kernel
    sums."""
    spec = json.dumps(dict(mode=mode, runs=runs))
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--traced-batch", spec], capture_output=True,
                         text=True, timeout=600)
    for line in res.stdout.splitlines()[:-1]:
        print(line)
    if res.returncode != 0:
        raise AssertionError(f"{runs[0]['tag']}: the traced rerun in a fresh "
                             f"process failed: {res.stderr[-2000:]}")
    return [(r["busy"], r["wall"], {k: tuple(v) for k, v in r["per"].items()})
            for r in json.loads(res.stdout.splitlines()[-1])]


def traced_batch_child(spec: str) -> int:
    """The child of ``_fresh_traced_batches``: one JSON line, last."""
    import numpy as np
    import torch

    from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex
    from bwamem_tpu_torch.utils.synth import simulate_pairs

    spec = json.loads(spec)
    dev = torch.device("cuda", 0)
    codes, img, _ = _synthetic_index(ECOLI_LEN)
    index = BwaMemIndex(img)
    if spec["mode"] == "midlen":  # phase_midlen's reads
        warm, reads = _midlen_reads(codes)
    else:
        rng = np.random.default_rng(SEED + 1)  # phase_main_path's reads
        warm = simulate_pairs(codes, rng, 8)
        reads = simulate_pairs(codes, rng, N_PAIRS)
    if spec["mode"] == "se":
        reads = reads[:N_SE]
    out = []
    for run in spec["runs"]:
        port = BwaMemAligner(index, device=dev,
                             **{"device_pipeline": False, **run["route"]})
        if spec["mode"] == "pe":
            _pe_setup(port)
        elif spec["mode"] == "midlen":
            _midlen_setup(port)
        port.align_seqs(warm)
        _reset_counts()
        port.align_seqs(reads)
        torch.cuda.synchronize(dev)
        counted = {k: _launched()[k] for k in run["launches"]}
        if counted != run["launches"]:
            raise AssertionError(f"the fresh process launched {counted}, the "
                                 f"run {run['launches']}")
        busy, wall, per = _traced_batch(run["tag"], port, reads, dev,
                                        run["launches"])
        out.append(dict(busy=busy, wall=wall, per={
            k: v for k, v in per.items() if k in KERNEL_FN}))
    index.close()
    print(json.dumps(out))
    return 0


def _per_kernel(per) -> str:
    return ", ".join(f"{k} {ms:.4f} ms in {n} launches"
                     for k, (ms, n) in sorted(per.items()) if k in KERNEL_FN)


def _event_ms(fn, reps, dev):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize(dev)
    return a.elapsed_time(b) / reps


def _cold_ms(fn, reps, dev):
    """Median ms of single launches of ``fn``, each after 256 MB were
    written on the card, so that it starts with nothing of its tables in
    the 50 MB L2 (as a new batch does)."""
    import torch

    flush = torch.empty(1 << 26, dtype=torch.int32, device=dev)
    fn()  # warm-up
    times = []
    for _ in range(reps):
        flush.fill_(len(times))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def _queued_ms(fn, reps, dev, cold=False):
    """Mean device ms of ``fn`` by a pair of CUDA events around each call,
    every call queued behind a busy-wait of the card (~30 ms) so that the
    host has made all of them before the card reaches the first: each pair
    times the card's dispatch and run of the call's kernels, not the
    host's call.  ``cold`` as for ``_device_ms``."""
    import torch

    flush = torch.empty(1 << 26, dtype=torch.int32, device=dev) if cold else None
    fn()  # warm-up
    torch.cuda.synchronize(dev)
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for r, (a, b) in enumerate(pairs):
        if cold:
            flush.fill_(r)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize(dev)
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


class ShortTrace(AssertionError):
    """The profiler's traces held too few of a kernel's launches."""


def _device_ms(fn, reps, dev, kernel, cold=False):
    """Mean device ms of the __global__ function ``kernel`` over ``reps``
    calls of ``fn`` under torch.profiler: the card's own time, where CUDA
    events around a small launch time the host's call.  ``cold``: 256 MB
    are written on the card before each call, so that it starts with
    nothing of its tables in the 50 MB L2.  A trace can miss launches, or
    hold no device event at all, for a second or more at a time: the mean
    is over the launches the traces hold, pooled over up to six traces of
    ``reps`` calls (pauses of 0.5, 1, 2, 4 and 8 s between them, every
    other one tracing the host too) until they hold at least half of
    ``reps``; when they do not, ``ShortTrace`` is raised.  A trace that
    holds more than ``reps`` launches fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(1 << 26, dtype=torch.int32, device=dev) if cold else None
    fn()  # warm-up
    torch.cuda.synchronize(dev)
    times = []
    for attempt in range(6):
        if attempt:
            time.sleep(0.25 * 2 ** attempt)
        acts = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * (attempt % 2)
        with profile(activities=acts, acc_events=True) as prof:
            # a few ms of the card busy first: traces of a few short
            # launches alone have come back empty where longer ones did not
            torch.cuda._sleep(10_000_000)
            for r in range(reps):
                if cold:
                    flush.fill_(r)
                fn()
            torch.cuda.synchronize(dev)
        seen = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        got = [(e.time_range.end - e.time_range.start) / 1e3
               for e in seen if _names(e.name, kernel)]
        if len(got) > reps:
            raise AssertionError(f"a trace of {reps} calls holds {len(got)} "
                                 f"{kernel} launches")
        times += got
        if len(times) >= reps // 2:
            return sum(times) / len(times)
    raise ShortTrace(f"six traces of {reps} calls held {len(times)} {kernel} "
                     f"launches, the last {len(seen)} device events")


def _card_ms(fn, reps, dev, kernel, cold=False):
    """(ms, by): ``_device_ms``'s time and "profiler", or, where its traces
    hold too few launches, ``_queued_ms``'s and "queued events", with a line
    that says so.  The kernels line carries ``by`` beside each such time."""
    try:
        return _device_ms(fn, reps, dev, kernel, cold), "profiler"
    except ShortTrace as e:
        ms = _queued_ms(fn, reps, dev, cold)
        print(f"  ({e}; timed instead by CUDA events queued behind a "
              f"busy-wait: {ms:.5f} ms)")
        return ms, "queued events"


def phase_timing(dev, wave):
    """Phase 5: kernel and plain version on the largest main-path wave."""
    import torch

    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.state import device_scoring
    from bwamem_tpu_torch.ops import extend as ext

    sc = device_scoring(MemOptions(), dev)
    q, t, qlen, tlen, h0, w, bonus = _wave_tensors(wave, dev)
    args = (q, t, qlen, tlen, h0, w, bonus, sc.mat, sc.o_del, sc.e_del,
            sc.o_ins, sc.e_ins, sc.zdrop, sc.max_sc)
    err = _max_err(ext.ksw_extend_cuda(*args), ext.ksw_extend_torch(*args))
    if err:
        raise AssertionError("kernel disagrees with the plain version")
    # the kernel alone on prepared operands, then the wrapper with its input
    # checks and conversions, then the plain version
    w_adj = ext.band_width(qlen, w, bonus, sc.max_sc, sc.o_del, sc.e_del,
                           sc.o_ins, sc.e_ins)
    scal = torch.stack([qlen, tlen, h0, w_adj], dim=1)
    q8, t8 = q.to(torch.uint8), t.to(torch.uint8)
    B, Q = q.shape
    plan = ext.plan_wave(scal, sc.mat)

    def launch(rows=slice(None), p=plan):
        return ext.ksw_extend_launch(q8[rows], t8[rows], scal[rows], sc.mat, Q,
                                     sc.o_del, sc.e_del, sc.o_ins, sc.e_ins,
                                     sc.zdrop, p)

    ms = _event_ms(launch, 20, dev)
    cold_ms = _cold_ms(launch, 5, dev)
    # the heaviest job (first in the kernel's order) alone
    top = int(plan.order[0])
    one = slice(top, top + 1)
    plan1 = ext.plan_wave(scal[one], sc.mat)
    top_ms = _event_ms(lambda: launch(one, plan1), 20, dev)
    wrapper_ms = _event_ms(lambda: ext.ksw_extend_cuda(*args), 20, dev)
    plain_ms = _event_ms(lambda: ext.ksw_extend_torch(*args), 3, dev)
    # the DP cells inside each job's band, ~10 integer operations a cell
    band = torch.minimum(qlen, 2 * w_adj + 1).long() * tlen.long()
    cells = int(band.sum())
    bound = _bound(q8.numel() + t8.numel() + 4 * (scal.numel() + sc.mat.numel())
                   + 24 * B, 10 * cells)
    print(f"  largest wave B={B} Q={Q} T={t.shape[1]}: kernel {ms:.4f} ms "
          f"({cold_ms:.4f} ms from a cold L2), ksw_extend_cuda (checks, "
          f"conversions, plan, kernel) {wrapper_ms:.4f} ms, plain PyTorch "
          f"{plain_ms:.4f} ms; {cells} cells in band, bound "
          f"{bound['bound_ms']:.5f} ms by {bound['bound_by']}")
    print(f"  the heaviest job alone (job {top}: qlen {int(qlen[top])}, tlen "
          f"{int(tlen[top])}, {int(band[top])} cells in band): {top_ms:.4f} ms; "
          f"jobs on the scalar path {plan.n_scalar}; the group DP takes "
          f"queries of up to {ext.kernel_max_qlen(dev)} bases here; warps "
          f"resident a SM at Q={plan.Qw}: {ext.warps_per_sm(plan.Qw)}")
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound=bound,
                slowest_ms=top_ms, slowest_by="events")


def phase_fm_kernels(dev, fm):
    """Phase 6: occ4, bwt_extend and sa_lookup = plain (card) = host."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.engine.state import device_fm
    from bwamem_tpu_torch.ops import fmindex as fmops

    dfm = device_fm(fm, dev)
    rng = np.random.default_rng(SEED + 2)
    edges = [0, fm.primary - 1, fm.primary, fm.primary + 1, fm.seq_len - 1,
             fm.seq_len]
    err = {}
    ks = np.concatenate([[-1], edges, rng.integers(-1, fm.seq_len + 1, 200_000)])
    kt = torch.from_numpy(ks).to(dev)
    got = fmops.occ4_cuda(dfm, kt)
    err["occ4"] = max(_diff(got, fmops.occ4_torch(dfm, kt)),
                      _diff(got, fm.occ4(ks)))
    x0, x1, s = fm.set_intv(rng.integers(0, 4, 50_000))
    err["bwt_extend"] = 0
    for is_back in (False, True, False, True):
        args = [torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                for a in (x0, x1, s)]
        got = fmops.extend_cuda(dfm, *args, is_back)
        plain = fmops.extend_torch(dfm, *args, is_back)
        host = fm.extend(x0, x1, s, is_back)
        err["bwt_extend"] = max([err["bwt_extend"]] + [
            max(_diff(g, p), _diff(g, h)) for g, p, h in zip(got, plain, host)])
        c = rng.integers(0, 4, len(x0))
        ar = np.arange(len(x0))
        keep = host[2][ar, c] > 0
        x0 = np.where(keep, host[0][ar, c], x0)
        x1 = np.where(keep, host[1][ar, c], x1)
        s = np.where(keep, host[2][ar, c], s)
    rows = np.concatenate([edges, rng.integers(0, fm.seq_len + 1, 200_000)])
    rt = torch.from_numpy(rows).to(dev)
    got = fmops.sa_lookup_cuda(dfm, rt)
    err["sa_lookup"] = max(_diff(got, fmops.sa_lookup_torch(dfm, rt)),
                           _diff(got, fm.sa_lookup(rows)))
    print(f"  4.6 Mbp index: {dfm.lines.shape[0]} lines x "
          f"{dfm.lines.shape[1] * 4} B, {dfm.sa.numel()} SA samples; "
          f"occ4 on {len(ks)} rows, bwt_extend on 4 x {len(x0)} bi-intervals, "
          f"sa_lookup on {len(rows)} rows; max|kernel-plain|,|kernel-host| "
          + ", ".join(f"{k} {v}" for k, v in err.items()))
    if any(err.values()):
        raise AssertionError("an FM kernel disagrees with its references")
    return err


def _walk_lengths(dfm, k):
    """Each row's walk length: the plain walk's count of LF steps."""
    from bwamem_tpu_torch.ops import fmindex as fmops

    import torch

    steps = torch.zeros_like(k)
    idx = torch.arange(k.numel(), device=k.device)
    while True:
        live = k % dfm.sa_intv != 0
        idx, k = idx[live], k[live]
        if idx.numel() == 0:
            return steps
        steps[idx] += 1
        k = fmops._lf(dfm, k)


def _chase_us(dfm, dev, cold: bool) -> tuple:
    """(µs, by): device µs of one dependent line fetch, the slope of the
    line-chase kernel's time (``_card_ms``, both by one method, named in
    ``by``) from 64 to 576 fetches, its table in the L2 after a first call
    or (``cold``) flushed out of it before each."""
    import torch

    from bwamem_tpu_torch.ops import fmindex as fmops

    out = torch.zeros(1, dtype=torch.int64, device=dev)
    start = 12345 % dfm.lines.shape[0]
    fns = {n: lambda n=n: fmops.line_chase_launch(dfm, start, n, out)
           for n in (64, 576)}
    t = {n: _card_ms(f, 5, dev, "line_chase_kernel", cold)
         for n, f in fns.items()}
    by = {b for _, b in t.values()}
    if len(by) > 1:  # both times by one method, or the slope mixes them
        by = {"queued events"}
        t = {n: (_queued_ms(f, 5, dev, cold), "") for n, f in fns.items()}
    return (t[576][0] - t[64][0]) * 1e3 / 512, by.pop()


def _time_sa(tag, dev, fm, rows):
    """The SA kernel alone (repeated launches, and single launches from a
    cold L2), its longest walk alone (profiled device time, warm and cold),
    the plain version and the host C++ walk on ``rows``; the latency of one
    dependent line fetch (warm and cold) and the latency floor it sets, the
    longest walk times that latency.  Returns a dict of the times."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.engine import native_fm
    from bwamem_tpu_torch.engine.state import device_fm
    from bwamem_tpu_torch.ops import fmindex as fmops

    dfm = device_fm(fm, dev)
    if torch.is_tensor(rows):
        rows = rows.cpu().numpy()
    k = torch.from_numpy(np.ascontiguousarray(rows, np.int64)).to(dev)
    out = torch.empty_like(k)
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    def launch():
        fmops.sa_lookup_launch(dfm, k, out, flags)

    ms = _event_ms(launch, 20, dev)
    cold_ms = _cold_ms(launch, 11, dev)
    if int(flags.item()):
        raise AssertionError(f"{tag}: SA kernel raised flags {int(flags.item())}")
    err = _diff(out, fmops.sa_lookup_torch(dfm, k))
    plain_ms = _event_ms(lambda: fmops.sa_lookup_torch(dfm, k), 2, dev)
    host_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        host = native_fm.sa_batch(fm, rows)
        host_s = min(host_s, time.perf_counter() - t0)
    err = max(err, _diff(out, host))
    steps = _walk_lengths(dfm, k)
    n = len(rows)
    mean, longest = float(steps.sum()) / max(n, 1), int(steps.max())
    top = int(torch.argmax(steps))
    k1, out1 = k[top: top + 1].clone(), torch.empty(1, dtype=torch.int64,
                                                     device=dev)
    def one():
        fmops.sa_lookup_launch(dfm, k1, out1, flags)

    row_ms, row_by = _card_ms(one, 10, dev, "sa_lookup_kernel")
    row_cold_ms, row_cold_by = _card_ms(one, 10, dev, "sa_lookup_kernel",
                                        cold=True)
    err = max(err, _diff(out1, out[top: top + 1]))
    chase = {c: _chase_us(dfm, dev, c) for c in (False, True)}
    lat = {c: us for c, (us, _) in chase.items()}
    floor = {c: longest * lat[c] / 1e3 for c in lat}
    bound = _line_bound(dfm, 16 * n + 8 * min(n, dfm.sa.numel()), mean * n,
                        10 * mean * n)
    print(f"  {tag}: {n} SA rows, {mean:.3f} LF steps per walk (longest "
          f"{longest}); kernel {ms:.4f} ms repeated ({n / ms * 1e3:.4g} "
          f"rows/s), {cold_ms:.4f} ms from a cold L2 ({n / cold_ms * 1e3:.4g} "
          f"rows/s), plain "
          f"PyTorch {plain_ms:.4f} ms ({n / plain_ms * 1e3:.4g} rows/s), host "
          f"C++ sa_batch {host_s * 1e3:.4f} ms ({n / host_s:.4g} rows/s); "
          f"max|kernel-plain|,|kernel-host| {err}")
    print(f"  {tag}: the longest walk alone ({row_by}) "
          f"{row_ms:.4f} ms, {row_cold_ms:.4f} ms from a cold L2 ({row_cold_by}) "
          f"({row_ms * 1e3 / max(longest, 1):.3f}, "
          f"{row_cold_ms * 1e3 / max(longest, 1):.3f} us a step); one dependent "
          f"line fetch {lat[False]:.4f} us ({lat[True]:.4f} us from a cold L2); "
          f"bound_ms {bound['bound_ms']:.5f} ({bound['bound_by']}), latency "
          f"floor (longest walk x one fetch) {floor[False]:.5f} ms "
          f"({floor[True]:.5f} ms cold, fetch by {chase[True][1]})")
    if err:
        raise AssertionError(f"{tag}: the SA kernel disagrees")
    return dict(cold_ms=cold_ms, plain_ms=plain_ms, bound=bound,
                slowest_ms=row_cold_ms, slowest_by=row_cold_by,
                floor_ms=floor[True], floor_by=chase[True][1])


def phase_device_sa(dev, index, fm, runs):
    """Phase 7: the batches of phase 4 with the SA walks on the card."""
    from bwamem_tpu_torch import BwaMemAligner
    from bwamem_tpu_torch.engine.pipeline import SA_STATS

    sa = {}
    for mode in ("pe", "se"):
        r = runs[mode]
        port = BwaMemAligner(index, device=dev, device_stages=("sa_lookup",),
                             device_pipeline=False)
        if mode == "pe":
            _pe_setup(port)
        port.align_seqs(r["warm"])
        sa_launches = _port_run(f"{mode}+sa", port, r["batch"], r["ref"],
                                r["t_host"], dev)["sa_launches"]
        if sa_launches <= 0 or SA_STATS.host_sa_rows:
            raise AssertionError(f"{mode}: SA walks did not all run on the card")
        sa[mode] = dict(launches=sa_launches, rows=SA_STATS.largest_rows)
    _time_sa("4.6 Mbp, largest PE SA batch", dev, fm, sa["pe"]["rows"])
    return sa


def _rank_drive(dev, fm, reads):
    """Seeding-shaped work through the occ4 and bwt_extend dispatchers on
    the card, each step against the host FMIndex; returns the launches,
    the largest difference and a mid-read step's inputs for timing."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.utils.encoding import seq_to_codes_batch
    from bwamem_tpu_torch.engine.state import device_fm
    from bwamem_tpu_torch.ops import fmindex as fmops

    dfm = device_fm(fm, dev)
    codes = np.stack(seq_to_codes_batch(reads)).astype(np.int64)
    n, L = codes.shape
    ar = np.arange(n)
    L2 = fm.L2
    for name in ("occ4", "bwt_extend", "backward_search"):
        fmops.LAUNCHES[name] = 0
    err, mid = 0, {}
    # exact-match backward search (bwa bwt_match_exact): occ4 of k-1 and l
    k = np.zeros(n, np.int64)
    l = np.full(n, fm.seq_len, np.int64)
    alive = np.ones(n, bool)
    n_matched = np.zeros(n, np.int64)
    steps = 0
    for i in range(L - 1, -1, -1):
        q = np.concatenate([k - 1, l])
        if steps == 20:
            mid["occ4"] = q
        got = fmops.occ4(dfm, torch.from_numpy(q).to(dev)).cpu().numpy()
        host = fm.occ4(q)
        err = max(err, _diff(got, host))
        c = codes[:, i]
        cc = np.clip(c, 0, 3)
        k2 = L2[cc] + host[:n][ar, cc] + 1
        l2 = L2[cc] + host[n:][ar, cc]
        alive &= (c < 4) & (k2 <= l2)
        k, l = np.where(alive, k2, k), np.where(alive, l2, l)
        n_matched += alive
        steps += 1
        if not alive.any():
            break
    matched = steps
    # the same search in one launch of the backward-search kernel
    qseq, qlen = fmops.right_align_reads(list(codes.astype(np.uint8)), dev)
    mid["backward_search"] = (qseq, qlen)
    e_bs = max(_diff(g, h) for g, h in zip(
        fmops.backward_search(dfm, qseq, qlen), (k, l, n_matched)))
    err = max(err, e_bs)
    # forward extension from each read's first base (bwa's ok[3 - c])
    x0, x1, s = fm.set_intv(np.clip(codes[:, 0], 0, 3))
    alive = codes[:, 0] < 4
    for i in range(1, L):
        if i == 21:
            mid["bwt_extend"] = (x0, x1, s)
        got = fmops.extend(dfm, *(torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                                  for a in (x0, x1, s)), False)
        host = fm.extend(x0, x1, s, False)
        err = max([err] + [_diff(g, h) for g, h in zip(got, host)])
        c = codes[:, i]
        j = 3 - np.clip(c, 0, 3)
        ns = host[2][ar, j]
        alive &= (c < 4) & (ns > 0)
        x0 = np.where(alive, host[0][ar, j], x0)
        x1 = np.where(alive, host[1][ar, j], x1)
        s = np.where(alive, ns, s)
        if not alive.any():
            break
    launches = {name: fmops.LAUNCHES[name]
                for name in ("occ4", "bwt_extend", "backward_search")}
    print(f"  seeding-shaped work on {n} reads: backward search {matched} steps "
          f"({launches['occ4']} occ4 launches of {2 * n} rows; mean "
          f"{n_matched.mean():.2f} bases matched, {int((n_matched == L).sum())} "
          f"reads in full), forward "
          f"extension {launches['bwt_extend']} bwt_extend launches of {n} "
          f"bi-intervals; the backward-search kernel "
          f"({launches['backward_search']} launch) against the stepwise search "
          f"max|kernel-host| {e_bs}; max|kernel-host| {err}")
    if err:
        raise AssertionError("occ4 / bwt_extend / backward_search disagree "
                             "with the host FMIndex")
    return launches, err, mid


def _time_rank(dev, fm, mid):
    """occ4 and bwt_extend on the mid-read inputs: the kernel alone, the
    wrapper (checks, allocation, kernel, flag read) and the plain version;
    then occ4 alone on 2^20 random rows.  Returns per kernel (kernel ms,
    plain ms, max|kernel-plain|)."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.engine.state import device_fm
    from bwamem_tpu_torch.ops import fmindex as fmops

    dfm = device_fm(fm, dev)
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    q = torch.from_numpy(mid["occ4"]).to(dev)
    cnt = torch.empty((len(q), 4), dtype=torch.int32, device=dev)
    xs = [torch.from_numpy(np.asarray(a, np.int64)).to(dev)
          for a in mid["bwt_extend"]]
    n = len(xs[0])
    outs = [torch.empty((n, 4), dtype=dt, device=dev)
            for dt in (torch.int64, torch.int64, torch.int32)]
    cases = {
        "occ4": (len(q), lambda: fmops.occ4_launch(dfm, q, cnt, flags),
                 lambda: fmops.occ4_cuda(dfm, q),
                 lambda: fmops.occ4_torch(dfm, q)),
        "bwt_extend": (n, lambda: fmops.extend_launch(dfm, *xs, False, *outs,
                                                       flags),
                       lambda: fmops.extend_cuda(dfm, *xs, False),
                       lambda: fmops.extend_torch(dfm, *xs, False)),
    }
    res = {}
    for name, (rows, kernel, wrapper, plain) in cases.items():
        got, ref = wrapper(), plain()
        err = (_diff(got, ref) if name == "occ4"
               else max(_diff(g, r) for g, r in zip(got, ref)))
        ms = _event_ms(kernel, 20, dev)
        wrapper_ms = _event_ms(wrapper, 20, dev)
        plain_ms = _event_ms(plain, 5, dev)
        print(f"  {name} on {rows} mid-read queries: kernel {ms:.4f} ms, "
              f"wrapper (checks, kernel, flag read) {wrapper_ms:.4f} ms, "
              f"plain PyTorch {plain_ms:.4f} ms; max|kernel-plain| {err}")
        if err:
            raise AssertionError(f"{name} disagrees with the plain version")
        bound = (_line_bound(dfm, 24 * rows, rows) if name == "occ4"
                 else _line_bound(dfm, 104 * rows, 2 * rows, 20 * rows))
        res[name] = (ms, plain_ms, err, bound)
    if int(flags.item()):
        raise AssertionError(f"rank kernels raised flags {int(flags.item())}")
    # the backward search of every read of the batch: kernel and plain version
    qseq, qlen = mid["backward_search"]
    B = qseq.shape[0]
    bk, bl = (torch.empty(B, dtype=torch.int64, device=dev) for _ in range(2))
    bm = torch.empty(B, dtype=torch.int32, device=dev)
    ms = _event_ms(lambda: fmops.backward_search_launch(dfm, qseq, qlen, bk, bl,
                                                        bm), 20, dev)
    plain, plain_ms = _once_ms(lambda: fmops.backward_search_torch(dfm, qseq,
                                                                   qlen), dev)
    err = max(_diff(g, p_) for g, p_ in zip((bk, bl, bm), plain))
    steps = int((bm + (bm < qlen).int()).sum())  # the failing step counts too
    bound = _line_bound(dfm, qseq.numel() + 24 * B, 2 * steps, 10 * steps)
    print(f"  backward_search on {B} reads ({steps} steps, longest "
          f"{int(bm.max())}): kernel {ms:.4f} ms, plain PyTorch {plain_ms:.4f} ms "
          f"(once); max|kernel-plain| {err}")
    if err:
        raise AssertionError("backward_search disagrees with the plain version")
    res["backward_search"] = (ms, plain_ms, err, bound)
    big = torch.from_numpy(np.random.default_rng(SEED + 4).integers(
        -1, fm.seq_len + 1, 1 << 20)).to(dev)
    big_out = torch.empty((len(big), 4), dtype=torch.int32, device=dev)
    ms = _event_ms(lambda: fmops.occ4_launch(dfm, big, big_out, flags), 20, dev)
    err = _diff(big_out, fmops.occ4_torch(dfm, big))
    print(f"  occ4 on 2^20 random rows: kernel {ms:.4f} ms "
          f"({len(big) / ms * 1e3:.4g} rows/s, "
          f"{len(big) * dfm.lines.shape[1] * 4 / ms / 1e6:.4g} GB/s of lines); "
          f"max|kernel-plain| {err}")
    if err:
        raise AssertionError("occ4 disagrees with the plain version")
    return res


def phase_chr20(dev):
    """Phase 8: the 64 Mbp genome with the SA walks and extension on the
    card; the SA kernel timed on the batch's rows; occ4 and bwt_extend on
    seeding-shaped work."""
    import numpy as np

    from bwamem_tpu_torch import BwaMemIndex
    from bwamem_tpu_torch.utils.synth import simulate_pairs
    from bwamem_tpu_torch import BwaMemAligner
    from bwamem_tpu_torch.engine.pipeline import SA_STATS
    from bwamem_tpu_torch.engine.state import device_fm

    t0 = time.perf_counter()
    codes, img, build_s = _synthetic_index(CHR20_LEN)
    index = BwaMemIndex(img)
    fm = index._require().fm
    t1 = time.perf_counter()
    dfm = device_fm(fm, dev)
    print(f"  64 Mbp genome + index in {t1 - t0:.1f} s (index build "
          f"{build_s:.1f} s on the host CPU); device tables in "
          f"{time.perf_counter() - t1:.2f} s: {dfm.lines.shape[0]} lines "
          f"({dfm.lines.numel() * 4 / 1e6:.1f} MB), {dfm.sa.numel()} SA samples "
          f"({dfm.sa.numel() * 8 / 1e6:.1f} MB)")
    rng = np.random.default_rng(SEED + 1)
    warm = simulate_pairs(codes, rng, 8)
    reads = simulate_pairs(codes, rng, CHR20_PAIRS)
    host = _host_aligner(index)
    port = BwaMemAligner(index, device=dev, device_stages=ALL_STAGES,
                         device_pipeline=False)
    for a in (host, port):
        _pe_setup(a)
        a.align_seqs(warm)
    ref, t_host = _timed(host, reads, dev)
    res = _port_run("chr20 pe+seed+sa+chain", port, reads, ref, t_host, dev)
    sa_launches = res["sa_launches"]
    if sa_launches <= 0 or SA_STATS.host_sa_rows:
        raise AssertionError("chr20: SA walks did not all run on the card")
    _check_seeded("chr20", res, reads)
    _check_chained("chr20", res, reads)
    x = _chain_exact(dev, index, reads)
    print(f"  chr20 chain kernels on the batch's own seeds: max|kernel-plain| "
          f"{x['e_plain']}; reads whose chains differ from the host C++ "
          f"chain_batch {x['e_host']} (of {len(reads) - int(x['ovf'].sum())} "
          f"not flagged by C = 128)")
    if x["e_plain"] or x["e_host"]:
        raise AssertionError("chr20: a chain kernel disagrees with its references")
    sa = _time_sa("64 Mbp, PE batch", dev, fm, SA_STATS.largest_rows)
    launches, err, mid = _rank_drive(dev, fm, reads)
    rank = _time_rank(dev, fm, mid)
    return dict(sa=sa,
                launches=launches, rank=rank, index=index,
                run=dict(batch=reads, ref=ref, t_host=t_host, warm=warm,
                         stages=res["stages"]))


def phase_probe(dev):
    """Phase 9: every probe kernel = its plain version (card, K=64), then
    the probe entry point's own run."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.benchmarks import op_probe

    rng = np.random.default_rng(SEED + 3)
    err, ms, plain_ms, nbytes, ops = 0, 0.0, 0.0, 0, 0
    for p in op_probe.PROBES:
        x = torch.from_numpy(rng.integers(-5000, 5000, p.shape)).to(
            dtype=p.dtype, device=dev)
        e = _diff(op_probe.probe_cuda(p, x, 64), op_probe.probe_torch(p, x, 64))
        k_ms = _event_ms(lambda: op_probe.probe_cuda(p, x, 64), 5, dev)
        p_ms = _event_ms(lambda: op_probe.probe_torch(p, x, 64), 2, dev)
        print(f"  {p.name:10s} K=64: max|kernel-plain| {e}; kernel {k_ms:.4f} "
              f"ms, plain PyTorch {p_ms:.4f} ms")
        err, ms, plain_ms = max(err, e), ms + k_ms, plain_ms + p_ms
        nbytes += 2 * x.numel() * x.element_size()
        ops += x.numel() * 64 * p.per_iter_ops
    if err:
        raise AssertionError("a probe kernel disagrees with its plain version")
    op_probe.LAUNCHES = 0
    if op_probe.main() != 0:
        raise AssertionError("the op probe's run failed")
    return dict(launches=op_probe.LAUNCHES, err=err, ms=ms, plain_ms=plain_ms,
                bound=_bound(nbytes, ops))


# the redesigned kernels, whose entries carry their slowest unit's time
# alone: a read's (a warp per read), a job's (the wave kernel), a row's (the
# SA walk) or a chain's (the prep kernel)
REDESIGNED = ("collect_intv", "chain2aln", "ksw_extend", "chain", "sa_lookup",
              "chain_emit", "chain2aln_prep", "sample_ks")
SEED_REPLACES = {
    "smem1a": "bwamem_tpu/ops/smem_tpu.py:39",
    "strategy1": "bwamem_tpu/ops/seed_tpu.py:80",
    "collect_intv": "bwamem_tpu/ops/seed_fused.py:72",
    "sample_ks": "bwamem_tpu/ops/seed_fused.py:72",
}


def _once_ms(fn, dev):
    """``fn()`` once between two CUDA events: (its result, ms)."""
    import torch

    torch.cuda.synchronize(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize(dev)
    return out, a.elapsed_time(b)


def _tuples_err(got, exp) -> int:
    """Largest |got - exp| of two lists of (x0, x1, s, qb, qe) tuples;
    raises when their lengths differ."""
    import numpy as np

    return _diff(np.asarray(got, np.int64).reshape(len(got), 5),
                 np.asarray(exp, np.int64).reshape(len(exp), 5))


def _lane_kernels(dev, fm, dfm, reads, sample):
    """smem1a and strategy1: one lane per read of ``reads`` from its first
    base, then the lanes of seed_cases.lanes over ``sample``; the kernels
    against the plain versions on all lanes and against the host oracle
    on the sample's.  Returns per kernel its errors and times."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.seed import seed_strategy1, smem1a
    from bwamem_tpu_torch.ops import fmindex as fmops
    from bwamem_tpu_torch.ops import seed as so
    from bwamem_tpu_torch.utils import seed_cases

    opt = MemOptions()
    lane_reads, xs, mis = list(reads), [0] * len(reads), [1] * len(reads)
    oracle = []
    for i, x, m in seed_cases.lanes(sample, SEED + 6):
        oracle.append((len(lane_reads), sample[i], x, m))
        lane_reads.append(sample[i])
        xs.append(x)
        mis.append(m)
    qseq, qlen = so.pad_reads(lane_reads, dev)
    x = torch.tensor(xs, dtype=torch.int32, device=dev)
    mi = torch.tensor(mis, dtype=torch.int64, device=dev)
    B = len(lane_reads)
    res = {}
    # smem1a
    got = so.smem1a_cuda(dfm, qseq, qlen, x, mi, so.K_SLOTS)
    plain, plain_ms = _once_ms(lambda: so.smem1a_torch(dfm, qseq, qlen, x, mi,
                                                       so.K_SLOTS), dev)
    e_plain = max(_diff(g, p) for g, p in zip(got, plain))
    g = [t.cpu().numpy() for t in got]
    e_host = 0
    for b, r, xb, m in oracle:
        if xb >= len(r) or r[xb] > 3:
            ret, mems = xb + 1, []
        else:
            ret, mems = smem1a(fm, r, xb, m)
        e_host = max(e_host, abs(int(g[0][b]) - ret))
        if not g[7][b]:
            mine = [tuple(int(v[b, j]) for v in g[1:6]) for j in range(g[6][b])]
            e_host = max(e_host, _tuples_err(mine[::-1], mems))
    outs = [torch.zeros(B, dtype=torch.int32, device=dev) for _ in range(3)]
    mems = torch.zeros((B, so.K_SLOTS, 5), dtype=torch.int64, device=dev)
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    ms = _event_ms(lambda: so.smem1a_launch(dfm, qseq, qlen, x, mi, outs[0], mems,
                                            outs[1], outs[2], flags), 10, dev)
    n_ovf = int(g[7].sum())
    print(f"  smem1a on {B} lanes ({len(reads)} reads from x = 0, {len(oracle)} "
          f"sample lanes; {n_ovf} K-overflows): kernel {ms:.4f} ms, plain "
          f"PyTorch {plain_ms:.4f} ms (once); max|kernel-plain| {e_plain}, "
          f"max|kernel-host| {e_host} ({len(oracle)} lanes)")
    # a forward and a backward pass over the read from x, one bwt_extend
    # (two lines) a base: an estimate, the kernel does not count its calls
    span = int((qlen.long() - x.long()).clamp(min=0).sum())
    res["smem1a"] = dict(err=max(e_plain, e_host), ms=ms, plain_ms=plain_ms,
                         bound=_line_bound(dfm, qseq.numel() + 24 * B
                                           + 40 * int(g[6].sum()), 4 * span,
                                           40 * span))
    # strategy1
    args = (opt.min_seed_len, opt.max_mem_intv)
    got = so.strategy1_cuda(dfm, qseq, qlen, x, *args)
    plain, plain_ms = _once_ms(lambda: so.strategy1_torch(dfm, qseq, qlen, x,
                                                          *args), dev)
    e_plain = max(_diff(g, p) for g, p in zip(got, plain))
    g = [t.cpu().numpy() for t in got]
    e_host = 0
    for b, r, xb, _ in oracle:
        if xb >= len(r) or r[xb] > 3:
            nxt, hit = xb + 1, None
        else:
            nxt, hit = seed_strategy1(fm, r, xb, *args)
        e_host = max(e_host, abs(int(g[6][b]) - nxt),
                     abs(int(g[0][b]) - (hit is not None)))
        if hit is not None:
            e_host = max(e_host, _tuples_err([tuple(int(v[b]) for v in g[1:6])],
                                             [hit]))
    found, nxt = (torch.zeros(B, dtype=torch.int32, device=dev) for _ in range(2))
    out = torch.zeros((B, 5), dtype=torch.int64, device=dev)
    ms = _event_ms(lambda: so.strategy1_launch(dfm, qseq, qlen, x, *args, found,
                                               out, nxt, flags), 10, dev)
    print(f"  strategy1 on {B} lanes ({int(g[0].sum())} found): kernel "
          f"{ms:.4f} ms, plain PyTorch {plain_ms:.4f} ms (once); "
          f"max|kernel-plain| {e_plain}, max|kernel-host| {e_host}")
    steps = int((torch.from_numpy(g[6]).long() - x.cpu().long()).clamp(min=0).sum())
    res["strategy1"] = dict(err=max(e_plain, e_host), ms=ms, plain_ms=plain_ms,
                            bound=_line_bound(dfm, qseq.numel() + 56 * B,
                                              2 * steps, 20 * steps))
    fmops._raise_flags("seeding lanes", flags)
    return res


def phase_seed_kernels(dev, fm, codes, batch):
    """Phase 10: the seeding kernels = plain (card) = host oracle."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.chain import sample_ks
    from bwamem_tpu_torch.engine.seed import collect_intv
    from bwamem_tpu_torch.utils.encoding import seq_to_codes_batch
    from bwamem_tpu_torch.engine.state import device_fm
    from bwamem_tpu_torch.ops import fmindex as fmops
    from bwamem_tpu_torch.ops import seed as so
    from bwamem_tpu_torch.utils import seed_cases

    opt = MemOptions()
    params = so.SeedParams.from_opt(opt)
    dfm = device_fm(fm, dev)
    edges = seed_cases.edge_reads([codes])
    reads = [np.asarray(c, np.uint8) for c in seq_to_codes_batch(batch)] + edges
    rng = np.random.default_rng(SEED + 5)
    pick = sorted(rng.choice(len(batch), SEED_SAMPLE, replace=False).tolist())
    pick += list(range(len(batch), len(reads)))  # the edge reads
    res = _lane_kernels(dev, fm, dfm, reads, [reads[i] for i in pick])
    # collect_intv + sample_ks + the SA walk on the whole batch
    qseq, qlen = so.pad_reads(reads, dev)
    B = len(reads)
    K = so.K_MAX  # the aligner's budget
    got = so.seed_sa(dfm, qseq, qlen, params, K=K)
    rbegs = fmops.sa_lookup(dfm, got.ks)  # as the pipeline walks them
    pwork = torch.zeros((B, 5), dtype=torch.int32, device=dev)
    piv, c_plain_ms = _once_ms(lambda: so.collect_intv_torch(
        dfm, qseq, qlen, params, so.M_SLOTS, K, pwork), dev)
    nrows = torch.where(piv.ovf, 0, piv.n)
    (pflat, pks), s_plain_ms = _once_ms(
        lambda: so.sample_ks_torch(piv.rows, nrows, piv.nks, params.max_occ), dev)
    prb = fmops.sa_lookup_torch(dfm, pks)
    iv, ok = got.intervals, ~got.intervals.ovf
    e_c = max(_diff(iv.ovf, piv.ovf), _diff(iv.n[ok], piv.n[ok]),
              _diff(iv.rows[ok], piv.rows[ok]), _diff(iv.nks, piv.nks))
    e_s = max(_diff(got.flat, pflat), _diff(got.ks, pks))
    e_w = _diff(rbegs, prb)
    # the host oracle on the sample, read by read
    n = torch.where(iv.ovf, 0, iv.n).cpu().numpy().astype(np.int64)
    ovf = iv.ovf.cpu().numpy()
    flat, ks, rb = (t.cpu().numpy() for t in (got.flat, got.ks, rbegs))
    row_off = np.concatenate([[0], np.cumsum(n)])
    k_off = np.concatenate([[0], np.cumsum(np.minimum(flat[:, 2], opt.max_occ))])
    e_ch = e_sh = e_wh = 0
    checked = 0
    for i in pick:
        if ovf[i]:
            continue
        exp = collect_intv(opt, fm, reads[i])
        mine = flat[row_off[i]: row_off[i + 1]]
        e_ch = max(e_ch, _tuples_err([tuple(r) for r in mine.tolist()], exp))
        for j, p in enumerate(exp):
            lo, hi = k_off[row_off[i] + j], k_off[row_off[i] + j + 1]
            exp_ks = np.asarray(sample_ks(p, opt.max_occ), np.int64)
            e_sh = max(e_sh, _diff(ks[lo:hi], exp_ks))
            e_wh = max(e_wh, _diff(rb[lo:hi], fm.sa_lookup(exp_ks)))
        checked += 1
    # the kernels alone on prepared operands, with the work counters
    q8, ql = qseq.contiguous(), qlen.to(torch.int32).contiguous()
    rows = torch.zeros((B, so.M_SLOTS, 5), dtype=torch.int64, device=dev)
    n32, o32 = (torch.zeros(B, dtype=torch.int32, device=dev) for _ in range(2))
    nks = torch.zeros(B, dtype=torch.int64, device=dev)
    work = torch.zeros((B, 5), dtype=torch.int32, device=dev)
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    c_ms = _event_ms(lambda: so.collect_intv_launch(
        dfm, q8, ql, params, so.M_SLOTS, K, rows, n32, o32, nks, flags, work),
        10, dev)
    cold_ms = _cold_ms(lambda: so.collect_intv_launch(
        dfm, q8, ql, params, so.M_SLOTS, K, rows, n32, o32, nks, flags, work),
        5, dev)
    fmops._raise_flags("collect_intv", flags)
    # the read with the most rank queries, alone
    slow = int(torch.argmax(work[:, 2]))
    one = [torch.zeros_like(t[:1]) for t in (rows, n32, o32, nks, work)]
    slow_ms = _event_ms(lambda: so.collect_intv_launch(
        dfm, q8[slow:slow + 1], ql[slow:slow + 1], params, so.M_SLOTS, K, one[0],
        one[1], one[2], one[3], flags, one[4]), 5, dev)
    e_c = max(e_c, _diff(one[4], work[slow:slow + 1]), _diff(pwork, work))
    # by batch size: the first nb reads
    by_size = {nb: _event_ms(lambda nb=nb: so.collect_intv_launch(
        dfm, q8[:nb], ql[:nb], params, so.M_SLOTS, K, rows[:nb], n32[:nb],
        o32[:nb], nks[:nb], flags, work[:nb]), 5, dev)
        for nb in (1000, 3000, 6000) if nb < B}
    nr = torch.where(o32.bool(), 0, n32)
    row_o, ks_o, n_tot, ks_tot = so._scan_offsets(nr, nks)
    flat2 = torch.empty((n_tot, 5), dtype=torch.int64, device=dev)
    ks2 = torch.empty(ks_tot, dtype=torch.int64, device=dev)
    s_ms, s_by = _card_ms(lambda: so.sample_ks_launch(
        rows, nr, row_o, ks_o, params.max_occ, flat2, ks2), 10, dev,
        "sample_ks_kernel")
    # the read with the most SA rows, alone
    s_top = int(torch.argmax(nks))
    s_ro, s_ko, s_n, s_k = so._scan_offsets(nr[s_top:s_top + 1],
                                            nks[s_top:s_top + 1])
    s_flat = torch.empty((s_n, 5), dtype=torch.int64, device=dev)
    s_ks = torch.empty(s_k, dtype=torch.int64, device=dev)
    s_top_ms, s_top_by = _card_ms(lambda: so.sample_ks_launch(
        rows[s_top:s_top + 1], nr[s_top:s_top + 1], s_ro, s_ko, params.max_occ,
        s_flat, s_ks), 10, dev, "sample_ks_kernel")
    r0, k0 = int(row_o[s_top]), int(ks_o[s_top])
    e_s = max(e_s, _diff(s_flat, flat2[r0: r0 + s_n]),
              _diff(s_ks, ks2[k0: k0 + s_k]))
    e_c = max(e_c, _diff(rows[ok], iv.rows[ok]))
    e_s = max(e_s, _diff(flat2, got.flat), _diff(ks2, got.ks))
    w = work.cpu().numpy().astype(np.int64)
    print(f"  collect_intv on {B} reads ({len(batch)} of phase 4's PE batch and "
          f"{len(edges)} edge reads; {int(ovf.sum())} flagged by the K/M budget): "
          f"kernel {c_ms:.4f} ms repeated, {cold_ms:.4f} ms from a cold L2, "
          f"plain PyTorch {c_plain_ms:.4f} ms (once); max|kernel-plain| {e_c}, "
          f"max|kernel-host| {e_ch} ({checked} reads)")
    print("  collect_intv_kernel by batch size: " + ", ".join(
        f"B={nb} {t:.4f} ms" for nb, t in by_size.items()) + f", B={B} "
          f"{c_ms:.4f} ms; {so.warps_per_sm(so.M_SLOTS, K)} warps "
          f"resident a SM (M = {so.M_SLOTS}, K = {K}); the read with the most "
          f"bwt_extend calls ({int(work[slow, 2])}) alone {slow_ms:.4f} ms; "
          f"work kernel = plain, column by column: max|diff| "
          f"{_diff(pwork, work)}")
    print(f"  collect_intv work per read: smem1a calls mean "
          f"{w[:, 0].mean():.3f} (max {w[:, 0].max()}), strategy1 calls mean "
          f"{w[:, 1].mean():.3f} (max {w[:, 1].max()}), bwt_extend calls mean "
          f"{w[:, 2].mean():.2f} (max {w[:, 2].max()}); K slots needed mean "
          f"{w[:, 4].mean():.2f} (max {w[:, 4].max()}), more than "
          f"{so.K_SLOTS} in {int((w[:, 4] > so.K_SLOTS).sum())} reads; "
          f"flagged at K = {K} by K {int((w[:, 3] == 1).sum())}, by M "
          f"{int((w[:, 3] == 2).sum())}; {len(flat)} rows, {len(ks)} SA rows")
    print(f"  sample_ks on those rows: kernel {s_ms:.5f} ms ({s_by}; the read "
          f"with the most SA rows, {s_k}, alone {s_top_ms:.5f} ms, {s_top_by}), "
          f"plain "
          f"PyTorch {s_plain_ms:.4f} ms (once); max|kernel-plain| {e_s}, "
          f"max|kernel-host| {e_sh}; SA walks of its rows max|kernel-plain| "
          f"{e_w}, max|kernel-host| {e_wh}")
    calls = int(w[:, 2].sum())
    res["collect_intv"] = dict(
        err=max(e_c, e_ch), ms=c_ms, ms_by="events", plain_ms=c_plain_ms,
        slowest_ms=slow_ms, slowest_by="events", bound=_line_bound(dfm, qseq.numel() + 20 * B + 40 * len(flat),
                          2 * calls, 20 * calls))
    res["sample_ks"] = dict(
        err=max(e_s, e_sh), ms=s_ms, ms_by=s_by, plain_ms=s_plain_ms,
        slowest_ms=s_top_ms, slowest_by=s_top_by, bound=_bound(80 * len(flat) + 8 * len(ks) + 20 * B, 4 * len(ks)))
    res["walks_err"] = max(e_w, e_wh)
    if any(v["err"] for k, v in res.items() if k != "walks_err") or res["walks_err"]:
        raise AssertionError("a seeding kernel disagrees with its references")
    return res


def _check_seeded(tag, res, reads, min_share=0.95):
    """The seeding kernels ran in ``res``'s run, every read was seeded once,
    every read seeded on the host was flagged by a budget, no read of up to
    K_MAX bases overflowed K, and at least ``min_share`` of the reads were
    seeded on the card."""
    from bwamem_tpu_torch.ops.seed import K_MAX

    st, la = res["seed_stats"], res["seed_launches"]
    n_reads = len(reads)
    if (la["collect_intv"] <= 0 or la["sample_ks"] <= 0
            or st["smem1a_calls"] <= 0 or st["strategy1_calls"] <= 0):
        raise AssertionError(f"{tag}: the seeding kernels did not run")
    if st["k_overflows"] and max(len(r) for r in reads) <= K_MAX:
        raise AssertionError(f"{tag}: {st['k_overflows']} reads of at most "
                             f"{K_MAX} bases overflowed K = {K_MAX}")
    if st["device_reads"] + st["host_reads"] != n_reads:
        raise AssertionError(f"{tag}: reads seeded {st['device_reads']} + "
                             f"{st['host_reads']}, not {n_reads}")
    if st["host_reads"] != st["k_overflows"] + st["m_overflows"]:
        raise AssertionError(f"{tag}: {st['host_reads']} reads seeded on the "
                             "host, not all of them flagged by a budget")
    if st["device_reads"] < min_share * n_reads:
        raise AssertionError(f"{tag}: only {st['device_reads']} of {n_reads} "
                             "reads seeded on the card")


def phase_device_seed(dev, index, runs):
    """Phase 11: the batches of phase 4 with the seeding on the card."""
    from bwamem_tpu_torch import BwaMemAligner
    from bwamem_tpu_torch.engine.pipeline import SA_STATS

    out = {}
    for tag, mode, stages in (("pe+seed+sa", "pe", ("seed", "sa_lookup")),
                              ("se+seed+sa", "se", ("seed", "sa_lookup")),
                              ("pe+seed", "pe", ("seed",))):
        r = runs[mode]
        port = BwaMemAligner(index, device=dev, device_stages=stages,
                             device_pipeline=False)
        if mode == "pe":
            _pe_setup(port)
        port.align_seqs(r["warm"])
        res = _port_run(tag, port, r["batch"], r["ref"], r["t_host"], dev)
        _check_seeded(tag, res, r["batch"])
        if "sa_lookup" in stages and (res["sa_launches"] <= 0
                                      or SA_STATS.host_sa_rows):
            raise AssertionError(f"{tag}: SA walks did not all run on the card")
        st = res["stages"]
        print(f"  {tag}: seed stage {st['seed']:.4f} s, sa_lookup stage "
              f"{st['sa_lookup']:.4f} s; phase 4's host C++ seed stage "
              f"{r['stages']['seed']:.4f} s, sa_lookup {r['stages']['sa_lookup']:.4f} s")
        out[tag] = res
    main = out["pe+seed+sa"]
    calls = {"smem1a": main["seed_stats"]["smem1a_calls"],
             "strategy1": main["seed_stats"]["strategy1_calls"]}
    return dict(runs=out, launches=main["seed_launches"], calls=calls)


def _check_chained(tag, res, reads, min_share=0.95):
    """Both chain kernels ran in ``res``'s run, every read was chained once,
    and at least ``min_share`` of the reads were chained on the card."""
    st, la = res["chain_stats"], res["chain_launches"]
    if la["chain"] <= 0 or la["chain_emit"] <= 0:
        raise AssertionError(f"{tag}: the chain kernels did not run")
    if st["device_reads"] + st["host_reads"] != len(reads):
        raise AssertionError(f"{tag}: reads chained {st['device_reads']} + "
                             f"{st['host_reads']}, not {len(reads)}")
    if st["device_reads"] < min_share * len(reads):
        raise AssertionError(f"{tag}: only {st['device_reads']} of {len(reads)} "
                             "reads chained on the card")


def _chain_key(c, full: bool):
    key = (c.rid, c.is_alt, c.frac_rep,
           tuple((s.rbeg, s.qbeg, s.len, s.score) for s in c.seeds))
    return key + ((c.w, c.kept, c.first) if full else ())


def _chain_exact(dev, index, batch):
    """The chain kernels on a batch's real seeds (seeded and walked on the
    card, as the aligner's chain stage gets them) against the plain version
    on the card, every output, and chain for chain against the host C++
    chain_batch on every read the C budget does not flag.  Returns the
    operands and results the timing needs, with the two differences."""
    import numpy as np

    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine import native_chain, pipeline
    from bwamem_tpu_torch.engine.exec_ctx import ExecConfig
    from bwamem_tpu_torch.engine.state import device_contigs
    from bwamem_tpu_torch.ops import chain as co
    from bwamem_tpu_torch.utils.encoding import seq_to_codes_batch

    opt = MemOptions()
    eng = index._require()
    bns = eng.idx.bns
    reads = seq_to_codes_batch(batch)
    qlens = np.asarray([len(r) for r in reads], dtype=np.int32)
    tab, _, _, _ = pipeline._device_table(opt, eng, reads, qlens, ExecConfig(
        device=dev, device_seed=True, device_sa_lookup=True, device_chain=True))
    ctg = device_contigs(bns, dev)
    params = co.ChainParams.from_opt(opt)
    got = co.chain_cuda(ctg, tab, params)
    plain, plain_ms = _once_ms(lambda: co.chain_torch(ctg, tab, params), dev)
    e_plain = max(_diff(g, p) for g, p in zip(got, plain))
    lists, (ovf, seed_cnt, nslots) = co.chains_device_batch(ctg, tab, params)
    rows, intv_off, n_intv, rbegs, rbeg_off, cnt = (
        t.cpu().numpy() for t in tab[1:])
    if not native_chain.available():
        raise RuntimeError("host C++ chain (engine/native/chain.cpp) did not build")
    host = native_chain.chain_batch(opt, bns, qlens, rows, intv_off, n_intv,
                                    rbegs, rbeg_off, cnt)
    e_host = sum(1 for i, (a, b) in enumerate(zip(lists, host)) if not ovf[i]
                 and [_chain_key(c, False) for c in a]
                 != [_chain_key(c, False) for c in b])
    return dict(opt=opt, eng=eng, bns=bns, reads=reads, qlens=qlens, tab=tab,
                ctg=ctg, params=params, got=got, plain_ms=plain_ms,
                e_plain=e_plain, e_host=e_host, lists=lists, ovf=ovf,
                seed_cnt=seed_cnt, nslots=nslots,
                flat=(rows, intv_off, n_intv, rbegs, rbeg_off, cnt))


def phase_chain_kernels(dev, index, batch):
    """Phase 12: the chain kernels = plain (card) = host C++ = host oracle on
    the PE batch's real seeds, then their times."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.engine.chain import chain_flt, mem_chain
    from bwamem_tpu_torch.engine.seed import SmemIntv
    from bwamem_tpu_torch.ops import chain as co

    x = _chain_exact(dev, index, batch)
    opt, eng, bns, reads, qlens = (x[k] for k in ("opt", "eng", "bns", "reads",
                                                 "qlens"))
    tab, ctg, params, got = x["tab"], x["ctg"], x["params"], x["got"]
    plain_ms, e_plain, e_host = x["plain_ms"], x["e_plain"], x["e_host"]
    lists, ovf, seed_cnt, nslots = (x[k] for k in ("lists", "ovf", "seed_cnt",
                                                  "nslots"))
    rows, intv_off, n_intv, rbegs, rbeg_off, cnt = x["flat"]
    rng = np.random.default_rng(SEED + 7)
    pick = sorted(rng.choice(len(reads), SEED_SAMPLE, replace=False).tolist())
    pick = sorted(set(pick) | set(np.argsort(seed_cnt)[-8:].tolist()))
    e_oracle = 0
    for i in pick:
        if ovf[i]:
            continue
        lo, hi = int(intv_off[i]), int(intv_off[i] + n_intv[i])
        exp = chain_flt(opt, mem_chain(
            opt, eng.fm, bns, int(qlens[i]),
            [SmemIntv(*r) for r in rows[lo:hi].tolist()],
            [rbegs[b: b + c] for b, c in zip(rbeg_off[lo:hi].tolist(),
                                             cnt[lo:hi].tolist())]))
        e_oracle += ([_chain_key(c, True) for c in lists[i]]
                     != [_chain_key(c, True) for c in exp])
    # the kernels alone on prepared operands
    tabp, seed_cnt_t, seed_off = co.prepare(ctg, tab)
    B, T = len(reads), int(seed_cnt_t.sum())
    i32, i64 = torch.int32, torch.int64
    assign, slot_dst = (torch.empty(T, dtype=i32, device=dev) for _ in range(2))
    crec = torch.empty((T, 5), dtype=i32, device=dev)
    n_chain, n_seed = (torch.zeros(B, dtype=i64, device=dev) for _ in range(2))
    o32, s32 = (torch.zeros(B, dtype=i32, device=dev) for _ in range(2))
    frac = torch.empty(B, dtype=torch.float64, device=dev)
    flags = torch.zeros(1, dtype=i32, device=dev)

    order = co.read_order(seed_cnt_t)

    def count(sub=tabp, off=seed_off, order=order):
        co.chain_launch(ctg, sub, off, params, co.C_MAX, order, assign,
                        slot_dst, crec, n_chain, n_seed, frac, o32, s32, flags)

    sizes = {}
    for nb in sorted({n for n in (1000, 3000, B // 2) if n < B}):
        sub, cnt_nb, off = co.prepare(ctg, tabp._replace(
            qlen=tabp.qlen[:nb], intv_off=tabp.intv_off[:nb],
            n_intv=tabp.n_intv[:nb]))
        ord_nb = co.read_order(cnt_nb)
        sizes[nb] = _event_ms(lambda: count(sub, off, ord_nb), 10, dev)
    top = int(np.argmax(seed_cnt))
    one, cnt1, off1 = co.prepare(ctg, tabp._replace(
        qlen=tabp.qlen[top: top + 1], intv_off=tabp.intv_off[top: top + 1],
        n_intv=tabp.n_intv[top: top + 1]))
    ord1 = co.read_order(cnt1)
    top_ms = _event_ms(lambda: count(one, off1, ord1), 10, dev)
    c_ms = _event_ms(count, 10, dev)
    cold_ms = _cold_ms(count, 5, dev)
    nc, ns = int(n_chain.sum()), int(n_seed.sum())
    chain_off = torch.cumsum(n_chain, 0) - n_chain
    seed_dst = torch.cumsum(n_seed, 0) - n_seed
    chain_rows = torch.empty((nc, 7), dtype=i64, device=dev)
    seed_rows = torch.empty((ns, 4), dtype=i64, device=dev)

    def emit():  # reads the count pass's scratch, writes only its outputs
        co.chain_emit_launch(ctg, tabp, seed_off, order, assign, slot_dst, crec,
                             n_chain, frac, chain_off, seed_dst, chain_rows,
                             seed_rows)

    e_ms = _event_ms(emit, 10, dev)
    e_cold_ms = _cold_ms(emit, 5, dev)
    # the emit pass of the read with the most seeds alone, on its own scratch
    T1 = int(cnt1.sum())
    s1 = [torch.empty(T1, dtype=i32, device=dev) for _ in range(2)]
    s1.append(torch.empty((T1, 5), dtype=i32, device=dev))
    c1 = [torch.zeros(1, dtype=i64, device=dev) for _ in range(2)]
    f1 = torch.empty(1, dtype=torch.float64, device=dev)
    co.chain_launch(ctg, one, off1, params, co.C_MAX, ord1, *s1, *c1, f1,
                    o32[:1].clone(), s32[:1].clone(), flags)
    z1 = torch.zeros(1, dtype=i64, device=dev)
    rows1 = (torch.empty((int(c1[0].item()), 7), dtype=i64, device=dev),
             torch.empty((int(c1[1].item()), 4), dtype=i64, device=dev))
    e_top_ms, e_top_by = _card_ms(lambda: co.chain_emit_launch(
        ctg, one, off1, ord1, *s1, c1[0], f1, z1, z1, *rows1), 10, dev,
        "chain_emit_kernel")
    if int(flags.item()):
        raise AssertionError(f"chain kernels raised flags {int(flags.item())}")
    e_plain = max(e_plain, _diff(chain_rows, got.chain_rows),
                  _diff(seed_rows, got.seed_rows))
    first, first_s = int(chain_off[top]), int(seed_dst[top])
    e_plain = max(e_plain,
                  _diff(rows1[0], chain_rows[first: first + rows1[0].shape[0]]),
                  _diff(rows1[1], seed_rows[first_s: first_s + rows1[1].shape[0]]))
    N = int(n_intv.sum())
    print(f"  chain on {B} reads ({N} intervals, {T} seeds; per read mean "
          f"{seed_cnt.mean():.1f}, p50/p90/p99 "
          f"{np.percentile(seed_cnt, [50, 90, 99]).tolist()}, max "
          f"{int(seed_cnt.max())}; chain slots used mean {nslots.mean():.2f}, max "
          f"{int(nslots.max())}, more than 32 in {int((nslots > 32).sum())} reads, "
          f"flagged at C = {co.C_MAX}: {int(ovf.sum())}; {nc} chains and {ns} "
          f"seeds out): chain_kernel {c_ms:.4f} ms repeated, {cold_ms:.4f} ms "
          f"from a cold L2; chain_emit_kernel alone {e_ms:.4f} ms repeated, "
          f"{e_cold_ms:.4f} ms from a cold L2; plain PyTorch "
          f"{plain_ms:.2f} ms (once)")
    print("  chain_kernel by batch size: " + ", ".join(
        f"B={nb} {ms:.4f} ms" for nb, ms in sizes.items())
        + f", B={B} {c_ms:.4f} ms; the read with the most seeds alone "
        f"({int(seed_cnt[top])} seeds, {int(nslots[top])} slots): {top_ms:.4f} ms, "
        f"{top_ms * 1e3 / max(int(seed_cnt[top]), 1):.3f} us per seed; "
        f"its emit pass alone ({e_top_by}) {e_top_ms:.4f} ms; "
        f"chain_kernel warps resident a SM: {co.warps_per_sm()}")
    print(f"  max|kernel-plain| {e_plain}; reads whose chains differ from the "
          f"host C++ chain_batch {e_host} (of {B}), from the oracle "
          f"chain_flt(mem_chain) with w, kept and first {e_oracle} (of "
          f"{len(pick)})")
    if e_plain or e_host or e_oracle:
        raise AssertionError("a chain kernel disagrees with its references")
    io = 8 * T + 56 * N + 28 * B
    return {
        "chain": dict(err=0, ms=c_ms, ms_by="events", plain_ms=plain_ms,
                      slowest_ms=top_ms, slowest_by="events", bound=_bound(io + 32 * B, 60 * T)),
        "chain_emit": dict(err=0, ms=e_ms, ms_by="events", plain_ms=plain_ms,
                           slowest_ms=e_top_ms, slowest_by=e_top_by,
                           bound=_bound(io + 4 * T + 16 * B + 56 * nc + 32 * ns,
                                        8 * T)),
    }


def phase_device_chain(dev, index, runs):
    """Phase 13: the batches of phase 4 with the chaining on the card."""
    from bwamem_tpu_torch import BwaMemAligner
    from bwamem_tpu_torch.engine.pipeline import SA_STATS

    out = {}
    for tag, mode, stages in (("pe+seed+sa+chain", "pe", ALL_STAGES),
                              ("se+seed+sa+chain", "se", ALL_STAGES),
                              ("pe+chain", "pe", ("chain",))):
        r = runs[mode]
        port = BwaMemAligner(index, device=dev, device_stages=stages,
                             device_pipeline=False)
        if mode == "pe":
            _pe_setup(port)
        port.align_seqs(r["warm"])
        res = _port_run(tag, port, r["batch"], r["ref"], r["t_host"], dev)
        _check_chained(tag, res, r["batch"])
        if "seed" in stages:
            _check_seeded(tag, res, r["batch"])
            if res["sa_launches"] <= 0 or SA_STATS.host_sa_rows:
                raise AssertionError(f"{tag}: SA walks did not all run on the card")
        st = res["stages"]
        print(f"  {tag}: chain stage {st['chain']:.4f} s (scans, two launches, "
              f"one copy back, Chain lists rebuilt in Python); phase 4's host "
              f"C++ chain stage {r['stages']['chain']:.4f} s")
        out[tag] = res
    return dict(runs=out, launches=out["pe+seed+sa+chain"]["chain_launches"])


def _chains_of(chains, idx):
    """``ops.chain.Chains`` of the reads ``idx`` (a tensor of read indices)
    alone, rows gathered on the card."""
    import torch

    from bwamem_tpu_torch.ops.chain import expand_ranges as expand

    n_chain, n_seed = chains.n_chain[idx], chains.n_seed[idx]
    chain_off = torch.cumsum(chains.n_chain, 0) - chains.n_chain
    seed_off = torch.cumsum(chains.n_seed, 0) - chains.n_seed
    return chains._replace(
        chain_rows=chains.chain_rows[expand(chain_off[idx], n_chain)],
        seed_rows=chains.seed_rows[expand(seed_off[idx], n_seed)],
        n_chain=n_chain, n_seed=n_seed, seed_cnt=chains.seed_cnt[idx],
        ovf=chains.ovf[idx], nslots=chains.nslots[idx])


def _prep_err(ctg, chains, lay, qlen, params, rmax, srt) -> int:
    """Largest difference of the prep kernel's ``rmax`` [Nc, 2] and ``srt``
    [Ns] from the plain version's windows and seed order (``chain_windows``:
    ``perm`` indexes seed rows, so it is mapped to indices within each
    chain)."""
    import torch

    from bwamem_tpu_torch.ops import pipeline_fused as fo

    r0, r1, perm, c_of = fo.chain_windows(ctg, chains, lay, qlen, params)
    within = perm - lay.chain_seed_off[c_of[perm]]
    return max(_diff(rmax, torch.stack([r0, r1], 1)), _diff(srt, within))


def _one_chain(chains, lay, q8, ql, run8, c: int):
    """Chain ``c`` alone as the prep kernel's operands: a one-read, one-chain
    ``Chains`` and its read's qseq, qlen and run."""
    import torch

    so, ns = int(lay.chain_seed_off[c]), int(lay.ns[c])
    r = int(lay.chain_read[c])
    one = torch.ones(1, dtype=torch.int64, device=ql.device)
    sub = chains._replace(
        chain_rows=chains.chain_rows[c: c + 1],
        seed_rows=chains.seed_rows[so: so + ns], n_chain=one,
        n_seed=one * ns, seed_cnt=chains.seed_cnt[r: r + 1],
        ovf=chains.ovf[r: r + 1], nslots=chains.nslots[r: r + 1])
    return sub, q8[r: r + 1], ql[r: r + 1], run8[r: r + 1]


def _region_rows(regs):
    """``Regions`` -> per read its regions as tuples (rb, re, qb, qe, score,
    truesc, w, seedcov, seedlen0, rid, frac_rep)."""
    import numpy as np

    rows = regs.compact().cpu().numpy()
    frac = rows[:, 2].copy().view(np.float64).tolist()
    flat = [tuple(r[:2]) + tuple(r[3:]) + (f,)
            for r, f in zip(rows.tolist(), frac)]
    out, k = [], 0
    for n in regs.nregs.tolist():
        out.append(flat[k: k + n])
        k += n
    return out


def _reg_tuples(regs_list):
    return [[(a.rb, a.re, a.qb, a.qe, a.score, a.truesc, a.w, a.seedcov,
              a.seedlen0, a.rid, a.frac_rep) for a in regs] for regs in regs_list]


def phase_chain2aln_kernels(dev, index, batch):
    """Phase 14: the chain-to-region kernels = plain (card) = host wave
    runner = host oracle on the PE batch's real chains, then their times."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.exec_ctx import ExecConfig
    from bwamem_tpu_torch.engine.extend import chain2aln
    from bwamem_tpu_torch.engine.extend_batch import chain2aln_batch
    from bwamem_tpu_torch.engine.pipeline_device import (FUSED_STATS,
                                                         regs_batch_fused)
    from bwamem_tpu_torch.ops import chain as co
    from bwamem_tpu_torch.ops import extend as ext
    from bwamem_tpu_torch.ops import pipeline_fused as fo
    from bwamem_tpu_torch.utils.encoding import seq_to_codes_batch

    opt = MemOptions()
    eng = index._require()
    reads = seq_to_codes_batch(batch)
    # the operands as the fused path's entry leaves them on the card
    FUSED_STATS.reset()
    regs_batch_fused(opt, eng, reads, ExecConfig(device=dev, device_pipeline=True))
    ctg, ref, chains, qseq, qlen, run, params, mat, t_cap = FUSED_STATS.largest_batch
    B = len(reads)
    # the band preamble the loop kernel computes per job
    rng = np.random.default_rng(SEED + 8)
    bw = [torch.from_numpy(rng.integers(lo, hi, 100_000)).int().to(dev)
          for lo, hi in ((0, 200), (1, 250), (0, 12))]
    sc = (params.max_sc, params.o_del, params.e_del, params.o_ins, params.e_ins)
    e_bw = _diff(fo.band_width_cuda(*bw, *sc), ext.band_width(*bw, *sc))
    # kernel = plain on a sample plus the heaviest reads
    whole = fo.chain2aln_cuda(ctg, ref, chains, qseq, qlen, run, params, mat, t_cap)
    work = whole.work.cpu().numpy()
    n_seed, n_chain = chains.n_seed.cpu().numpy(), chains.n_chain.cpu().numpy()
    pick = set(rng.choice(B, min(1000, B), replace=False).tolist())
    for key in (n_seed, n_chain, work[:, fo.W_CELLS]):
        pick |= set(np.argsort(key)[-8:].tolist())
    pick = sorted(pick)
    idx = torch.tensor(pick, device=dev)
    sub = (ctg, ref, _chains_of(chains, idx), qseq[idx], qlen[idx], run[idx],
           params, mat, t_cap)
    got = fo.chain2aln_cuda(*sub)
    plain, plain_ms = _once_ms(lambda: fo.chain2aln_torch(*sub), dev)
    e_plain = max(_diff(getattr(got, k), getattr(plain, k))
                  for k in ("reg_c", "reg_i", "nregs", "seed_off"))
    e_plain = max(e_plain, _diff(got.work, plain.work))
    mine = _region_rows(got)
    all_rows = _region_rows(whole)
    e_sub = sum(mine[j] != all_rows[i] for j, i in enumerate(pick))
    # the host wave runner (host C++ ksw) on the sample, the oracle on part
    lists = [cl or [] for cl in co.chain_lists(sub[2])[0]]
    sub_reads = [reads[i] for i in pick]
    host = chain2aln_batch(opt, eng.idx, sub_reads, lists, ExecConfig(
        device="cpu", min_device_jobs=1 << 30))
    e_host = sum(a != b for a, b in zip(mine, _reg_tuples(host)))
    part = list(range(0, len(pick), max(len(pick) // 64, 1)))
    part = sorted(set(part) | {pick.index(int(np.argmax(work[:, fo.W_CELLS])))})
    e_oracle = 0
    for j in part:
        regs = []
        for c in lists[j]:
            chain2aln(opt, eng.idx, len(sub_reads[j]), sub_reads[j], c, regs)
        e_oracle += mine[j] != _reg_tuples([regs])[0]
    # the kernels alone on prepared operands
    chains_p, lay, q8, ql, run8 = fo.prepare(ctg, ref, chains, qseq, qlen, run)
    i32, i64 = torch.int32, torch.int64
    Nc, Ns = chains_p.chain_rows.shape[0], chains_p.seed_rows.shape[0]
    rmax = torch.empty((Nc, 2), dtype=i64, device=dev)
    srt = torch.empty(Ns, dtype=i32, device=dev)
    alive = torch.empty(Ns, dtype=torch.uint8, device=dev)
    reg_c = torch.zeros((Ns, 3), dtype=i64, device=dev)
    reg_i = torch.zeros((Ns, 8), dtype=i32, device=dev)
    err = torch.zeros(1, dtype=i32, device=dev)
    mat_c = mat.contiguous()
    Q = fo.kernel_query_len(ql, run8, mat_c)

    def prep():
        fo.chain2aln_prep_launch(ctg, chains_p, lay, ql, params, rmax, srt, err)

    def looper(lo=0, hi=B):
        """The loop kernel on reads [lo, hi), their order taken once."""
        n = hi - lo
        order = fo.read_order(chains_p.n_seed[lo:hi], ql[lo:hi], run8[lo:hi])
        nregs = torch.zeros(n, dtype=i32, device=dev)
        wk = torch.zeros((n, 6), dtype=i64, device=dev)

        def loop():
            fo.chain2aln_launch(
                ref, chains_p, lay, chains_p.n_chain[lo:hi],
                chains_p.n_seed[lo:hi], lay.chain_off[lo:hi], lay.seed_off[lo:hi],
                rmax, srt, alive, run8[lo:hi], q8[lo:hi], ql[lo:hi], mat_c,
                params, t_cap, order, Q, reg_c, reg_i, nregs, wk, err)
            return nregs, wk
        return loop

    # the prep kernel's own outputs against the plain version's, on the
    # whole batch, and on the chain with the most seeds alone (device time:
    # CUDA events around a launch this small time the host's call)
    prep_ms, prep_by = _card_ms(prep, 10, dev, "chain2aln_prep_kernel")
    e_prep = _prep_err(ctg, chains_p, lay, ql, params, rmax, srt)
    _, prep_plain_ms = _once_ms(lambda: fo.chain_windows(ctg, chains_p, lay, ql,
                                                         params), dev)
    top_c = int(torch.argmax(lay.ns))
    c_sub, c_q, c_ql, c_run = _one_chain(chains_p, lay, q8, ql, run8, top_c)
    c_sub, c_lay, _, c_ql, _ = fo.prepare(ctg, ref, c_sub, c_q, c_ql, c_run)
    c_rmax = torch.empty((1, 2), dtype=i64, device=dev)
    c_srt = torch.empty(int(lay.ns[top_c]), dtype=i32, device=dev)
    prep_top_ms, prep_top_by = _card_ms(lambda: fo.chain2aln_prep_launch(
        ctg, c_sub, c_lay, c_ql, params, c_rmax, c_srt, err), 10, dev,
        "chain2aln_prep_kernel")
    e_prep = max(e_prep, _prep_err(ctg, c_sub, c_lay, c_ql, params, c_rmax,
                                   c_srt))
    sizes = {nb: _event_ms(looper(0, nb), 3, dev)
             for nb in sorted({n for n in (1000, 3000, B // 2) if n < B})}
    top = int(np.argmax(work[:, fo.W_CELLS]))
    top_ms = _event_ms(looper(top, top + 1), 3, dev)
    loop = looper()
    ms = _event_ms(loop, 5, dev)
    cold_ms = _cold_ms(loop, 5, dev)
    nregs, wk = loop()
    fo.raise_flags(int(err.item()))
    e_plain = max(e_plain, _diff(nregs, whole.nregs), _diff(wk, whole.work),
                  _diff(reg_c, whole.reg_c), _diff(reg_i, whole.reg_i))
    # the 100 reads with the most cells alone, as a batch of their own
    heavy = torch.from_numpy(np.argsort(work[:, fo.W_CELLS])[-100:].copy()).to(dev)
    h_args = (ctg, ref, _chains_of(chains, heavy), qseq[heavy], qlen[heavy],
              run[heavy])
    h_chains, h_lay, h_q, h_ql, h_run = fo.prepare(*h_args)
    h_order = fo.read_order(h_chains.n_seed, h_ql, h_run)
    kernel_q = fo.kernel_query_len(h_ql, h_run, mat_c)
    h_out = fo.chain2aln_cuda(*h_args, params, mat, t_cap)
    h_nregs = torch.zeros(len(heavy), dtype=i32, device=dev)
    h_wk = torch.zeros((len(heavy), 6), dtype=i64, device=dev)
    h_reg_c, h_reg_i = torch.zeros_like(h_out.reg_c), torch.zeros_like(h_out.reg_i)
    h_rmax = torch.empty((h_chains.chain_rows.shape[0], 2), dtype=i64, device=dev)
    h_srt = torch.empty(h_chains.seed_rows.shape[0], dtype=i32, device=dev)
    h_alive = torch.empty(h_chains.seed_rows.shape[0], dtype=torch.uint8, device=dev)
    fo.chain2aln_prep_launch(ctg, h_chains, h_lay, h_ql, params, h_rmax, h_srt, err)
    e_prep = max(e_prep, _prep_err(ctg, h_chains, h_lay, h_ql, params, h_rmax,
                                   h_srt))
    heavy_ms = _event_ms(lambda: fo.chain2aln_launch(
        ref, h_chains, h_lay, h_chains.n_chain, h_chains.n_seed, h_lay.chain_off,
        h_lay.seed_off, h_rmax, h_srt, h_alive, h_run, h_q, h_ql, mat_c, params,
        t_cap, h_order, kernel_q, h_reg_c, h_reg_i, h_nregs, h_wk, err), 3, dev)
    fo.raise_flags(int(err.item()))
    e_plain = max(e_plain, e_prep, _diff(h_wk, whole.work[heavy]),
                  _diff(h_out.work, whole.work[heavy]),
                  sum(a != b for a, b in zip(_region_rows(h_out),
                                             [all_rows[i] for i in heavy.tolist()])))
    warps = fo.warps_per_sm(Q)
    # the longest read the loop kernel runs on this card, and the card's
    # refusal one base past it
    limit = fo.kernel_max_qlen(mat_c, dev)
    at_limit = fo.warps_per_sm(limit)
    if at_limit <= 0 or fo.warps_per_sm(limit + 1) != -1:
        raise AssertionError(f"the loop kernel's read-length limit {limit} is "
                             "not where the card's shared memory ends")
    tasks, pruned, jobs = (int(work[:, k].sum())
                           for k in (fo.W_TASKS, fo.W_PRUNED, fo.W_JOBS))
    cells, rows = int(work[:, fo.W_CELLS].sum()), int(work[:, fo.W_ROWS].sum())
    nr = int(whole.nregs.sum())
    print(f"  chain2aln on {B} reads ({Nc} chains, {Ns} seeds; {tasks} tasks "
          f"extended, {pruned} pruned, {jobs} extension jobs, {cells} band cells, "
          f"{rows} target rows read from the pac, {nr} regions; per read tasks "
          f"mean {work[:, fo.W_TASKS].mean():.2f} max "
          f"{int(work[:, fo.W_TASKS].max())}, jobs mean "
          f"{work[:, fo.W_JOBS].mean():.2f} max {int(work[:, fo.W_JOBS].max())}, "
          f"cells mean {work[:, fo.W_CELLS].mean():.0f} p99 "
          f"{np.percentile(work[:, fo.W_CELLS], 99):.0f} max "
          f"{int(work[:, fo.W_CELLS].max())}): chain2aln_prep_kernel "
          f"{prep_ms:.5f} ms ({prep_by}; its plain version chain_windows "
          f"{prep_plain_ms:.4f} ms once; the chain with the most seeds, "
          f"{int(lay.ns[top_c])}, alone {prep_top_ms:.5f} ms, {prep_top_by}), "
          f"chain2aln_kernel {ms:.4f} ms ({cold_ms:.4f} ms "
          f"from a cold L2); plain PyTorch on "
          f"{len(pick)} reads {plain_ms:.1f} ms (once)")
    print("  chain2aln_kernel by batch size: " + ", ".join(
        f"B={nb} {t:.4f} ms" for nb, t in sizes.items())
        + f", B={B} {ms:.4f} ms; the read with the most cells alone "
        f"({int(work[top, fo.W_TASKS])} tasks, {int(work[top, fo.W_JOBS])} jobs, "
        f"{int(work[top, fo.W_CELLS])} cells, {int(work[top, fo.W_ROWS])} rows): "
        f"{top_ms:.4f} ms, {top_ms * 1e6 / max(int(work[top, fo.W_CELLS]), 1):.1f} "
        f"ns per cell, "
        f"{top_ms * 1e6 / max(int(work[top, fo.W_ROWS]), 1):.1f} ns per row; "
        f"the 100 reads with the most cells alone "
        f"({int(work[heavy.cpu().numpy(), fo.W_CELLS].sum())} cells): "
        f"{heavy_ms:.4f} ms; {warps} warps resident a SM (reads of up to {Q} "
        f"bases); reads of up to {limit} bases fit a block ({at_limit} warps "
        f"a SM there; longer reads take the staged path); the read order (one "
        f"torch.sort) not timed")
    print(f"  prep kernel's rmax and srt against chain_windows's windows and "
          f"order (the whole batch, the chain with the most seeds alone, the "
          f"100 reads with the most cells): max|diff| {e_prep}")
    print(f"  max|kernel-plain| {e_plain} ({len(pick)} reads, every field); reads "
          f"whose regions differ between the sample's run and the whole batch's "
          f"{e_sub}, from the host wave runner's {e_host} (of {len(pick)}), from "
          f"the oracle chain2aln's {e_oracle} (of {len(part)}); band preamble "
          f"max|kernel-band_width| {e_bw} (100,000 jobs)")
    if e_plain or e_sub or e_host or e_oracle or e_bw:
        raise AssertionError("a chain-to-region kernel disagrees with its "
                             "references")
    io_in = 56 * Nc + 32 * Ns + 4 * Ns + q8.numel() + 45 * B
    return {
        # ns, chain_seed_off, chain_read, the read's qlen and rmax a chain;
        # the seed rows and srt a seed; the contig table once
        "chain2aln_prep": dict(
            err=e_prep, ms=prep_ms, ms_by=prep_by, plain_ms=prep_plain_ms,
            slowest_ms=prep_top_ms, slowest_by=prep_top_by,
            bound=_bound(40 * Nc + 36 * Ns + 16 * ctg.ctg_end.numel(),
                         30 * Ns)),
        "chain2aln": dict(err=0, ms=ms, ms_by="events", plain_ms=plain_ms,
                          slowest_ms=top_ms, slowest_by="events", bound=_bound(
            io_in + 16 * Nc + min(rows / 4, ref.pac.numel()) + 56 * nr + 52 * B,
            10 * cells)),
    }


def _check_fused(tag, res, reads, min_share=0.95):
    """The fused path's kernels ran in ``res``'s run, every read was on the
    fused path or the staged one once, at least ``min_share`` on the fused
    path (below it, the share and the reads that left by cause are printed
    first), every read that left was flagged, the seeding checks hold, and
    no extension wave ran when no read left.  Returns the fused share."""
    fs, la, n = res["fused_stats"], res["fused_launches"], len(reads)
    if any(v <= 0 for v in la.values()):
        raise AssertionError(f"{tag}: the chain-to-region kernels did not run")
    if fs["device_reads"] + fs["host_reads"] != n:
        raise AssertionError(f"{tag}: reads {fs['device_reads']} + "
                             f"{fs['host_reads']}, not {n}")
    share = fs["device_reads"] / n
    if share < min_share:
        print(f"  {tag}: fused share {share:.4f} below {min_share}: reads that "
              f"left by cause: seeded on the host {fs['host_seeded']} (K "
              f"{res['seed_stats']['k_overflows']}, M "
              f"{res['seed_stats']['m_overflows']}), flagged by C "
              f"{fs['c_overflows']}, fcs {fs['fcs_reads']}, past the loop "
              f"kernel's length {fs['long_reads']}")
        raise AssertionError(f"{tag}: only {fs['device_reads']} of {n} reads "
                             "on the fused path")
    _check_seeded(tag, res, reads, min_share)
    if any(v <= 0 for v in res["chain_launches"].values()):
        raise AssertionError(f"{tag}: the chain kernels did not run")
    if fs["host_reads"] != (fs["host_seeded"] + fs["c_overflows"]
                            + fs["fcs_reads"] + fs["long_reads"]):
        raise AssertionError(f"{tag}: a read left the fused path unflagged")
    if fs["host_reads"] == 0 and (res["waves"] or res["launches"]):
        raise AssertionError(f"{tag}: {res['waves']} extension waves though "
                             "no read left the fused path")
    return share


def phase_fused(dev, index, runs, chain_run, big):
    """Phase 15: phase 4's batches and phase 8's chr20 batch through the
    fused device path."""
    from bwamem_tpu_torch import BwaMemAligner

    out = {}
    for tag, r, idx in (("pe+fused", runs["pe"], index),
                        ("se+fused", runs["se"], index),
                        ("chr20 pe+fused", big["run"], big["index"])):
        port = BwaMemAligner(idx, device=dev, device_pipeline=True)
        if tag != "se+fused":
            _pe_setup(port)
        port.align_seqs(r["warm"])
        res = _port_run(tag, port, r["batch"], r["ref"], r["t_host"], dev,
                        fused=True)
        fs, la = res["fused_stats"], res["fused_launches"]
        _check_fused(tag, res, r["batch"])
        st = res["stages"]
        rest = res["seconds"] - sum(_top_level(st).values())
        print(f"  {tag}: device_pipeline {st['device_pipeline']:.4f} s, "
              f"native_tail {st['native_tail']:.4f} s, untimed rest "
              f"{rest:.3f} s; {res['waves']} extension waves (all from the "
              f"{fs['host_reads']} reads on the staged path)")
        if tag == "pe+fused":
            ref_st = chain_run["runs"]["pe+seed+sa+chain"]["stages"]
            print(f"  {tag}: phase 13's staged run of the same batch: " + ", ".join(
                f"{k} {v:.4f}" for k, v in ref_st.items()) + " s")
            busy, wall, per = _fresh_traced_batch(
                tag, dict(device_pipeline=True), "pe",
                {**res["seed_launches"], **res["chain_launches"], **la,
                 "sa_lookup": res["sa_launches"]})
            res["batch_kernels"] = per
            res["busy"], res["wall"] = busy, wall
            print(f"  {tag}: again under torch.profiler, in a fresh process: "
                  f"card busy {busy:.4f} s of {wall:.2f} s, idle share "
                  f"{1 - busy / wall:.4f}; kernels summed over the batch: "
                  + _per_kernel(per))
        out[tag] = res
    return dict(runs=out, launches=out["pe+fused"]["fused_launches"],
                batch_kernels=out["pe+fused"]["batch_kernels"],
                busy=out["pe+fused"]["busy"], wall=out["pe+fused"]["wall"])


# a card aligner takes the fused path unless it says device_pipeline=False
WAVES = dict(device_pipeline=False)
ROUTES = (("host", None), ("default", WAVES),
          ("staged", dict(WAVES, device_stages=ALL_STAGES)),
          ("fused", dict(device_pipeline=True)))


def _reset_counts():
    """Every launch count and stats object of the port set to 0."""
    from bwamem_tpu_torch.engine.extend_batch import STATS
    from bwamem_tpu_torch.engine.pipeline import CHAIN_STATS, SA_STATS
    from bwamem_tpu_torch.engine.pipeline_device import FUSED_STATS
    from bwamem_tpu_torch.engine.seed_device import SEED_STATS
    from bwamem_tpu_torch.ops import chain as chainops
    from bwamem_tpu_torch.ops import extend as ext
    from bwamem_tpu_torch.ops import fmindex as fmops
    from bwamem_tpu_torch.ops import pipeline_fused as fusedops
    from bwamem_tpu_torch.ops import seed as seedops
    from bwamem_tpu_torch.utils.timers import TIMERS

    for st in (STATS, SA_STATS, SEED_STATS, CHAIN_STATS, FUSED_STATS, TIMERS):
        st.reset()
    ext.LAUNCHES = 0
    fmops.LAUNCHES["sa_lookup"] = 0
    for counts in (seedops.LAUNCHES, chainops.LAUNCHES, fusedops.LAUNCHES):
        for name in counts:
            counts[name] = 0


def _launched() -> dict:
    """The launch counts since ``_reset_counts``, by kernel."""
    from bwamem_tpu_torch.ops import chain as chainops
    from bwamem_tpu_torch.ops import extend as ext
    from bwamem_tpu_torch.ops import fmindex as fmops
    from bwamem_tpu_torch.ops import pipeline_fused as fusedops
    from bwamem_tpu_torch.ops import seed as seedops

    return {"ksw_extend": ext.LAUNCHES, "sa_lookup": fmops.LAUNCHES["sa_lookup"],
            **seedops.LAUNCHES, **chainops.LAUNCHES, **fusedops.LAUNCHES}


# the kernels each card route must launch in its run
ROUTE_KERNELS = {"default": ("ksw_extend",),
                 "staged": ("collect_intv", "sample_ks", "sa_lookup", "chain",
                            "chain_emit"),
                 "fused": ("collect_intv", "sample_ks", "sa_lookup", "chain",
                           "chain_emit", "chain2aln_prep", "chain2aln")}


def phase_native_tail(dev, index, runs, big, card, fused_trace):
    """Phase 16: the C++ tail under the four routes, on phase 4's batches
    and phase 8's chr20 pairs.  ``fused_trace``: phase 15's profiled rerun
    of the fused ecoli PE batch (the same route, C++ tail included), whose
    busy and idle share this phase prints beside that route."""
    from bwamem_tpu_torch import BwaMemAligner
    from bwamem_tpu_torch.engine import pair as pair_mod
    from bwamem_tpu_torch.utils.timers import TIMERS

    calls = {"sam_pe": 0}
    sam_pe = pair_mod.sam_pe

    def counted(*a, **k):
        calls["sam_pe"] += 1
        return sam_pe(*a, **k)

    out = {}
    for name, r, idx in (("ecoli pe", runs["pe"], index),
                         ("ecoli se", runs["se"], index),
                         ("chr20 pe", big["run"], big["index"])):
        n = len(r["batch"])
        for route, kw in ROUTES:
            tag = f"{name} {route}"
            a = (_host_aligner(idx) if kw is None
                 else BwaMemAligner(idx, device=dev, **kw))
            if name.endswith("pe"):
                _pe_setup(a)
            a.align_seqs(r["warm"])
            _reset_counts()
            calls["sam_pe"] = 0
            pair_mod.sam_pe = counted
            try:
                got, secs = _timed(a, r["batch"], dev)
            finally:
                pair_mod.sam_pe = sam_pe
            st, launched = TIMERS.snapshot(), _launched()
            py, t_py = _python_route(a, r["batch"])
            ok_host, ok_py = _equal(got, r["ref"]), _equal(got, py)
            rest = secs - sum(_top_level(st).values())
            print(f"  {tag}: {n} reads, records equal to the host whole-batch "
                  f"route's {ok_host}/{n}, to the Python route's {ok_py}/{n}; "
                  f"{n / secs:.1f} reads/s ({secs:.3f} s) [{card}]")
            print(f"  {tag}: stages " + ", ".join(
                f"{k} {v:.4f}" for k, v in st.items())
                + f" s, untimed rest {rest:.4f} s; native_tail "
                f"{st.get('native_tail', 0.0):.4f} s against the Python tail's "
                f"{t_py:.4f} s on the same regions; pair.sam_pe calls "
                f"{calls['sam_pe']}; launches " + ", ".join(
                    f"{k} {v}" for k, v in launched.items() if v) + f" [{card}]")
            if ok_host != n or ok_py != n:
                raise AssertionError(f"{tag}: records differ")
            if "native_tail" not in st:
                raise AssertionError(f"{tag}: no native_tail stage")
            if kw is not None:
                if calls["sam_pe"] or "dedup" in st:
                    raise AssertionError(f"{tag}: the tail ran in Python")
                idle = [k for k in ROUTE_KERNELS[route] if launched.get(k, 0) <= 0]
                if idle:
                    raise AssertionError(f"{tag}: {idle} did not run")
            elif any(launched.values()):
                raise AssertionError(f"{tag}: the host route launched {launched}")
            res = dict(seconds=secs, stages=st, python_tail=t_py,
                       reads_per_s=n / secs)
            if name == "ecoli pe" and route == "fused":
                busy, wall = fused_trace["busy"], fused_trace["wall"]
                print(f"  {tag}: phase 15's rerun of this batch and route "
                      f"under torch.profiler: card busy {busy:.4f} s of "
                      f"{wall:.3f} s, idle share {1 - busy / wall:.4f} [{card}]")
            out[tag] = res
    return out


CLI_PAIRS = 40_000
FUSED_KERNELS = ("collect_intv", "sample_ks", "sa_lookup", "chain", "chain_emit",
                 "chain2aln_prep", "chain2aln")


def _write_cli_inputs(d: str, codes):
    """The genome as ref.fa, and CLI_PAIRS simulated pairs (150 bp, insert
    350 +- 35) as r1.fq, r2.fq and the interleaved inter.fq; read names
    p<pair ordinal>."""
    import numpy as np

    from bwamem_tpu_torch.utils.synth import simulate_pairs

    text = np.frombuffer(b"ACGTN", dtype=np.uint8)[codes].tobytes()
    with open(os.path.join(d, "ref.fa"), "wb") as fh:
        fh.write(b">chr\n")
        for i in range(0, len(text), 80):
            fh.write(text[i: i + 80] + b"\n")
    reads = simulate_pairs(codes, np.random.default_rng(SEED + 17), CLI_PAIRS)
    qual = b"I" * 150
    recs = [b"@p%d\n%s\n+\n%s\n" % (i // 2, r, qual[: len(r)])
            for i, r in enumerate(reads)]
    for name, part in (("r1", recs[0::2]), ("r2", recs[1::2]), ("inter", recs)):
        with open(os.path.join(d, f"{name}.fq"), "wb") as fh:
            fh.write(b"".join(part))


def _cli(d: str, args, out: str, env=None):
    """``python -m bwamem_tpu_torch <args>`` in a fresh process from the
    checkout, its standard output into ``d/out``: (wall seconds, stderr)."""
    child_env = {**os.environ, "PYTHONPATH": ROOT, **(env or {})}
    t0 = time.perf_counter()
    with open(os.path.join(d, out), "wb") as fh:
        res = subprocess.run([sys.executable, "-m", "bwamem_tpu_torch", *args],
                             stdout=fh, stderr=subprocess.PIPE, text=True,
                             cwd=d, env=child_env, timeout=900)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"bwamem_tpu_torch {' '.join(args)} exited "
                             f"{res.returncode}: {res.stderr[-3000:]}")
    return secs, res.stderr


def _sam_body(path: str) -> list:
    with open(path) as fh:
        return [ln for ln in fh if not ln.startswith("@")]


def _same_file(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _merged(paths) -> list:
    """The SAM lines of one run, or of its shards merged back, in read
    ordinal order (names p<ordinal>)."""
    groups = {}
    for p in paths:
        for ln in _sam_body(p):
            groups.setdefault(ln.split("\t", 1)[0], []).append(ln)
    return [ln for name in sorted(groups, key=lambda n: int(n[1:]))
            for ln in groups[name]]


def _trace_kernels(trace_dir: str) -> list:
    """Per Chrome trace file of ``trace_dir``: its kernels' launches by
    entry of the kernels line."""
    out = []
    for f in sorted(os.listdir(trace_dir)):
        with open(os.path.join(trace_dir, f)) as fh:
            events = json.load(fh)["traceEvents"]
        counts = {}
        for e in events:
            if e.get("cat") == "kernel":
                entry = _kernel_of(e.get("name", "")) or e.get("name", "")[:60]
                counts[entry] = counts.get(entry, 0) + 1
        out.append((f, counts))
    return out


def _cli_shares(tag, secs, dumps, card) -> dict:
    """Reads/s of a CLI run and where its seconds went, from its metrics
    dumps (one after each batch, one at the end): the aligner's stages, the
    command's own (``cli_*``, and ``records``: records_from_arrays) and the
    rest (the interpreter's start-up, the imports, the card's set-up
    outside a stage); then each batch's reads and aligner seconds (the
    first batch's include the first calls' set-up on the card)."""
    def own(k):
        return k.startswith("cli_") or k == "records"

    last = dumps[-1]
    st, n_reads = _top_level(last["stage_seconds"]), last["counters"]["reads"]
    cli = {k: v for k, v in st.items() if own(k)}
    aligner = sum(v for k, v in st.items() if not own(k))
    rest = secs - aligner - sum(cli.values())
    print(f"  {tag}: {n_reads} reads in {secs:.2f} s: {n_reads / secs:.1f} "
          f"reads/s; the aligner's stages {aligner:.3f} s (share "
          f"{aligner / secs:.4f}: " + ", ".join(
              f"{k} {v:.3f}" for k, v in st.items() if not own(k))
          + "); the command's own " + ", ".join(
              f"{k} {v:.3f}" for k, v in cli.items())
          + f" s (share {sum(cli.values()) / secs:.4f}); the rest (start-up, "
          f"imports, set-up outside a stage) {rest:.3f} s [{card}]")
    done, before = [], (0, 0.0)
    for dump in dumps[:-1]:
        r = dump["counters"]["reads"]
        a = sum(v for k, v in _top_level(dump["stage_seconds"]).items()
                if not own(k))
        done.append((r - before[0], a - before[1]))
        before = (r, a)
    print(f"  {tag}: by batch, reads and the aligner's stages: " + "; ".join(
        f"{r} reads {a:.3f} s ({r / a:.1f} reads/s)" for r, a in done)
        + f" [{card}]")
    return dict(seconds=secs, reads_per_s=n_reads / secs, aligner_s=aligner,
                cli_s=cli, rest_s=rest, batches=done,
                counters=last["counters"])


def phase_cli(dev, index, codes, runs, card):
    """Phase 17: ``python -m bwamem_tpu_torch`` on the card, end to end."""
    import shutil

    import torch

    from bwamem_tpu_torch import BwaMemAligner
    from bwamem_tpu_torch.api import wire
    from bwamem_tpu_torch.engine import pair as pair_mod

    d = os.path.join(ROOT, "build", "smoke", "cli")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t0 = time.perf_counter()
    _write_cli_inputs(d, codes)
    n = 2 * CLI_PAIRS
    print(f"  inputs: ref.fa (4.6 Mbp), {CLI_PAIRS} pairs of 150 bp reads in "
          f"{time.perf_counter() - t0:.1f} s")
    secs, _ = _cli(d, ["index", "--sa-intv", "8", "ref.fa"], "index.out")
    print(f"  index --sa-intv 8 ref.fa: {secs:.2f} s (a fresh process, start-up "
          f"included) [{card}]")
    out = {"index_s": secs}
    img, pe = "ref.fa.img", ["ref.fa.img", "r1.fq", "r2.fq"]

    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import bwamem_tpu_torch.__main__"],
                   check=True, cwd=d, env={**os.environ, "PYTHONPATH": ROOT})
    print(f"  a fresh interpreter importing the command line (torch "
          f"included): {time.perf_counter() - t0:.2f} s [{card}]")

    def timed(tag, args, sam, env=None):
        secs, err = _cli(d, args, sam, dict(BWAMEM_TPU_METRICS="-",
                                            **(env or {})))
        dumps = [json.loads(ln) for ln in err.splitlines()
                 if ln.startswith("{")]
        out[tag] = _cli_shares(tag, secs, dumps, card)
        return out[tag]

    trace = os.path.join(d, "trace")
    fused = timed("fused (default)", ["mem", *pe], "fused.sam",
                  dict(BWAMEM_TPU_TRACE=trace))
    c = fused["counters"]
    print(f"  fused (default): counters " + ", ".join(
        f"{k} {v}" for k, v in sorted(c.items())))
    # the default -K: 10 Mbases a chunk, pairs of 300 bases
    batches = -(-CLI_PAIRS // -(-10_000_000 // 300))
    if (c.get("batches"), c.get("reads"),
            c.get("device_fused_pipeline_batches")) != (batches, n, batches):
        raise AssertionError(f"fused: the metrics dump counts {c}, not "
                             f"{batches} batches, {n} reads and {batches} "
                             "fused batches")
    seen = {}
    for f, counts in _trace_kernels(trace):
        print(f"  fused (default): trace {f}: " + ", ".join(
            f"{k} {v}" for k, v in sorted(counts.items())))
        for k, v in counts.items():
            seen[k] = seen.get(k, 0) + v
    missing = [k for k in FUSED_KERNELS if not seen.get(k)]
    if missing:
        raise AssertionError(f"fused: the CLI's traces lack {missing}")
    host = timed("host (--device cpu)", ["mem", *pe, "--device", "cpu"],
                 "host.sam")
    if host["counters"].get("device_seed_fused_batches"):
        raise AssertionError("the host route ran a device stage")
    staged = timed("staged", ["mem", *pe, "--no-device-pipeline",
                              "--device-stages", "seed,sa_lookup,chain"],
                   "staged.sam")
    waves = timed("waves (--no-device-pipeline)",
                  ["mem", *pe, "--no-device-pipeline"], "waves.sam")
    wc = waves["counters"]
    share = wc.get("device_extend_jobs", 0) / max(wc.get("extend_jobs", 0), 1)
    print(f"  waves: device_extend_jobs {wc.get('device_extend_jobs', 0)} of "
          f"{wc.get('extend_jobs', 0)} extension jobs (share {share:.4f}) in "
          f"{wc.get('device_extend_waves', 0)} of {wc.get('extend_waves', 0)} "
          "waves")
    if share < 0.5:
        raise AssertionError("waves: less than half the jobs on the card")
    for name in ("fused", "staged", "waves"):
        same = _same_file(os.path.join(d, f"{name}.sam"), os.path.join(d, "host.sam"))
        print(f"  {name}.sam equal to host.sam byte for byte: {same}")
        if not same:
            raise AssertionError(f"{name}: its SAM differs from the host route's")
    stats = ["--insert-mean", "350", "--insert-std", "35"]
    timed("fused, --insert-mean 350", ["mem", *pe, *stats], "base.sam")
    base = _sam_body(os.path.join(d, "base.sam"))
    # each must give the unsharded run's lines; then SE on the card and on
    # the host
    groups = [("-K 1000000", [[*pe, *stats, "-K", "1000000"]]),
              ("-p", [[img, "inter.fq", "-p", *stats]]),
              ("--shard 0/2 + 1/2",
               [[*pe, *stats, "--shard", f"{i}/2"] for i in (0, 1)]),
              ("se", [[img, "r1.fq"], [img, "r1.fq", "--device", "cpu"]])]
    sams = [[f"v{k}_{i}.sam" for i in range(len(g))]
            for k, (_, g) in enumerate(groups)]
    jobs = [(["mem", *a], sam) for (_, g), names in zip(groups, sams)
            for a, sam in zip(g, names)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        list(ex.map(lambda job: _cli(d, *job), jobs))
    print(f"  {len(jobs)} more runs, four at a time: "
          f"{time.perf_counter() - t0:.1f} s")
    for (tag, _), names in zip(groups[:-1], sams):
        got = _merged([os.path.join(d, f) for f in names])
        print(f"  {tag}: {len(got)} lines, equal to the unsharded run's "
              f"{len(base)}: {got == base}")
        if got != base:
            raise AssertionError(f"{tag}: lines differ from the unsharded "
                                 "run's")
    same = _same_file(*(os.path.join(d, f) for f in sams[-1]))
    print(f"  se: the card's SAM equal to the host route's byte for byte: "
          f"{same}")
    if not same:
        raise AssertionError("se: the SAM differs from the host route's")
    # align_seqs_packed in this process, on phase 4's PE batch: the default
    # aligner (the card, the fused path) against the host route
    calls = {"sam_pe": 0}
    sam_pe = pair_mod.sam_pe

    def counted(*a, **k):
        calls["sam_pe"] += 1
        return sam_pe(*a, **k)

    card_al, host_al = BwaMemAligner(index), _host_aligner(index)
    for a in (card_al, host_al):
        _pe_setup(a)
    buf = wire.encode_seqs(runs["pe"]["batch"])
    _reset_counts()
    pair_mod.sam_pe = counted
    try:
        got = card_al.align_seqs_packed(buf)
        torch.cuda.synchronize(dev)
    finally:
        pair_mod.sam_pe = sam_pe
    launched = _launched()
    want = host_al.align_seqs_packed(buf)
    print(f"  wire: align_seqs_packed on phase 4's {len(runs['pe']['batch'])} "
          f"PE reads, BwaMemAligner(index) (no device given) against the host "
          f"route: {len(got)} bytes, equal {got == want}; pair.sam_pe calls "
          f"{calls['sam_pe']}; launches " + ", ".join(
              f"{k} {v}" for k, v in launched.items() if v) + f" [{card}]")
    if got != want or calls["sam_pe"]:
        raise AssertionError("wire: the packed records differ or the tail "
                             "ran in Python")
    if any(launched.get(k, 0) <= 0 for k in FUSED_KERNELS):
        raise AssertionError("wire: the default aligner did not take the "
                             "fused path")
    return out  # phase 18 (e) reads d's inputs and host.sam, then removes d


MESH_ROUTES = (("fused", dict(device_pipeline=True)),
               ("staged", dict(device_pipeline=False, device_stages=ALL_STAGES)))
SHARDED_REPLACES = {"occ4_sharded": "bwamem_tpu/ops/fmindex_tpu.py:309",
                    "sa_lookup_sharded": "bwamem_tpu/ops/fmindex_tpu.py:67",
                    "collect_intv_sharded": "bwamem_tpu/ops/fmindex_tpu.py:67"}


def _reset_sharded():
    from bwamem_tpu_torch.ops import fmindex as fmops
    from bwamem_tpu_torch.ops import sa as saops
    from bwamem_tpu_torch.ops import seed as seedops

    _reset_counts()
    for name in ("occ4_sharded", "sa_lookup_sharded"):
        fmops.LAUNCHES[name] = 0
    seedops.LAUNCHES["collect_intv_sharded"] = 0
    for name in saops.LAUNCHES:
        saops.LAUNCHES[name] = 0


def _sharded_launched() -> dict:
    from bwamem_tpu_torch.ops import fmindex as fmops
    from bwamem_tpu_torch.ops import seed as seedops

    return {"occ4_sharded": fmops.LAUNCHES["occ4_sharded"],
            "sa_lookup_sharded": fmops.LAUNCHES["sa_lookup_sharded"],
            "collect_intv_sharded": seedops.LAUNCHES["collect_intv_sharded"]}


def _mesh_runs(dev, index, runs, card):
    """Phase 18 (a): phase 4's batches through BwaMemAligner(mesh=...) on
    the real cards and on a virtual (2, 2) mesh of cuda:0, fused and staged;
    every record equal to the host route's, each route's kernels launched."""
    from bwamem_tpu_torch import BwaMemAligner
    from bwamem_tpu_torch.parallel.mesh import make_mesh

    meshes = (("cards", make_mesh()),
              ("virtual (2, 2) of cuda:0", make_mesh(devices=[dev] * 4,
                                                     idx_shards=2)))
    rates = {}
    for mname, mesh in meshes:
        for rname, kw in MESH_ROUTES:
            for mode in ("pe", "se"):
                batch, ref = runs[mode]["batch"], runs[mode]["ref"]
                al = BwaMemAligner(index, mesh=mesh, **kw)
                if mode == "pe":
                    _pe_setup(al)
                al.align_seqs(runs[mode]["warm"])
                _reset_counts()
                got, secs = _timed(al, batch, dev)
                launched = _launched()
                need = (FUSED_KERNELS if rname == "fused"
                        else ROUTE_KERNELS["staged"] + ("ksw_extend",))
                missing = [k for k in need if not launched[k]]
                ok = _equal(got, ref)
                rates[(mname, rname, mode)] = len(batch) / secs
                print(f"  mesh {mname} {mesh.shape}, {rname} {mode}: "
                      f"{len(batch)} reads in {secs:.3f} s, "
                      f"{len(batch) / secs:.1f} reads/s [{card}]; records "
                      f"equal to the host route's {ok}/{len(batch)}; "
                      f"launches {dict((k, launched[k]) for k in need)}")
                if ok != len(batch) or missing:
                    raise AssertionError(f"mesh {mname} {rname} {mode}: "
                                         f"records {ok}/{len(batch)}, kernels "
                                         f"not launched {missing}")
    return rates


def _shard_timing(dev, fm, reads, shard_counts=(2, 4)):
    """Phase 18 (b): the sharded kernels (occ4 on 2^20 random rows, the SA
    walk on the batch's SA rows from a cold L2, collect_intv on the batch)
    on tables split over 2 and 4 shards on cuda:0, against the unsharded
    kernels in the same run (bit-equal) and their plain versions on a
    sample (exact); returns per sharded kernel its entry's numbers."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.state import device_fm
    from bwamem_tpu_torch.ops import fmindex as fmops
    from bwamem_tpu_torch.ops import seed as seedops

    dfm = device_fm(fm, dev)
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    params = seedops.SeedParams.from_opt(MemOptions())
    q, ql = seedops.pad_reads(reads, dev)
    work = torch.zeros((len(reads), 5), dtype=torch.int32, device=dev)
    base = seedops.seed_sa(dfm, q, ql, params, work=work)
    rows = base.ks
    calls = int(work[:, 2].sum())
    k = torch.from_numpy(np.random.default_rng(SEED + 18).integers(
        -1, fm.seq_len + 1, 1 << 20)).to(dev)
    B, M = len(reads), seedops.M_SLOTS

    def seed_out():
        return (torch.zeros((B, M, 5), dtype=torch.int64, device=dev),
                *(torch.zeros(B, dtype=torch.int32, device=dev) for _ in range(2)),
                torch.zeros(B, dtype=torch.int64, device=dev))

    def kernels(tab):
        occ = torch.empty((k.numel(), 4), dtype=torch.int32, device=dev)
        pos = torch.empty_like(rows)
        so = seed_out()
        return dict(
            occ4=(lambda: fmops.occ4_launch(tab, k, occ, flags), occ),
            sa_lookup=(lambda: fmops.sa_lookup_launch(tab, rows, pos, flags), pos),
            collect_intv=(lambda: seedops.collect_intv_launch(
                tab, q, ql, params, M, seedops.K_MAX, *so, flags), so[0]))

    timed = {}
    ref = kernels(dfm)
    for name, (fn, _) in ref.items():
        timer = _cold_ms if name == "sa_lookup" else _event_ms
        timed[(name, 1)] = timer(fn, 7, dev)
    steps = _walk_lengths(dfm, rows.clone())
    sample = list(range(0, B, max(1, B // SEED_SAMPLE)))[:SEED_SAMPLE]
    qs, qls = q[sample], ql[sample]
    res = {}
    for n in shard_counts:
        sfm = fmops.ShardedFMIndex.from_host(fm, [dev] * n)
        got = kernels(sfm)
        for name, (fn, _) in got.items():
            timer = _cold_ms if name == "sa_lookup" else _event_ms
            timed[(name, n)] = timer(fn, 7, dev)
        for name in got:
            if not torch.equal(got[name][1], ref[name][1]):
                raise AssertionError(f"{n}-shard {name} differs from the "
                                     "unsharded kernel")
        # the sharded kernels against their plain versions (the owner
        # gathers) on the same inputs: every occ4 row and SA row, and the
        # sample's reads for collect_intv
        kp = k[: 1 << 16]
        err = {"occ4": _diff(fmops.occ4_cuda(sfm, kp), fmops.occ4_torch(sfm, kp)),
               "sa_lookup": _diff(fmops.sa_lookup_cuda(sfm, rows),
                                  fmops.sa_lookup_torch(sfm, rows))}
        kern = seedops.collect_intv_cuda(sfm, qs, qls, params)
        plain, plain_ms = _once_ms(lambda: seedops.collect_intv_torch(
            sfm, qs, qls, params), dev)
        err["collect_intv"] = max(_diff(a, b) for a, b in zip(kern, plain))
        plain_t = {"occ4": _event_ms(lambda: fmops.occ4_torch(sfm, k), 2, dev),
                   "sa_lookup": _event_ms(lambda: fmops.sa_lookup_torch(sfm, rows),
                                          1, dev),
                   "collect_intv": plain_ms}
        if int(flags.item()) or any(err.values()):
            raise AssertionError(f"{n} shards: flags {int(flags.item())}, "
                                 f"max|kernel-plain| {err}")
        print(f"  {n} shards of the 64 Mbp tables on cuda:0: occ4 on 2^20 rows "
              f"{timed[('occ4', n)]:.4f} ms (unsharded {timed[('occ4', 1)]:.4f}), "
              f"SA walk of {rows.numel()} rows from a cold L2 "
              f"{timed[('sa_lookup', n)]:.4f} ms (unsharded "
              f"{timed[('sa_lookup', 1)]:.4f}), collect_intv on {B} reads "
              f"{timed[('collect_intv', n)]:.4f} ms (unsharded "
              f"{timed[('collect_intv', 1)]:.4f}); bit-equal to the unsharded "
              f"kernels; max|kernel-plain| {err} (plain: occ4 "
              f"{plain_t['occ4']:.2f} ms, walk {plain_t['sa_lookup']:.2f} ms, "
              f"collect_intv on {len(sample)} reads {plain_ms:.2f} ms)")
        if n == shard_counts[0]:
            n_steps = float(steps.sum())
            bounds = {
                "occ4": _line_bound(dfm, 24 * k.numel(), k.numel()),
                "sa_lookup": _line_bound(dfm, 16 * rows.numel()
                                         + 8 * rows.numel(), n_steps,
                                         10 * n_steps),
                "collect_intv": _line_bound(
                    dfm, q.numel() + 20 * B + 40 * base.flat.shape[0],
                    2 * calls, 20 * calls)}
            for name in got:
                res[f"{name}_sharded"] = dict(
                    shards=n, ms=timed[(name, n)], unsharded_ms=timed[(name, 1)],
                    plain_ms=plain_t[name], err=err[name],
                    ms_by="cold events" if name == "sa_lookup" else "events",
                    **bounds[name])
        for name in got:
            res[f"{name}_sharded"][f"ms_{n}_shards"] = timed[(name, n)]
        del sfm
    return res


def _dist_child(spec: str) -> int:
    """One process of phase 18 (c): joins the gloo group, aligns its half
    of phase 4's PE batch on cuda:0, gathers and merges every process's
    records and prints their digest."""
    import hashlib

    import numpy as np
    import torch

    from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex
    from bwamem_tpu_torch.parallel import distributed as dist
    from bwamem_tpu_torch.utils.synth import simulate_pairs

    spec = json.loads(spec)
    pid = dist.init_distributed(spec["coord"], 2, spec["pid"])[0]
    codes, img, _ = _synthetic_index(ECOLI_LEN)
    index = BwaMemIndex(img)
    rng = np.random.default_rng(SEED + 1)  # phase_main_path's reads
    warm = simulate_pairs(codes, rng, 8)
    reads = simulate_pairs(codes, rng, N_PAIRS)
    al = BwaMemAligner(index, device=torch.device("cuda", 0))
    _pe_setup(al)
    al.align_seqs(warm)
    lo, recs = dist.align_shard(al, reads, pid, 2)
    recs = [[vars(a) for a in r] for r in recs]
    merged = dist.merge_shards(dist.gather_shards(lo, recs), len(reads))
    dist.shutdown()
    index.close()
    print(json.dumps(dict(pid=pid, lo=lo, n=len(recs), digest=hashlib.sha256(
        json.dumps(merged).encode()).hexdigest())))
    return 0


def _dist_run(runs):
    """Phase 18 (c): two processes joined by torch.distributed (gloo,
    localhost), each aligning its half of phase 4's PE batch on cuda:0; the
    merge must equal one process's records."""
    import hashlib
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker",
         json.dumps(dict(coord=f"127.0.0.1:{port}", pid=i))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"a distributed process exited "
                                     f"{p.returncode}: {e[-3000:]}")
            outs.append(json.loads(o.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    want = hashlib.sha256(json.dumps(
        [[vars(a) for a in r] for r in runs["pe"]["ref"]]).encode()).hexdigest()
    ok = all(o["digest"] == want for o in outs)
    print(f"  2 processes (gloo on localhost, both on cuda:0): shards at "
          f"{[o['lo'] for o in outs]} of {[o['n'] for o in outs]} reads; the "
          f"merged records equal one process's (the host route's): {ok}; "
          f"{time.perf_counter() - t0:.1f} s with start-up")
    if not ok:
        raise AssertionError("the distributed merge differs from one process")


def _device_sa(dev, codes, card):
    """Phase 18 (d): D11, the device SA build, on the 4.6 Mbp and 64 Mbp
    genomes against the host SA-IS, and the 4.6 Mbp index built with
    BWAMEM_TPU_DEVICE_SA=1 against the host-built image."""
    import tempfile

    import numpy as np
    import torch

    from bwamem_tpu_torch.index import image, native_sais
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.ops import sa as saops
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig

    codes20, _, _ = _synthetic_index(CHR20_LEN)
    res = {}
    for tag, c in (("4.6 Mbp", codes), ("64 Mbp", codes20)):
        rounds = saops.LAUNCHES["sort_rounds"]
        got, ms = _once_ms(lambda: saops.suffix_array_device(c, dev), dev)
        rounds = saops.LAUNCHES["sort_rounds"] - rounds
        t0 = time.perf_counter()
        want = native_sais.suffix_array(c)
        host_ms = (time.perf_counter() - t0) * 1e3
        err = int(np.abs(got - want).max()) if len(got) == len(want) else -1
        n = len(c) + 1
        keys = torch.randint(0, 1 << 62, (n,), device=dev)
        lib_ms = _event_ms(lambda: torch.sort(keys, stable=True), 3, dev)
        bound = _bound(len(c) + 8 * n, 0)
        bound["library_ms"] = lib_ms
        print(f"  {tag}: device SA of {n} suffixes in {ms / 1e3:.3f} s "
              f"({rounds} sort rounds), host SA-IS {host_ms / 1e3:.3f} s; "
              f"equal byte for byte {err == 0}; one torch.sort of {n} int64 "
              f"keys {lib_ms:.3f} ms [{card}]")
        if err:
            raise AssertionError(f"{tag}: the device SA differs from SA-IS")
        res[tag] = dict(ms=ms, host_ms=host_ms, rounds=rounds, err=err,
                        bound=bound)
    del codes20
    _reset_sharded()
    os.environ["BWAMEM_TPU_DEVICE_SA"] = "1"
    try:
        t0 = time.perf_counter()
        idx = build_index(Fasta([FastaContig("chr", "", codes)]), sa_intv=8)
        secs = time.perf_counter() - t0
    finally:
        del os.environ["BWAMEM_TPU_DEVICE_SA"]
    launches = dict(saops.LAUNCHES)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "dev.img")
        image.write_image(path, idx)
        same = _same_file(path, _synthetic_index(ECOLI_LEN)[1])
    print(f"  4.6 Mbp index built with BWAMEM_TPU_DEVICE_SA=1 in {secs:.2f} s "
          f"({launches}); its image equal to the host-built one byte for "
          f"byte: {same}")
    if not same or not launches["suffix_array"]:
        raise AssertionError("the device-SA index differs from the host one")
    res["launches"] = launches["sort_rounds"]
    return res


def _cli_devices(card):
    """Phase 18 (e): ``mem --devices 1`` on phase 17's FASTQ equal to its
    ``--device cpu`` SAM; ``--devices 2`` refused on a one-card machine.
    Removes phase 17's directory."""
    import shutil

    import torch

    d = os.path.join(ROOT, "build", "smoke", "cli")
    pe = ["mem", "ref.fa.img", "r1.fq", "r2.fq"]
    secs, _ = _cli(d, [*pe, "--devices", "1"], "devices1.sam")
    same = _same_file(os.path.join(d, "devices1.sam"), os.path.join(d, "host.sam"))
    print(f"  mem --devices 1 on {CLI_PAIRS} pairs: {secs:.2f} s [{card}]; "
          f"SAM equal to --device cpu's byte for byte: {same}")
    if not same:
        raise AssertionError("mem --devices 1 differs from the host route")
    n = torch.cuda.device_count()
    res = subprocess.run([sys.executable, "-m", "bwamem_tpu_torch", *pe,
                          "--devices", str(n + 1)], cwd=d, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": ROOT},
                         timeout=300)
    print(f"  mem --devices {n + 1} on {n} card(s): exit {res.returncode}, "
          f"{res.stderr.strip().splitlines()[-1] if res.stderr else ''}")
    if res.returncode != 2 or res.stdout:
        raise AssertionError(f"--devices {n + 1} was not refused")
    shutil.rmtree(d, ignore_errors=True)


def phase_devices(dev, index, codes, runs, card):
    """Phase 18: several devices.  (a) the mesh aligner, (b) the dry run on
    four virtual devices and the sharded kernels timed, (c) two processes
    joined by torch.distributed, (d) the device SA build, (e) mem
    --devices."""
    from bwamem_tpu_torch import BwaMemIndex
    from bwamem_tpu_torch.parallel.dryrun import dryrun_multichip
    from bwamem_tpu_torch.utils.synth import simulate_pairs

    import numpy as np

    t0 = time.perf_counter()
    rates = _mesh_runs(dev, index, runs, card)
    t1 = time.perf_counter()
    _reset_sharded()
    out = dryrun_multichip([dev] * 4, shard_counts=(2, 4))
    launched = _sharded_launched()
    big = out.pop("big")
    print(f"  dryrun_multichip on 4 virtual devices (cuda:0): mesh "
          f"{out['mesh']}, {out['reads']} PE reads, {out['records']} records "
          f"equal to the single-device route's; the stage stack on "
          f"{out['full_stack']['mesh']} ({out['full_stack']['records']} records "
          f"equal); sharded occ4 = host oracle on {out['occ_queries']} rows; "
          f"{big['seq_len']} rows (> 2^31): seed+SA of {big['reads']} reads "
          f"({big['flagged']} flagged by M), {big['intervals']} intervals and "
          f"{big['rbegs']} positions = host oracle; bit-equal on "
          f"{big['shard_counts']} shards; sharded launches {launched}; "
          f"{time.perf_counter() - t1:.1f} s")
    missing = [k for k, v in launched.items() if not v]
    if missing:
        raise AssertionError(f"the dry run did not launch {missing}")
    del big
    t2 = time.perf_counter()
    codes20, img20, _ = _synthetic_index(CHR20_LEN)
    idx20 = BwaMemIndex(img20)
    rng = np.random.default_rng(SEED + 1)  # phase 8's batch
    simulate_pairs(codes20, rng, 8)
    reads20 = simulate_pairs(codes20, rng, CHR20_PAIRS)
    from bwamem_tpu_torch.utils.encoding import seq_to_codes_batch

    sharded = _shard_timing(dev, idx20._require().fm, seq_to_codes_batch(reads20))
    idx20.close()
    del codes20
    for name in sharded:
        sharded[name]["launches"] = launched[name]
    t3 = time.perf_counter()
    _dist_run(runs)
    t4 = time.perf_counter()
    sa = _device_sa(dev, codes, card)
    t5 = time.perf_counter()
    _cli_devices(card)
    print(f"  phase 18 seconds: mesh {t1 - t0:.1f}, dry run {t2 - t1:.1f}, "
          f"sharded timing {t3 - t2:.1f}, distributed {t4 - t3:.1f}, device "
          f"SA {t5 - t4:.1f}, CLI {time.perf_counter() - t5:.1f}")
    return dict(rates=rates, sharded=sharded, sa=sa)


MIDLEN_PAIRS = 3000
MIDLEN_LEN = 300
MIDLEN_ISIZE = 700
# the reads of phase 19's batch the plain chain-to-region version runs on
# (a heavy 300-base read takes it seconds on the card); every other plain
# version runs on the whole batch
MIDLEN_PLAIN_SAMPLE = 64
MIDLEN_ROUTES = (("fused", dict(device_pipeline=True)),
                 ("staged", dict(WAVES, device_stages=ALL_STAGES)),
                 ("default", WAVES))


def _midlen_reads(codes):
    """bench.py's "midlen" reads on the 4.6 Mbp genome, drawn as
    benchmarks/bench.py draws them: 8 warm-up pairs, then 3,000 pairs of
    300 bases, insert 700."""
    import numpy as np

    from bwamem_tpu_torch.utils.synth import simulate_pairs

    rng = np.random.default_rng(SEED + 1)
    kw = dict(read_len=MIDLEN_LEN, isize_mean=MIDLEN_ISIZE)
    return (simulate_pairs(codes, rng, 8, **kw),
            simulate_pairs(codes, rng, MIDLEN_PAIRS, **kw))


def _midlen_setup(aligner):
    """Pairs with the bench's fixed statistics, insert 700 +- 70."""
    from bwamem_tpu_torch import BwaMemPairEndStats

    aligner.align_pairs()
    aligner.set_proper_pair_end_stats(
        BwaMemPairEndStats.of(MIDLEN_ISIZE, MIDLEN_ISIZE // 10))


def _midlen_kernels(dev, index, batch, wave):
    """Phase 19's kernel checks on the midlen batch, each kernel against its
    plain version on the card: collect_intv (with its work table) and
    sample_ks by ``seed_sa``, the SA walk of their rows, chain and
    chain_emit on the batch's device seed table, the prep kernel's windows
    and seed order against ``chain_windows``, chain2aln on
    MIDLEN_PLAIN_SAMPLE reads (and its sample's regions against the whole
    batch's), and the wave kernel on the default route's largest ``wave``.
    Returns per kernel its largest difference, the K slots the reads
    needed, the chain-to-region work and the plain versions' sizes."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine import pipeline
    from bwamem_tpu_torch.engine.exec_ctx import ExecConfig
    from bwamem_tpu_torch.engine.pipeline_device import ref_t_cap
    from bwamem_tpu_torch.engine.state import (device_contigs, device_fm,
                                               device_ref, device_scoring)
    from bwamem_tpu_torch.ops import chain as co
    from bwamem_tpu_torch.ops import extend as ext
    from bwamem_tpu_torch.ops import fmindex as fmops
    from bwamem_tpu_torch.ops import pipeline_fused as fo
    from bwamem_tpu_torch.ops import seed as so
    from bwamem_tpu_torch.utils.encoding import seq_to_codes_batch

    opt = MemOptions()
    eng = index._require()
    reads = seq_to_codes_batch(batch)
    B = len(reads)
    err, plain_ms = {}, {}
    # seeding and the walks of its SA rows
    dfm = device_fm(eng.fm, dev)
    params = so.SeedParams.from_opt(opt)
    qseq, qlen = so.pad_reads(reads, dev)
    work = torch.zeros((B, 5), dtype=torch.int32, device=dev)
    pwork = torch.zeros_like(work)
    got = so.seed_sa(dfm, qseq, qlen, params, K=so.K_MAX, work=work)
    plain, plain_ms["collect_intv"] = _once_ms(lambda: so.seed_sa_torch(
        dfm, qseq, qlen, params, K=so.K_MAX, work=pwork), dev)
    iv, piv, ok = got.intervals, plain.intervals, ~got.intervals.ovf
    err["collect_intv"] = max(_diff(iv.ovf, piv.ovf), _diff(iv.n[ok], piv.n[ok]),
                              _diff(iv.rows[ok], piv.rows[ok]),
                              _diff(iv.nks, piv.nks), _diff(work, pwork))
    err["sample_ks"] = max(_diff(got.flat, plain.flat), _diff(got.ks, plain.ks))
    rbegs, plain_ms["sa_lookup"] = _once_ms(
        lambda: fmops.sa_lookup_torch(dfm, plain.ks), dev)
    err["sa_lookup"] = _diff(fmops.sa_lookup(dfm, got.ks), rbegs)
    w = work.cpu().numpy()
    k_slots = dict(k_needed_mean=float(w[:, 4].mean()),
                   k_needed_max=int(w[:, 4].max()),
                   k_flags=int((w[:, 3] == 1).sum()),
                   m_flags=int((w[:, 3] == 2).sum()))
    # chaining, on the table the aligner's chain stage gets
    qlens = np.asarray([len(r) for r in reads], dtype=np.int32)
    tab, _, _, _ = pipeline._device_table(opt, eng, reads, qlens, ExecConfig(
        device=dev, device_seed=True, device_sa_lookup=True, device_chain=True))
    ctg = device_contigs(eng.idx.bns, dev)
    cparams = co.ChainParams.from_opt(opt)
    chains = co.chain_cuda(ctg, tab, cparams)
    pchains, plain_ms["chain"] = _once_ms(
        lambda: co.chain_torch(ctg, tab, cparams), dev)
    err["chain"] = err["chain_emit"] = max(
        _diff(g, p) for g, p in zip(chains, pchains))
    # chain to regions: the fused path's operands
    ref = device_ref(eng.idx, dev)
    run = ~chains.ovf
    eparams = fo.ExtendParams.from_opt(opt)
    mat = device_scoring(opt, dev).mat
    t_cap = ref_t_cap(opt, int(qlens.max()))
    whole = fo.chain2aln_cuda(ctg, ref, chains, qseq, qlen, run, eparams, mat,
                              t_cap)
    chains_p, lay, _, ql, _ = fo.prepare(ctg, ref, chains, qseq, qlen, run)
    rmax = torch.empty((chains_p.chain_rows.shape[0], 2), dtype=torch.int64,
                       device=dev)
    srt = torch.empty(chains_p.seed_rows.shape[0], dtype=torch.int32, device=dev)
    flags = torch.zeros(1, dtype=torch.int32, device=dev)
    fo.chain2aln_prep_launch(ctg, chains_p, lay, ql, eparams, rmax, srt, flags)
    fo.raise_flags(int(flags.item()))
    err["chain2aln_prep"] = _prep_err(ctg, chains_p, lay, ql, eparams, rmax, srt)
    rng = np.random.default_rng(SEED + 19)
    pick = sorted(rng.choice(B, min(MIDLEN_PLAIN_SAMPLE, B), replace=False).tolist())
    idx = torch.tensor(pick, device=dev)
    sub = (ctg, ref, _chains_of(chains, idx), qseq[idx], qlen[idx], run[idx],
           eparams, mat, t_cap)
    part = fo.chain2aln_cuda(*sub)
    ppart, plain_ms["chain2aln"] = _once_ms(lambda: fo.chain2aln_torch(*sub),
                                            dev)
    every = _region_rows(whole)
    err["chain2aln"] = max(
        max(_diff(getattr(part, k), getattr(ppart, k))
            for k in ("reg_c", "reg_i", "nregs", "seed_off", "work")),
        sum(a != every[i] for a, i in zip(_region_rows(part), pick)))
    wk = whole.work.cpu().numpy()
    c2a = {k: int(wk[:, col].sum()) for k, col in (
        ("cells", fo.W_CELLS), ("rows", fo.W_ROWS), ("tasks", fo.W_TASKS),
        ("jobs", fo.W_JOBS))}
    # the wave kernel on the default route's largest wave
    sc = device_scoring(opt, dev)
    args = (*_wave_tensors(wave, dev), sc.mat, sc.o_del, sc.e_del, sc.o_ins,
            sc.e_ins, sc.zdrop, sc.max_sc)
    pw, plain_ms["ksw_extend"] = _once_ms(lambda: ext.ksw_extend_torch(*args),
                                          dev)
    err["ksw_extend"] = _max_err(ext.ksw_extend_cuda(*args), pw)
    print(f"  midlen kernels against their plain versions on the card "
          f"(max|kernel-plain|): " + ", ".join(f"{k} {v}" for k, v in err.items())
          + f"; plain versions on {B} reads (chain2aln on {len(pick)}), ms "
          "once: " + ", ".join(f"{k} {v:.1f}" for k, v in plain_ms.items()))
    print(f"  midlen: K slots needed mean {k_slots['k_needed_mean']:.2f}, max "
          f"{k_slots['k_needed_max']} (flagged at K = {so.K_MAX}: "
          f"{k_slots['k_flags']}, at M = {so.M_SLOTS}: {k_slots['m_flags']}); "
          f"chain2aln {c2a['cells']} band cells, {c2a['rows']} DP rows, "
          f"{c2a['tasks']} tasks, {c2a['jobs']} jobs")
    if any(err.values()):
        raise AssertionError(f"midlen: a kernel disagrees with its plain "
                             f"version: {err}")
    return dict(err=err, plain_ms=plain_ms, k_slots=k_slots, work=c2a,
                plain_reads=dict(chain2aln=len(pick), others=B))


def phase_midlen(dev, index, codes, card):
    """Phase 19: bench.py's "midlen" configuration (6,000 reads of 300
    bases in pairs, insert 700, on the ecoli genome of phase 4) through the
    fused, staged and default routes, each record-equal to the host
    whole-batch route's; the fused share by cause; reads/s a route; each
    path kernel's device time over a profiled batch (the fused route's and,
    for the wave kernel, the default route's, in a fresh process); and
    every kernel of the path against its plain version on this batch."""
    from bwamem_tpu_torch import BwaMemAligner
    from bwamem_tpu_torch.engine.extend_batch import STATS
    from bwamem_tpu_torch.engine.pipeline import SA_STATS
    from bwamem_tpu_torch.ops import extend as ext

    warm, batch = _midlen_reads(codes)
    n = len(batch)
    host = _host_aligner(index)
    _midlen_setup(host)
    host.align_seqs(warm)
    ref, t_host = _timed(host, batch, dev)
    routes = {"host": dict(seconds=t_host, reads_per_s=n / t_host,
                           records_equal=n)}
    res_of = {}
    for route, kw in MIDLEN_ROUTES:
        tag = f"midlen {route}"
        port = BwaMemAligner(index, device=dev, **kw)
        _midlen_setup(port)
        port.align_seqs(warm)
        scalar0 = ext.SCALAR_JOBS
        res = _port_run(tag, port, batch, ref, t_host, dev,
                        fused=route == "fused")
        res["scalar_jobs"] = ext.SCALAR_JOBS - scalar0
        if route == "fused":
            res["share"] = _check_fused(tag, res, batch)
        else:
            wave = STATS.largest_wave
            res["wave"] = wave
            res["device_scalar_jobs"] = STATS.device_scalar_jobs
            if route == "staged":
                _check_seeded(tag, res, batch)
                _check_chained(tag, res, batch)
                if res["sa_launches"] <= 0 or SA_STATS.host_sa_rows:
                    raise AssertionError(f"{tag}: SA walks did not all run on "
                                         "the card")
            print(f"  {tag}: largest wave {len(wave[0])} jobs, Q "
                  f"{max(len(q) for q, _ in wave[0])}, T "
                  f"{max(len(t) for _, t in wave[0])}; jobs on the wave "
                  f"kernel's scalar path {res['scalar_jobs']} "
                  f"(STATS.device_scalar_jobs {res['device_scalar_jobs']})")
        routes[route] = dict(seconds=res["seconds"],
                             reads_per_s=n / res["seconds"], records_equal=n,
                             stages=res["stages"])
        print(f"  {tag}: {n / res['seconds']:.1f} reads/s ({res['seconds']:.3f} "
              f"s; the host route {n / t_host:.1f}) [{card}]")
        res_of[route] = res
    fused, default = res_of["fused"], res_of["default"]
    (busy, wall, per), (_, _, per_waves) = _fresh_traced_batches("midlen", [
        dict(tag="midlen fused", route=dict(device_pipeline=True), launches={
            **fused["seed_launches"], **fused["chain_launches"],
            **fused["fused_launches"], "sa_lookup": fused["sa_launches"]}),
        dict(tag="midlen default", route=WAVES,
             launches={"ksw_extend": default["launches"]})])
    per["ksw_extend"] = per_waves["ksw_extend"]
    print(f"  midlen fused and default: again under torch.profiler, in a fresh "
          f"process: the fused batch's card busy {busy:.4f} s of {wall:.2f} s, "
          f"idle share {1 - busy / wall:.4f}; kernels summed over the batch "
          f"(ksw_extend over the default route's waves): " + _per_kernel(per))
    checks = _midlen_kernels(dev, index, batch, default["wave"])
    kernels = {}
    for name, e in checks["err"].items():
        ms, nl = per.get(name, (0.0, 0))
        kernels[name] = dict(max_abs_err=e, batch_ms=ms, batch_launches=nl,
                             batch_ms_by="profiler")
        if nl <= 0:
            raise AssertionError(f"midlen: {name} was not launched")
    fs, ss = fused["fused_stats"], fused["seed_stats"]
    cs = res_of["staged"]["chain_stats"]
    wave = default["wave"]
    out = dict(
        card=card, pairs=MIDLEN_PAIRS, reads=n, read_len=MIDLEN_LEN,
        insert=MIDLEN_ISIZE, routes=routes, fused_share=fused["share"],
        fused_stats={k: fs[k] for k in (
            "device_reads", "host_reads", "host_seeded", "c_overflows",
            "fcs_reads", "long_reads", "tasks", "pruned", "jobs",
            "ref_s_overflows", "ref_c_overflows", "ref_r_overflows",
            "ref_t_overflows")},
        seed_stats={k: ss[k] for k in (
            "device_reads", "host_reads", "k_overflows", "m_overflows",
            "ref_k_overflows")},
        k_slots=checks["k_slots"],
        chain_stats={k: cs[k] for k in (
            "device_reads", "host_reads", "c_overflows", "ref_s_overflows",
            "ref_c_overflows")},
        largest_wave=dict(jobs=len(wave[0]),
                          Q=max(len(q) for q, _ in wave[0]),
                          T=max(len(t) for _, t in wave[0])),
        scalar_jobs=default["scalar_jobs"], chain2aln_work=checks["work"],
        idle_share=1 - busy / wall, kernels=kernels,
        plain_ms=checks["plain_ms"], plain_reads=checks["plain_reads"])
    print(f"  midlen: fused share {fused['share']:.4f}; reads that left the "
          f"fused path: seeded on the host {fs['host_seeded']} (K "
          f"{ss['k_overflows']}, M {ss['m_overflows']}), C "
          f"{fs['c_overflows']}, fcs {fs['fcs_reads']}, long "
          f"{fs['long_reads']} [{card}]")
    print(json.dumps({"midlen": out}))
    return out


GRCH38_ROWS = 6_200_000_000  # GRCh38's 2 l_pac: 48,437,500 blocks of 128
GRCH38_SA_INTV = 32
GRCH38_L_PAC = 3_100_000_000  # one strand of GRCh38
GRCH38_SEED_READS = 32
GRCH38_RANK_READS = 512
GRCH38_CHAIN_READS = 256
GRCH38_PLAIN_READS = 64
GRCH38_ORACLE_READS = 16
DOMAIN = 1 << 32  # what phase 20's rows and positions must reach


def _grch38_seeding(dev, card):
    """Phase 20 (a): seeding and SA walks on a synthetic_fmindex of
    GRCh38's 6.2e9 rows, sa_intv 32, against the host oracle; the rank
    kernels and the walk timed warm and cold beside their bounds."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.state import device_fm
    from bwamem_tpu_torch.ops import fmindex as fmops
    from bwamem_tpu_torch.parallel.dryrun import _seed_device, _seed_host
    from bwamem_tpu_torch.utils.synth import synthetic_fmindex

    rng = np.random.default_rng(SEED + 38)
    t0 = time.perf_counter()
    fm = synthetic_fmindex(GRCH38_ROWS, rng, sa_intv=GRCH38_SA_INTV)
    t1 = time.perf_counter()
    dfm = device_fm(fm, dev)
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    nbytes = dict(lines=dfm.lines.numel() * 4, sa=dfm.sa.numel() * 8)
    print(f"  synthetic FM index of {GRCH38_ROWS} rows (sa_intv "
          f"{GRCH38_SA_INTV}) on the host in {t1 - t0:.1f} s; on the card in "
          f"{t2 - t1:.1f} s: {dfm.lines.shape[0]} lines ({nbytes['lines'] / 1e9:.3f} "
          f"GB), {dfm.sa.numel()} SA samples ({nbytes['sa'] / 1e9:.3f} GB) "
          f"[{card}]")
    # seed+SA on the card against the host oracle (the dry run's step 3)
    opt = MemOptions(min_seed_len=14)
    reads = [rng.integers(0, 4, 64).astype(np.uint8)
             for _ in range(GRCH38_SEED_READS)]
    reads.append(np.full(24, 4, dtype=np.uint8))  # all-N edge
    got, ovf, raw = _seed_device(opt, dfm, reads)
    want = _seed_host(opt, fm, reads)
    n_intv = n_rb = bad = checked = 0
    top_bound = top_pos = -1
    for i, (g, w) in enumerate(zip(got, want)):
        if ovf[i]:  # past the M-slot budget: the aligner seeds it on the host
            continue
        checked += 1
        bad += ([x for x, _ in g] != [x for x, _ in w] or not all(
            np.array_equal(a, b) for (_, a), (_, b) in zip(g, w)))
        n_intv += len(w)
        n_rb += sum(len(b) for _, b in w)
        for (x0, x1, s, _, _), pos in g:
            top_bound = max(top_bound, x0 + s - 1, x1 + s - 1)
            if len(pos):
                top_pos = max(top_pos, int(pos.max()))
    print(f"  seed+SA on the card, {len(reads)} reads of 64 bases (min_seed_len "
          f"14), {checked} not flagged by M: {n_intv} intervals, {n_rb} SA "
          f"positions; reads differing from the host oracle {bad}; the largest "
          f"interval bound {top_bound} (2^32 = {DOMAIN}), the largest SA "
          f"position {top_pos}")
    if bad or not n_rb:
        raise AssertionError("GRCh38 domain: seed+SA differs from the host oracle")
    if top_bound < DOMAIN or top_pos < DOMAIN:
        raise AssertionError("GRCh38 domain: no interval bound or SA position "
                             "reached 2^32")
    # the SA walk of those rows: warm (repeated) and cold, plain, bound
    k = raw[5]
    out = torch.empty_like(k)
    flags = torch.zeros(1, dtype=torch.int32, device=dev)

    def walk():
        fmops.sa_lookup_launch(dfm, k, out, flags)

    # CUDA events around a launch of a few tens of µs time the host's call,
    # and this late in the run the profiler's traces have come back empty:
    # each call is timed by events queued behind a busy-wait of the card
    walk_ms = _queued_ms(walk, 20, dev)
    walk_cold = _queued_ms(walk, 11, dev, cold=True)
    plain, walk_plain = _once_ms(lambda: fmops.sa_lookup_torch(dfm, k), dev)
    fmops._raise_flags("sa_lookup", flags)
    e_walk = max(_diff(out, plain), _diff(out, raw[6]))
    steps = _walk_lengths(dfm, k)
    mean, longest = float(steps.sum()) / max(k.numel(), 1), int(steps.max())
    walk_bound = _line_bound(dfm, 16 * k.numel() + 8 * k.numel(),
                             mean * k.numel(), 10 * mean * k.numel())
    print(f"  SA walk of those {k.numel()} rows ({mean:.3f} LF steps a walk, "
          f"longest {longest}): kernel {walk_ms:.4f} ms warm, {walk_cold:.4f} "
          f"ms cold (queued events), plain PyTorch {walk_plain:.4f} ms (once); "
          f"bound "
          f"{walk_bound['bound_ms']:.6f} ms ({walk_bound['bound_by']}); "
          f"max|kernel-plain| {e_walk} [{card}]")
    if e_walk:
        raise AssertionError("GRCh38 domain: the SA walk disagrees")
    # occ4 and bwt_extend on seeding-shaped work, each step against the
    # host FMIndex (phase 8's drive: random reads die after ~16 bases here)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    rank_reads = [bases[rng.integers(0, 4, 150)].tobytes()
                  for _ in range(GRCH38_RANK_READS)]
    launches, err, _ = _rank_drive(dev, fm, rank_reads)
    # then timed warm and cold: occ4 on 2^20 random rows, bwt_extend on
    # 2^16 bi-intervals six forward steps into random reads
    rows = rng.integers(-1, fm.seq_len + 1, 1 << 20)
    codes = rng.integers(0, 4, (1 << 16, 7))
    x0, x1, sz = fm.set_intv(codes[:, 0])
    ar = np.arange(len(codes))
    for i in range(1, 7):
        e0, e1, es = fm.extend(x0, x1, sz, False)
        j = 3 - codes[:, i]
        x0, x1, sz = e0[ar, j], e1[ar, j], es[ar, j]
    q = torch.from_numpy(rows).to(dev)
    cnt = torch.empty((len(q), 4), dtype=torch.int32, device=dev)
    xs = [torch.from_numpy(np.asarray(a, np.int64)).to(dev) for a in (x0, x1, sz)]
    outs = [torch.empty((len(ar), 4), dtype=dt, device=dev)
            for dt in (torch.int64, torch.int64, torch.int32)]
    cases = {
        "occ4": (len(q), lambda: fmops.occ4_launch(dfm, q, cnt, flags),
                 lambda: fmops.occ4_torch(dfm, q), lambda: [cnt],
                 _line_bound(dfm, 24 * len(q), len(q))),
        "bwt_extend": (len(ar), lambda: fmops.extend_launch(
            dfm, *xs, False, *outs, flags),
                       lambda: fmops.extend_torch(dfm, *xs, False),
                       lambda: outs,
                       _line_bound(dfm, 104 * len(ar), 2 * len(ar),
                                   20 * len(ar))),
    }
    timing = {}
    for name, (n_q, kernel, plain_fn, got, bound) in cases.items():
        ms = _queued_ms(kernel, 20, dev)
        cold_ms = _queued_ms(kernel, 11, dev, cold=True)
        plain, plain_ms = _once_ms(plain_fn, dev)
        plain = [plain] if name == "occ4" else plain
        e = max(_diff(g, p) for g, p in zip(got(), plain))
        fmops._raise_flags(name, flags)
        timing[name] = dict(ms=ms, cold_ms=cold_ms, ms_by="queued events",
                            plain_ms=plain_ms, max_abs_err=e, queries=n_q,
                            bound_ms=bound["bound_ms"],
                            bound_by=bound["bound_by"])
        print(f"  {name} on {n_q} queries at {GRCH38_ROWS} rows: kernel "
              f"{ms:.4f} ms warm, {cold_ms:.4f} ms cold (queued events), "
              f"plain PyTorch "
              f"{plain_ms:.4f} ms (once); bound {bound['bound_ms']:.6f} ms "
              f"({bound['bound_by']}); max|kernel-plain| {e} [{card}]")
        if e:
            raise AssertionError(f"GRCh38 domain: {name} disagrees")
    timing["sa_lookup"] = dict(ms=walk_ms, cold_ms=walk_cold,
                               ms_by="queued events", plain_ms=walk_plain,
                               max_abs_err=e_walk, rows=k.numel(),
                               mean_steps=mean, longest=longest,
                               bound_ms=walk_bound["bound_ms"],
                               bound_by=walk_bound["bound_by"])
    return dict(rows=GRCH38_ROWS, sa_intv=GRCH38_SA_INTV, card_bytes=nbytes,
                host_build_s=t1 - t0, reads=len(reads), checked=checked,
                intervals=n_intv, positions=n_rb, max_interval_bound=top_bound,
                max_sa_position=top_pos, rank_launches=launches,
                rank_err=err, kernels=timing)


def _grch38_chains(dev, card):
    """Phase 20 (b): the chain and chain-to-region kernels on reads of a
    random one-contig pac of 3.1 Gbp (its reverse strand past 2^32), seeded
    at their known positions (``utils.big_ref``): against the plain
    versions on the card and the host oracle."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.pipeline_device import ref_t_cap
    from bwamem_tpu_torch.engine.state import (device_contigs, device_ref,
                                               device_scoring)
    from bwamem_tpu_torch.ops import chain as co
    from bwamem_tpu_torch.ops import pipeline_fused as fo
    from bwamem_tpu_torch.ops import seed as so
    from bwamem_tpu_torch.utils import big_ref

    rng = np.random.default_rng(SEED + 39)
    t0 = time.perf_counter()
    plan = big_ref.plan(GRCH38_L_PAC, rng, GRCH38_CHAIN_READS)
    idx = big_ref.big_index(GRCH38_L_PAC, rng, plan)
    big = big_ref.draw(idx, plan, rng)
    t1 = time.perf_counter()
    opt = MemOptions()
    ctg = device_contigs(idx.bns, dev)
    ref = device_ref(idx, dev)
    tab = big_ref.seed_table(big, dev)
    torch.cuda.synchronize(dev)
    print(f"  pac of {GRCH38_L_PAC} random bases ({ref.pac.numel() / 1e6:.1f} MB "
          f"on the card), {len(big.reads)} reads (150 and 300 bases) and their "
          f"seeds in {t1 - t0:.1f} s; the pac copied in "
          f"{time.perf_counter() - t1:.1f} s")
    params = co.ChainParams.from_opt(opt)
    _reset_counts()
    chains = co.chain(ctg, tab, params)
    qseq, qlen = so.pad_reads(big.reads, dev)
    run = ~chains.ovf
    eparams = fo.ExtendParams.from_opt(opt)
    mat = device_scoring(opt, dev).mat
    t_cap = ref_t_cap(opt, max(len(r) for r in big.reads))
    regs = fo.chain2aln(ctg, ref, chains, qseq, qlen, run, eparams, mat, t_cap)
    launched = {k: v for k, v in _launched().items() if v}
    if set(launched) != {"chain", "chain_emit", "chain2aln_prep", "chain2aln"}:
        raise AssertionError(f"GRCh38 domain: launches {launched}")
    e_chain = max(_diff(g, p) for g, p in zip(chains, co.chain_torch(
        ctg, tab, params)))
    # the plain chain-to-region version on a sample of the reads
    pick = torch.arange(GRCH38_PLAIN_READS, device=dev)
    sub = (ctg, ref, _chains_of(chains, pick), qseq[pick], qlen[pick],
           run[pick], eparams, mat, t_cap)
    got = fo.chain2aln_cuda(*sub)
    plain, plain_ms = _once_ms(lambda: fo.chain2aln_torch(*sub), dev)
    e_c2a = max(_diff(getattr(got, k), getattr(plain, k))
                for k in ("reg_c", "reg_i", "nregs", "seed_off", "work"))
    rows_all = _region_rows(regs)
    e_sub = sum(a != b for a, b in zip(_region_rows(got),
                                       rows_all[:GRCH38_PLAIN_READS]))
    # the host oracle on the first reads
    lists, (ovf, _, _) = co.chain_lists(chains)
    which = range(GRCH38_ORACLE_READS)
    want = big_ref.oracle_regions(opt, idx, big, which)
    e_or_chain = sum([_chain_key(c, True) for c in lists[i]]
                     != [_chain_key(c, True) for c in w[0]]
                     for i, w in zip(which, want))
    e_or_regs = sum(rows_all[i] != _reg_tuples([w[1]])[0]
                    for i, w in zip(which, want))
    rbegs = tab.rbegs.cpu().numpy()
    fwd = rbegs[rbegs < GRCH38_L_PAC]
    rbs = [r[0] for rs in rows_all for r in rs]
    print(f"  chain on {len(big.reads)} reads ({len(rbegs)} seeds; the largest "
          f"forward position {int(fwd.max())} (2^31 = {DOMAIN // 2}), the largest "
          f"position {int(rbegs.max())} (2^32 = {DOMAIN}); {int(ovf.sum())} "
          f"flagged by C), {int(chains.n_chain.sum())} chains; chain2aln "
          f"{int(regs.nregs.sum())} regions, the largest rb {max(rbs)}; launches "
          f"{launched}")
    print(f"  max|kernel-plain| chain {e_chain}, chain2aln {e_c2a} (plain on "
          f"{GRCH38_PLAIN_READS} reads, {plain_ms:.1f} ms once), reads whose "
          f"regions differ between that sample and the whole batch {e_sub}; "
          f"reads differing from the host oracle (chain_flt(mem_chain), "
          f"chain2aln; {GRCH38_ORACLE_READS} reads): chains {e_or_chain}, "
          f"regions {e_or_regs} [{card}]")
    if e_chain or e_c2a or e_sub or e_or_chain or e_or_regs:
        raise AssertionError("GRCh38 domain: a chain or chain-to-region kernel "
                             "disagrees with its references")
    if (int(fwd.max()) < DOMAIN // 2 or int(rbegs.max()) < DOMAIN
            or max(rbs) < DOMAIN):
        raise AssertionError("GRCh38 domain: the reads did not reach 2^31 "
                             "forward and 2^32 on the reverse strand")
    return dict(l_pac=GRCH38_L_PAC, pac_bytes=ref.pac.numel(),
                reads=len(big.reads), seeds=len(rbegs),
                max_forward_position=int(fwd.max()),
                max_position=int(rbegs.max()), max_region_rb=max(rbs),
                chains=int(chains.n_chain.sum()), regions=int(regs.nregs.sum()),
                launches=launched, chain_err=e_chain, chain2aln_err=e_c2a,
                plain_reads=GRCH38_PLAIN_READS,
                oracle_reads=GRCH38_ORACLE_READS)


def phase_grch38(dev, card):
    """Phase 20: GRCh38-sized coordinates past 2^32 (see the two parts)."""
    import gc

    import torch

    seeding = _grch38_seeding(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    chains = _grch38_chains(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(card=card, seeding=seeding, chains=chains)
    print(json.dumps({"grch38_domain": out}))
    return out


def _redesign(name: str, res: dict) -> dict:
    """A redesigned kernel's slowest job (the wave kernel), row (the SA
    walk), chain (the prep kernel) or read alone, as this run timed it."""
    if name not in REDESIGNED:
        return {}
    unit = {"ksw_extend": "job", "sa_lookup": "row",
            "chain2aln_prep": "chain"}.get(name, "read")
    return {f"slowest_{unit}_ms": res["slowest_ms"],
            f"slowest_{unit}_ms_by": res["slowest_by"]}


def _batch(name: str, traces) -> dict:
    """An entry's kernel time summed over the profiled batches of phases 4
    and 15, and its launches there (0 and 0 for a kernel no route of those
    batches launches)."""
    ms = sum(t.get(name, (0.0, 0))[0] for t in traces)
    n = sum(t.get(name, (0.0, 0))[1] for t in traces)
    return {"batch_ms": ms, "batch_launches": n}


def _head(t_run: float, text: str):
    """A phase's heading, with the run's seconds so far."""
    print(f"{text} (at {time.perf_counter() - t_run:.1f} s)", flush=True)


def main() -> int:
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--traced-batch":
        sys.path.insert(0, ROOT)
        return traced_batch_child(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--dist-worker":
        sys.path.insert(0, ROOT)
        return _dist_child(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from bwamem_tpu_torch import BwaMemIndex
    from bwamem_tpu_torch.engine import exec_ctx
    from bwamem_tpu_torch.ops import extend as ext

    t_run = time.perf_counter()
    exec_ctx.KEEP_LARGEST = True  # the timing phases reuse the largest batches
    dev = torch.device("cuda", 0)
    card = _card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    phase_build()

    _head(t_run, "[3] kernel vs plain PyTorch (card) vs host C++ ksw_extend2, "
          "tolerance 0 (int32, exact)")
    err3 = phase_kernel_vs_plain(dev, ext.ksw_extend_cuda)

    _head(t_run, "[4] main path: BwaMemAligner(device='cuda', device_pipeline=False) "
          "vs the host oracle")
    t0 = time.perf_counter()
    codes, img, build_s = _synthetic_index(ECOLI_LEN)
    index = BwaMemIndex(img)
    print(f"  genome 4.6 Mbp + index in {time.perf_counter() - t0:.1f} s "
          f"(build {build_s:.1f} s)")
    runs = phase_main_path(dev, index, codes)

    _head(t_run, "[5] kernel timing on the largest PE wave")
    ksw = phase_timing(dev, runs["pe"]["wave"])

    _head(t_run, "[6] FM kernels vs plain PyTorch (card) vs host FMIndex, tolerance 0 "
          "(integers, exact)")
    fm = index._require().fm
    fm_err = phase_fm_kernels(dev, fm)

    _head(t_run, "[7] device SA stage: BwaMemAligner(device='cuda', "
          "device_stages=('sa_lookup',)) vs the host oracle")
    sa = phase_device_sa(dev, index, fm, runs)

    _head(t_run, "[8] chr20 scale: 64 Mbp genome, seeding, SA walks and extension on "
          "the card")
    big = phase_chr20(dev)

    _head(t_run, "[9] op probe (port of benchmarks/mosaic_probe.py)")
    probe = phase_probe(dev)

    _head(t_run, "[10] seeding kernels vs plain PyTorch (card) vs host oracle, "
          "tolerance 0 (integers, exact)")
    seed_k = phase_seed_kernels(dev, fm, codes, runs["pe"]["batch"])

    _head(t_run, "[11] device seed stage: BwaMemAligner(device='cuda', "
          "device_stages=('seed', 'sa_lookup') / ('seed',)) vs the host oracle")
    seed_run = phase_device_seed(dev, index, runs)

    _head(t_run, "[12] chain kernels vs plain PyTorch (card) vs host C++ vs host "
          "oracle, tolerance 0 (integers and bit-equal doubles, exact)")
    chain_k = phase_chain_kernels(dev, index, runs["pe"]["batch"])

    _head(t_run, "[13] device chain stage: BwaMemAligner(device='cuda', "
          "device_stages=('seed', 'sa_lookup', 'chain') / ('chain',)) vs the "
          "host oracle")
    chain_run = phase_device_chain(dev, index, runs)

    _head(t_run, "[14] chain-to-region kernels vs plain PyTorch (card) vs host wave "
          "runner vs host oracle, tolerance 0 (integers and bit-equal doubles, "
          "exact)")
    fused_k = phase_chain2aln_kernels(dev, index, runs["pe"]["batch"])

    _head(t_run, "[15] fused device path: BwaMemAligner(device='cuda', "
          "device_pipeline=True) vs the host oracle")
    fused_run = phase_fused(dev, index, runs, chain_run, big)

    _head(t_run, "[16] the C++ tail: the host whole-batch, default, staged and fused "
          "routes vs the host route and the Python route")
    phase_native_tail(dev, index, runs, big, card, fused_run)
    big["index"].close()

    _head(t_run, "[17] the command line on the card: python -m bwamem_tpu_torch "
          "index / mem, every route against the host route's SAM")
    phase_cli(dev, index, codes, runs, card)

    _head(t_run, "[18] several devices: the mesh aligner (the cards, a virtual (2, 2) "
          "mesh of cuda:0), the dry run with idx-sharded tables, two gloo "
          "processes, the device SA build, mem --devices")
    multi = phase_devices(dev, index, codes, runs, card)

    _head(t_run, "[19] midlen: 300 bp pairs (insert 700) through the fused, staged "
          "and default routes vs the host route; every path kernel vs its "
          "plain version on the batch")
    phase_midlen(dev, index, codes, card)
    index.close()

    _head(t_run, "[20] GRCh38-sized coordinates: seeding and SA walks at 6.2e9 rows, "
          "chain and chain-to-region kernels at reference positions past 2^32")
    phase_grch38(dev, card)
    _head(t_run, "  phases 1-20 done")
    print(f"  main-path kernel times of this run (PERF.md section 6 holds "
          f"their earlier runs): ksw_extend {ksw['ms']:.4f} ms, sa_lookup "
          f"{big['sa']['cold_ms']:.4f} ms cold, collect_intv "
          f"{seed_k['collect_intv']['ms']:.4f} ms, sample_ks "
          f"{seed_k['sample_ks']['ms']:.4f} ms, chain {chain_k['chain']['ms']:.4f} "
          f"ms, chain_emit {chain_k['chain_emit']['ms']:.4f} ms, chain2aln_prep "
          f"{fused_k['chain2aln_prep']['ms']:.4f} ms, chain2aln "
          f"{fused_k['chain2aln']['ms']:.4f} ms [{card}]")

    fm_src = "bwamem_tpu_torch/csrc/fmindex.cu"
    traces = (runs["pe"]["batch_kernels"], fused_run["batch_kernels"])
    kernels = [
        {"name": "ksw_extend", "route": "cuda",
         "source": "bwamem_tpu_torch/csrc/extend.cu",
         "replaces": "bwamem_tpu/ops/extend_pallas.py:83",
         "launches": runs["pe"]["launches"],
         "max_abs_err": max(err3, ksw["err"]), "ms": ksw["ms"],
         "ms_by": "events", "plain_ms": ksw["plain_ms"], **ksw["bound"],
         **_redesign("ksw_extend", ksw)},
        {"name": "occ4", "route": "cuda", "source": fm_src,
         "replaces": "bwamem_tpu/ops/fmindex_tpu.py:249",
         "launches": big["launches"]["occ4"],
         "max_abs_err": max(fm_err["occ4"], big["rank"]["occ4"][2]),
         "ms": big["rank"]["occ4"][0], "ms_by": "events",
         "plain_ms": big["rank"]["occ4"][1],
         **big["rank"]["occ4"][3]},
        {"name": "bwt_extend", "route": "cuda", "source": fm_src,
         "replaces": "bwamem_tpu/ops/fmindex_tpu.py:296",
         "launches": big["launches"]["bwt_extend"],
         "max_abs_err": max(fm_err["bwt_extend"], big["rank"]["bwt_extend"][2]),
         "ms": big["rank"]["bwt_extend"][0], "ms_by": "events",
         "plain_ms": big["rank"]["bwt_extend"][1],
         **big["rank"]["bwt_extend"][3]},
        {"name": "sa_lookup", "route": "cuda", "source": fm_src,
         "replaces": "bwamem_tpu/ops/fmindex_tpu.py:382",
         "launches": sa["pe"]["launches"],
         "max_abs_err": max(fm_err["sa_lookup"], seed_k["walks_err"]),
         "ms": big["sa"]["cold_ms"], "ms_by": "events",
         "plain_ms": big["sa"]["plain_ms"],
         **big["sa"]["bound"], "latency_floor_ms": big["sa"]["floor_ms"],
         "latency_floor_ms_by": big["sa"]["floor_by"],
         **_redesign("sa_lookup", big["sa"])},
        {"name": "backward_search", "route": "cuda", "source": fm_src,
         "replaces": "bwamem_tpu/ops/seed_tpu.py:27",
         "launches": big["launches"]["backward_search"],
         "max_abs_err": big["rank"]["backward_search"][2],
         "ms": big["rank"]["backward_search"][0], "ms_by": "events",
         "plain_ms": big["rank"]["backward_search"][1],
         **big["rank"]["backward_search"][3]},
        {"name": "op_probe", "route": "cuda",
         "source": "bwamem_tpu_torch/csrc/op_probe.cu",
         "replaces": "benchmarks/mosaic_probe.py:44",
         "launches": probe["launches"], "max_abs_err": probe["err"],
         "ms": probe["ms"], "ms_by": "events", "plain_ms": probe["plain_ms"],
         **probe["bound"]},
    ] + [
        {"name": name, "route": "cuda", "source": "bwamem_tpu_torch/csrc/seed.cu",
         "replaces": SEED_REPLACES[name],
         "launches": seed_run["calls"][name],
         "launches_are": f"calls of the __device__ function {name} inside "
                         "collect_intv_kernel in the main path's run, as that "
                         "kernel counts them",
         "own_kernel_launches": seed_run["launches"][name],
         "max_abs_err": seed_k[name]["err"], "ms": seed_k[name]["ms"],
         "ms_by": "events", "plain_ms": seed_k[name]["plain_ms"],
         **seed_k[name]["bound"]}
        for name in ("smem1a", "strategy1")
    ] + [
        {"name": name, "route": "cuda", "source": "bwamem_tpu_torch/csrc/seed.cu",
         "replaces": SEED_REPLACES[name],
         "launches": seed_run["launches"][name],
         "max_abs_err": seed_k[name]["err"], "ms": seed_k[name]["ms"],
         "ms_by": seed_k[name]["ms_by"], "plain_ms": seed_k[name]["plain_ms"],
         **seed_k[name]["bound"], **_redesign(name, seed_k[name])}
        for name in ("collect_intv", "sample_ks")
    ] + [
        {"name": name, "route": "cuda", "source": "bwamem_tpu_torch/csrc/chain.cu",
         "replaces": "bwamem_tpu/ops/chain_tpu.py:41",
         "launches": chain_run["launches"][name],
         "max_abs_err": chain_k[name]["err"], "ms": chain_k[name]["ms"],
         "ms_by": chain_k[name]["ms_by"], "plain_ms": chain_k[name]["plain_ms"],
         **chain_k[name]["bound"],
         **_redesign(name, chain_k[name])}
        for name in ("chain", "chain_emit")
    ] + [
        {"name": name, "route": "cuda",
         "source": "bwamem_tpu_torch/csrc/chain2aln.cu",
         "replaces": "bwamem_tpu/ops/pipeline_fused.py:111",
         "launches": fused_run["launches"][name],
         "max_abs_err": fused_k[name]["err"], "ms": fused_k[name]["ms"],
         "ms_by": fused_k[name]["ms_by"], "plain_ms": fused_k[name]["plain_ms"],
         **fused_k[name]["bound"],
         **_redesign(name, fused_k[name])}
        for name in ("chain2aln_prep", "chain2aln")
    ]
    kernels += [
        {"name": name, "route": "cuda",
         "source": ("bwamem_tpu_torch/csrc/seed.cu" if name.startswith("collect")
                    else fm_src),
         "replaces": SHARDED_REPLACES[name], "launches": r["launches"],
         "max_abs_err": r["err"], "ms": r["ms"], "ms_by": r["ms_by"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "shards": r["shards"], "unsharded_ms": r["unsharded_ms"],
         **{k: v for k, v in r.items() if k.startswith("ms_")}}
        for name, r in multi["sharded"].items()
    ]
    d11 = multi["sa"]["4.6 Mbp"]
    kernels.append(
        {"name": "suffix_array", "route": "torch",
         "source": "bwamem_tpu_torch/ops/sa.py",
         "replaces": "bwamem_tpu/ops/sa_tpu.py:32",
         "launches": multi["sa"]["launches"], "launches_are": "sort rounds",
         "max_abs_err": max(r["err"] for k, r in multi["sa"].items()
                            if k != "launches"),
         "ms": d11["ms"], "ms_by": "events", "plain_ms": d11["host_ms"],
         "plain_is": "the host C++ SA-IS", **d11["bound"],
         "ms_64mbp": multi["sa"]["64 Mbp"]["ms"],
         "plain_ms_64mbp": multi["sa"]["64 Mbp"]["host_ms"]})
    for k in kernels:
        k.update(_batch(k["name"], traces))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
