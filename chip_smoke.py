#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bwamem_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit if it fails:

1. the card: its name and power limit as nvidia-smi reports them; no card
   (torch.cuda.is_available() false) exits at once;
2. build: compiles csrc/extend.cu, csrc/fmindex.cu, csrc/op_probe.cu,
   csrc/seed.cu, csrc/chain.cu and csrc/chain2aln.cu with nvcc for sm_90a,
   one nvcc per source, all at once, and prints the compiler's register and
   spill report;
3. kernel against plain: the SW extension kernel against the plain
   PyTorch version on the card and the host C++ ksw_extend2, field for
   field and exactly, on seeded batches (a 4096-job main-path wave, the JAX
   tests' ragged shapes, edge cases, zdrop=0, non-default scoring);
4. main path: the port's BwaMemAligner(device="cuda") aligns 6,000 pairs of
   150 bp reads (and 2,000 reads single-end) on bench.py's 4.6 Mbp "ecoli"
   synthetic genome; every record must equal the host oracle's (the port's
   own aligner with no device stage and every extension wave on the host, so
   that every stage runs in the port's host C++; the CPU tests hold that path
   record-equal to bwamem_tpu's aligner), the kernel must have run, and at least half of the extension jobs must
   have gone to the card; then the PE batch runs once more under
   torch.profiler for the card's busy and idle share;
5. timing: the kernel and the plain version on the largest wave of phase 4,
   with CUDA events after a warm-up;
6. FM kernels against their references on the 4.6 Mbp index, exactly:
   occ4, bwt_extend and the SA walk against the plain versions on the card
   and the host FMIndex, on seeded rows with the sentinel rows and on
   bi-intervals from set_intv extended both ways;
7. the device SA stage: the batches of phase 4 again with
   device_stages=("sa_lookup",): records equal to the host aligner's, the
   SA kernel launched, no SA row walked on the host; the SA kernel and the
   plain version timed on the largest SA batch;
8. at chr20 scale: bench.py's 64 Mbp "chr20" genome (seed 1234, sa_intv 8;
   48 MB of lines and 128 MB of sampled SA, past the card's 50 MB L2):
   2,000 pairs with the seeding, the SA walks, the chaining and the
   extension on the card, record-equal to the host oracle, with the seed
   checks of phase 11 and the chain checks of phase 13;
   the SA kernel, the plain version
   and the host C++ walk timed on that batch's rows; then seeding-shaped
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
   engine/chain.py sample_ks; FMIndex.sa_lookup); each kernel timed with
   CUDA events after a warm-up, each plain version once;
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
   batch size and on the heaviest read alone), the plain version once;
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
   the band preamble of csrc/extend.cuh against ops.extend.band_width; the
   kernels timed with CUDA events on the whole batch (also by batch size and
   on the heaviest read alone), the plain version once;
15. the fused device path: phase 4's batches (PE and SE) and phase 8's chr20
   batch with device_pipeline=True: records equal to the host oracle's, all
   the path's kernels launched, at least 95 % of the reads on the fused path
   (the rest, seeded on the host, flagged by the C budget or long enough for
   mem_flt_chained_seeds to act, on the staged path and counted by cause), no
   extension wave when no read left the path; the device_pipeline, dedup and
   pairing seconds beside phase 13's stages; the PE batch once more under
   torch.profiler for the card's idle share.

The launch counts in the ``kernels`` line come from the runs that drive
each kernel: phase 4's PE batch (ksw_extend), phase 7's PE batch
(sa_lookup), phase 8's seeding-shaped work (occ4, bwt_extend), phase 9's
probe run (op_probe), phase 11's PE batch with the seed and SA stages
(collect_intv, sample_ks), phase 13's PE batch with all three stages (chain,
chain_emit), phase 15's PE batch (chain2aln_prep, chain2aln) and phase 8's
one-launch search (backward_search, which no aligner stage calls); each
count is set to 0 just before and read just after.  Every entry also carries ``bound_ms``, the least time the card could
take (this run's bytes at 3.35 TB/s or its integer operations at the int32
rate, whichever is larger, named in ``bound_by``), and ``library_ms``, null
throughout: no single PyTorch call computes any of these functions.  smem1a and strategy1 run on the main path as __device__ functions
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
    """The record oracle: the port's aligner with no device stage and every
    extension wave on the host, so that every stage runs in the port's host
    C++ (held record-equal to bwamem_tpu's aligner by the CPU tests)."""
    from bwamem_tpu_torch import BwaMemAligner

    return BwaMemAligner(index, device="cpu", min_device_jobs=1 << 30)


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
    """Phase 2: one nvcc per source, all started together."""
    from bwamem_tpu_torch.utils import cudabuild

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as ex:
        libs = list(ex.map(cudabuild.build, SOURCES))
    print(f"[2] nvcc built {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.2f} s")
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


def _device_busy(aligner, reads, dev):
    """Seconds the card was busy (union of its kernels and copies in a
    torch.profiler trace) while ``aligner`` aligned ``reads``, and the
    wall seconds of that call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        aligner.align_seqs(reads)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler saw no work on the card")
    busy_us, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy_us += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return (busy_us + hi - lo) / 1e6, wall


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

    STATS.reset()
    SA_STATS.reset()
    SEED_STATS.reset()
    CHAIN_STATS.reset()
    FUSED_STATS.reset()
    TIMERS.reset()
    ext.LAUNCHES = 0
    fmops.LAUNCHES["sa_lookup"] = 0
    for counts in (seedops.LAUNCHES, chainops.LAUNCHES, fusedops.LAUNCHES):
        for name in counts:
            counts[name] = 0
    got, t_port = _timed(port, batch, dev)
    launches, sa_launches = ext.LAUNCHES, fmops.LAUNCHES["sa_lookup"]
    seed_launches = dict(seedops.LAUNCHES)
    chain_launches = dict(chainops.LAUNCHES)
    fused_launches = dict(fusedops.LAUNCHES)
    stages = TIMERS.snapshot()
    ok = sum([vars(x) for x in g] == [vars(x) for x in r] for g, r in zip(got, ref))
    aligned = sum(1 for r in got if r and not (r[0].sam_flag & 0x4))
    share = STATS.device_share()
    print(f"  {tag}: {len(batch)} reads, records equal {ok}/{len(batch)}, "
          f"aligned {aligned}; port {len(batch) / t_port:.1f} reads/s "
          f"({t_port:.2f} s), the oracle (the port with every stage on the "
          f"host) {len(batch) / t_host:.1f} reads/s ({t_host:.2f} s)")
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
              f"{fs.fcs_reads}); tasks extended {fs.tasks}, pruned {fs.pruned}, "
              f"extension jobs {fs.jobs}; the JAX package's budgets would flag "
              f"{fs.ref_s_overflows} (S) + {fs.ref_c_overflows} (C) + "
              f"{fs.ref_r_overflows} (R) + {fs.ref_t_overflows} (window) reads; "
              "chain-to-region launches " + ", ".join(
                  f"{k} {v}" for k, v in fused_launches.items())
              + "; seconds inside device_pipeline: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in fs.seconds.items()))
    rest = t_port - sum(stages.values())
    print(f"  {tag}: port seconds by stage: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items())
        + f", pairing+records {rest:.3f}; inside extend: device waves "
        f"{STATS.device_wave_seconds:.3f} (pack, copies, kernel), host "
        f"waves {STATS.host_wave_seconds:.3f}")
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
        host, port = _host_aligner(index), BwaMemAligner(index, device=dev)
        if mode == "pe":
            for a in (host, port):
                _pe_setup(a)
        for a in (host, port):
            a.align_seqs(warm)
        ref, t_host = _timed(host, batch, dev)
        res = _port_run(mode, port, batch, ref, t_host, dev)
        runs[mode] = dict(batch=batch, ref=ref, t_host=t_host, warm=warm,
                          launches=res["launches"], stages=res["stages"],
                          wave=STATS.largest_wave)
        if mode == "pe":
            busy, wall = _device_busy(port, batch, dev)
            print(f"  pe: again under torch.profiler: card busy {busy:.4f} s of "
                  f"{wall:.2f} s, idle share {1 - busy / wall:.4f}")
    return runs


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
    ms = _event_ms(lambda: ext.ksw_extend_launch(
        q8, t8, scal, sc.mat, Q, sc.o_del, sc.e_del, sc.o_ins, sc.e_ins,
        sc.zdrop), 20, dev)
    wrapper_ms = _event_ms(lambda: ext.ksw_extend_cuda(*args), 20, dev)
    plain_ms = _event_ms(lambda: ext.ksw_extend_torch(*args), 3, dev)
    # the DP cells inside each job's band, ~10 integer operations a cell
    cells = int((torch.minimum(qlen, 2 * w_adj + 1).long() * tlen.long()).sum())
    bound = _bound(q8.numel() + t8.numel() + 4 * (scal.numel() + sc.mat.numel())
                   + 24 * B, 10 * cells)
    print(f"  largest wave B={B} Q={Q} T={t.shape[1]}: kernel {ms:.4f} ms, "
          f"ksw_extend_cuda (checks, conversions, kernel) {wrapper_ms:.4f} ms, "
          f"plain PyTorch {plain_ms:.4f} ms; {cells} cells in band, bound "
          f"{bound['bound_ms']:.5f} ms by {bound['bound_by']}")
    return ms, plain_ms, err, bound


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


def _walk_steps(dfm, k):
    """Mean and longest walk of the rows ``k`` (the plain walk's count)."""
    from bwamem_tpu_torch.ops import fmindex as fmops

    n = k.numel()
    total, steps = 0, 0
    while True:
        k = k[k % dfm.sa_intv != 0]
        if k.numel() == 0:
            return total / max(n, 1), steps
        total += k.numel()
        steps += 1
        k = fmops._lf(dfm, k)


def _time_sa(tag, dev, fm, rows):
    """The SA kernel alone (repeated launches, and single launches from a
    cold L2), the plain version and the host C++ walk on ``rows``;
    returns (cold kernel ms, plain ms)."""
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
    mean, longest = _walk_steps(dfm, k)
    n = len(rows)
    print(f"  {tag}: {n} SA rows, {mean:.3f} LF steps per walk (longest "
          f"{longest}); kernel {ms:.4f} ms repeated ({n / ms * 1e3:.4g} "
          f"rows/s), {cold_ms:.4f} ms from a cold L2 ({n / cold_ms * 1e3:.4g} "
          f"rows/s), plain "
          f"PyTorch {plain_ms:.4f} ms ({n / plain_ms * 1e3:.4g} rows/s), host "
          f"C++ sa_batch {host_s * 1e3:.4f} ms ({n / host_s:.4g} rows/s); "
          f"max|kernel-plain|,|kernel-host| {err}")
    if err:
        raise AssertionError(f"{tag}: the SA kernel disagrees")
    bound = _line_bound(dfm, 16 * n + 8 * min(n, dfm.sa.numel()), mean * n,
                        10 * mean * n)
    return cold_ms, plain_ms, bound


def phase_device_sa(dev, index, fm, runs):
    """Phase 7: the batches of phase 4 with the SA walks on the card."""
    from bwamem_tpu_torch import BwaMemAligner
    from bwamem_tpu_torch.engine.pipeline import SA_STATS

    sa = {}
    for mode in ("pe", "se"):
        r = runs[mode]
        port = BwaMemAligner(index, device=dev, device_stages=("sa_lookup",))
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
    port = BwaMemAligner(index, device=dev, device_stages=ALL_STAGES)
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
    sa_ms, sa_plain_ms, sa_bound = _time_sa("64 Mbp, PE batch", dev, fm,
                                            SA_STATS.largest_rows)
    launches, err, mid = _rank_drive(dev, fm, reads)
    rank = _time_rank(dev, fm, mid)
    return dict(sa_ms=sa_ms, sa_plain_ms=sa_plain_ms, sa_bound=sa_bound,
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
    piv, c_plain_ms = _once_ms(lambda: so.collect_intv_torch(
        dfm, qseq, qlen, params, so.M_SLOTS, K), dev)
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
    nr = torch.where(o32.bool(), 0, n32)
    row_o, ks_o, n_tot, ks_tot = so._scan_offsets(nr, nks)
    flat2 = torch.empty((n_tot, 5), dtype=torch.int64, device=dev)
    ks2 = torch.empty(ks_tot, dtype=torch.int64, device=dev)
    s_ms = _event_ms(lambda: so.sample_ks_launch(rows, nr, row_o, ks_o,
                                                 params.max_occ, flat2, ks2),
                     10, dev)
    e_c = max(e_c, _diff(rows[ok], iv.rows[ok]))
    e_s = max(e_s, _diff(flat2, got.flat), _diff(ks2, got.ks))
    w = work.cpu().numpy().astype(np.int64)
    print(f"  collect_intv on {B} reads ({len(batch)} of phase 4's PE batch and "
          f"{len(edges)} edge reads; {int(ovf.sum())} flagged by the K/M budget): "
          f"kernel {c_ms:.4f} ms repeated, {cold_ms:.4f} ms from a cold L2, "
          f"plain PyTorch {c_plain_ms:.4f} ms (once); max|kernel-plain| {e_c}, "
          f"max|kernel-host| {e_ch} ({checked} reads)")
    print(f"  collect_intv work per read: smem1a calls mean "
          f"{w[:, 0].mean():.3f} (max {w[:, 0].max()}), strategy1 calls mean "
          f"{w[:, 1].mean():.3f} (max {w[:, 1].max()}), bwt_extend calls mean "
          f"{w[:, 2].mean():.2f} (max {w[:, 2].max()}); K slots needed mean "
          f"{w[:, 4].mean():.2f} (max {w[:, 4].max()}), more than "
          f"{so.K_SLOTS} in {int((w[:, 4] > so.K_SLOTS).sum())} reads; "
          f"flagged at K = {K} by K {int((w[:, 3] == 1).sum())}, by M "
          f"{int((w[:, 3] == 2).sum())}; {len(flat)} rows, {len(ks)} SA rows")
    print(f"  sample_ks on those rows: kernel {s_ms:.4f} ms, plain PyTorch "
          f"{s_plain_ms:.4f} ms (once); max|kernel-plain| {e_s}, "
          f"max|kernel-host| {e_sh}; SA walks of its rows max|kernel-plain| "
          f"{e_w}, max|kernel-host| {e_wh}")
    calls = int(w[:, 2].sum())
    res["collect_intv"] = dict(
        err=max(e_c, e_ch), ms=c_ms, plain_ms=c_plain_ms,
        bound=_line_bound(dfm, qseq.numel() + 20 * B + 40 * len(flat),
                          2 * calls, 20 * calls))
    res["sample_ks"] = dict(
        err=max(e_s, e_sh), ms=s_ms, plain_ms=s_plain_ms,
        bound=_bound(80 * len(flat) + 8 * len(ks) + 20 * B, 4 * len(ks)))
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
        port = BwaMemAligner(index, device=dev, device_stages=stages)
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


def phase_chain_kernels(dev, index, batch):
    """Phase 12: the chain kernels = plain (card) = host C++ = host oracle on
    the PE batch's real seeds, then their times."""
    import numpy as np
    import torch

    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine import native_chain, pipeline
    from bwamem_tpu_torch.engine.chain import chain_flt, mem_chain
    from bwamem_tpu_torch.engine.exec_ctx import ExecConfig
    from bwamem_tpu_torch.engine.seed import SmemIntv
    from bwamem_tpu_torch.engine.state import device_contigs
    from bwamem_tpu_torch.ops import chain as co
    from bwamem_tpu_torch.utils.encoding import seq_to_codes_batch

    opt = MemOptions()
    eng = index._require()
    bns = eng.idx.bns
    reads = seq_to_codes_batch(batch)
    qlens = np.asarray([len(r) for r in reads], dtype=np.int32)
    # the table as the aligner's chain stage gets it: seeded and walked on
    # the card, never on the host
    tab, _, _, _ = pipeline._device_table(opt, eng, reads, qlens, ExecConfig(
        device=dev, device_seed=True, device_sa_lookup=True, device_chain=True))
    ctg = device_contigs(bns, dev)
    params = co.ChainParams.from_opt(opt)
    got = co.chain_cuda(ctg, tab, params)
    plain, plain_ms = _once_ms(lambda: co.chain_torch(ctg, tab, params), dev)
    e_plain = max(_diff(g, p) for g, p in zip(got, plain))
    # chain for chain against the host C++ on every read, and against the
    # oracle (which also sets w, kept and first) on a sample
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

    def count(sub=tabp, off=seed_off):
        co.chain_launch(ctg, sub, off, params, co.C_MAX, assign, slot_dst, crec,
                        n_chain, n_seed, frac, o32, s32, flags)

    sizes = {}
    for nb in sorted({n for n in (1000, 3000, B // 2) if n < B}):
        sub, _, off = co.prepare(ctg, tabp._replace(
            qlen=tabp.qlen[:nb], intv_off=tabp.intv_off[:nb],
            n_intv=tabp.n_intv[:nb]))
        sizes[nb] = _event_ms(lambda: count(sub, off), 10, dev)
    top = int(np.argmax(seed_cnt))
    one, _, off1 = co.prepare(ctg, tabp._replace(
        qlen=tabp.qlen[top: top + 1], intv_off=tabp.intv_off[top: top + 1],
        n_intv=tabp.n_intv[top: top + 1]))
    top_ms = _event_ms(lambda: count(one, off1), 10, dev)
    c_ms = _event_ms(count, 10, dev)
    cold_ms = _cold_ms(count, 5, dev)
    nc, ns = int(n_chain.sum()), int(n_seed.sum())
    chain_off = torch.cumsum(n_chain, 0) - n_chain
    seed_dst = torch.cumsum(n_seed, 0) - n_seed
    chain_rows = torch.empty((nc, 7), dtype=i64, device=dev)
    seed_rows = torch.empty((ns, 4), dtype=i64, device=dev)

    def both():  # the emit pass advances slot_dst, so the count pass precedes it
        count()
        co.chain_emit_launch(ctg, tabp, seed_off, assign, slot_dst, crec, n_chain,
                             frac, chain_off, seed_dst, chain_rows, seed_rows)

    both_ms = _event_ms(both, 10, dev)
    if int(flags.item()):
        raise AssertionError(f"chain kernels raised flags {int(flags.item())}")
    e_plain = max(e_plain, _diff(chain_rows, got.chain_rows),
                  _diff(seed_rows, got.seed_rows))
    N = int(n_intv.sum())
    print(f"  chain on {B} reads ({N} intervals, {T} seeds; per read mean "
          f"{seed_cnt.mean():.1f}, p50/p90/p99 "
          f"{np.percentile(seed_cnt, [50, 90, 99]).tolist()}, max "
          f"{int(seed_cnt.max())}; chain slots used mean {nslots.mean():.2f}, max "
          f"{int(nslots.max())}, more than 32 in {int((nslots > 32).sum())} reads, "
          f"flagged at C = {co.C_MAX}: {int(ovf.sum())}; {nc} chains and {ns} "
          f"seeds out): chain_kernel {c_ms:.4f} ms repeated, {cold_ms:.4f} ms "
          f"from a cold L2; chain_kernel + chain_emit_kernel {both_ms:.4f} ms, so "
          f"chain_emit_kernel {both_ms - c_ms:.4f} ms; plain PyTorch "
          f"{plain_ms:.2f} ms (once)")
    print("  chain_kernel by batch size: " + ", ".join(
        f"B={nb} {ms:.4f} ms" for nb, ms in sizes.items())
        + f", B={B} {c_ms:.4f} ms; the read with the most seeds alone "
        f"({int(seed_cnt[top])} seeds, {int(nslots[top])} slots): {top_ms:.4f} ms, "
        f"{top_ms * 1e3 / max(int(seed_cnt[top]), 1):.3f} us per seed")
    print(f"  max|kernel-plain| {e_plain}; reads whose chains differ from the "
          f"host C++ chain_batch {e_host} (of {B}), from the oracle "
          f"chain_flt(mem_chain) with w, kept and first {e_oracle} (of "
          f"{len(pick)})")
    if e_plain or e_host or e_oracle:
        raise AssertionError("a chain kernel disagrees with its references")
    io = 8 * T + 56 * N + 28 * B
    return {
        "chain": dict(err=0, ms=c_ms, plain_ms=plain_ms,
                      bound=_bound(io + 32 * B, 60 * T)),
        "chain_emit": dict(err=0, ms=both_ms - c_ms, plain_ms=plain_ms,
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
        port = BwaMemAligner(index, device=dev, device_stages=stages)
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
    e_plain = max(e_plain, _diff(got.work[:, :4], plain.work[:, :4]))
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
    L = q8.shape[1]
    Nc, Ns = chains_p.chain_rows.shape[0], chains_p.seed_rows.shape[0]
    rmax = torch.empty((Nc, 2), dtype=i64, device=dev)
    srt = torch.empty(Ns, dtype=i32, device=dev)
    alive = torch.empty(Ns, dtype=torch.uint8, device=dev)
    reg_c = torch.zeros((Ns, 3), dtype=i64, device=dev)
    reg_i = torch.zeros((Ns, 8), dtype=i32, device=dev)
    err = torch.zeros(1, dtype=i32, device=dev)
    mat_c = mat.contiguous()

    def prep():
        fo.chain2aln_prep_launch(ctg, chains_p, lay, ql, params, rmax, srt, err)

    def loop(lo=0, hi=B):
        n = hi - lo
        eh = torch.empty((2, L + 1, n), dtype=i32, device=dev)
        nregs = torch.zeros(n, dtype=i32, device=dev)
        wk = torch.zeros((n, 6), dtype=i64, device=dev)
        fo.chain2aln_launch(
            ref, chains_p, lay, chains_p.n_chain[lo:hi], chains_p.n_seed[lo:hi],
            lay.chain_off[lo:hi], lay.seed_off[lo:hi], rmax, srt, alive,
            run8[lo:hi], q8[lo:hi], ql[lo:hi], mat_c, params, t_cap, eh, reg_c,
            reg_i, nregs, wk, err)
        return nregs, wk

    prep_ms = _event_ms(prep, 10, dev)
    sizes = {nb: _event_ms(lambda: loop(0, nb), 3, dev)
             for nb in sorted({n for n in (1000, 3000, B // 2) if n < B})}
    top = int(np.argmax(work[:, fo.W_CELLS]))
    top_ms = _event_ms(lambda: loop(top, top + 1), 3, dev)
    ms = _event_ms(loop, 5, dev)
    nregs, wk = loop()
    fo.raise_flags(int(err.item()))
    e_plain = max(e_plain, _diff(nregs, whole.nregs), _diff(wk, whole.work),
                  _diff(reg_c, whole.reg_c), _diff(reg_i, whole.reg_i))
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
          f"{prep_ms:.4f} ms, chain2aln_kernel {ms:.4f} ms; plain PyTorch on "
          f"{len(pick)} reads {plain_ms:.1f} ms (once)")
    print("  chain2aln_kernel by batch size: " + ", ".join(
        f"B={nb} {t:.4f} ms" for nb, t in sizes.items())
        + f", B={B} {ms:.4f} ms; the read with the most cells alone "
        f"({int(work[top, fo.W_TASKS])} tasks, {int(work[top, fo.W_JOBS])} jobs, "
        f"{int(work[top, fo.W_CELLS])} cells): {top_ms:.4f} ms, "
        f"{top_ms * 1e6 / max(int(work[top, fo.W_CELLS]), 1):.1f} ns per cell")
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
        "chain2aln_prep": dict(err=0, ms=prep_ms, plain_ms=plain_ms,
                               bound=_bound(56 * Nc + 32 * Ns + 16 * Nc + 4 * Ns,
                                            30 * Ns)),
        "chain2aln": dict(err=0, ms=ms, plain_ms=plain_ms, bound=_bound(
            io_in + 16 * Nc + min(rows / 4, ref.pac.numel()) + 56 * nr + 52 * B,
            10 * cells)),
    }


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
        fs, la, n = res["fused_stats"], res["fused_launches"], len(r["batch"])
        if any(v <= 0 for v in la.values()):
            raise AssertionError(f"{tag}: the chain-to-region kernels did not run")
        _check_seeded(tag, res, r["batch"])
        if any(v <= 0 for v in res["chain_launches"].values()):
            raise AssertionError(f"{tag}: the chain kernels did not run")
        if fs["device_reads"] + fs["host_reads"] != n:
            raise AssertionError(f"{tag}: reads {fs['device_reads']} + "
                                 f"{fs['host_reads']}, not {n}")
        if fs["device_reads"] < 0.95 * n:
            raise AssertionError(f"{tag}: only {fs['device_reads']} of {n} reads "
                                 "on the fused path")
        if fs["host_reads"] != (fs["host_seeded"] + fs["c_overflows"]
                                + fs["fcs_reads"]):
            raise AssertionError(f"{tag}: a read left the fused path unflagged")
        if fs["host_reads"] == 0 and (res["waves"] or res["launches"]):
            raise AssertionError(f"{tag}: {res['waves']} extension waves though "
                                 "no read left the fused path")
        st = res["stages"]
        print(f"  {tag}: device_pipeline {st['device_pipeline']:.4f} s, dedup "
              f"{st['dedup']:.4f} s, pairing+records "
              f"{res['seconds'] - sum(st.values()):.3f} s; {res['waves']} "
              f"extension waves (all from the {fs['host_reads']} reads on the "
              "staged path)")
        if tag == "pe+fused":
            ref_st = chain_run["runs"]["pe+seed+sa+chain"]["stages"]
            print(f"  {tag}: phase 13's staged run of the same batch: " + ", ".join(
                f"{k} {v:.4f}" for k, v in ref_st.items()) + " s")
            busy, wall = _device_busy(port, r["batch"], dev)
            print(f"  {tag}: again under torch.profiler: card busy {busy:.4f} s "
                  f"of {wall:.2f} s, idle share {1 - busy / wall:.4f}")
        out[tag] = res
    return dict(runs=out, launches=out["pe+fused"]["fused_launches"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from bwamem_tpu_torch import BwaMemIndex
    from bwamem_tpu_torch.engine import exec_ctx
    from bwamem_tpu_torch.ops import extend as ext

    exec_ctx.KEEP_LARGEST = True  # the timing phases reuse the largest batches
    dev = torch.device("cuda", 0)
    card = _card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    phase_build()

    print("[3] kernel vs plain PyTorch (card) vs host C++ ksw_extend2, "
          "tolerance 0 (int32, exact)")
    err3 = phase_kernel_vs_plain(dev, ext.ksw_extend_cuda)

    print("[4] main path: BwaMemAligner(device='cuda') vs the host oracle")
    t0 = time.perf_counter()
    codes, img, build_s = _synthetic_index(ECOLI_LEN)
    index = BwaMemIndex(img)
    print(f"  genome 4.6 Mbp + index in {time.perf_counter() - t0:.1f} s "
          f"(build {build_s:.1f} s)")
    runs = phase_main_path(dev, index, codes)

    print("[5] kernel timing on the largest PE wave")
    ms, plain_ms, err5, ksw_bound = phase_timing(dev, runs["pe"]["wave"])

    print("[6] FM kernels vs plain PyTorch (card) vs host FMIndex, tolerance 0 "
          "(integers, exact)")
    fm = index._require().fm
    fm_err = phase_fm_kernels(dev, fm)

    print("[7] device SA stage: BwaMemAligner(device='cuda', "
          "device_stages=('sa_lookup',)) vs the host oracle")
    sa = phase_device_sa(dev, index, fm, runs)

    print("[8] chr20 scale: 64 Mbp genome, seeding, SA walks and extension on "
          "the card")
    big = phase_chr20(dev)

    print("[9] op probe (port of benchmarks/mosaic_probe.py)")
    probe = phase_probe(dev)

    print("[10] seeding kernels vs plain PyTorch (card) vs host oracle, "
          "tolerance 0 (integers, exact)")
    seed_k = phase_seed_kernels(dev, fm, codes, runs["pe"]["batch"])

    print("[11] device seed stage: BwaMemAligner(device='cuda', "
          "device_stages=('seed', 'sa_lookup') / ('seed',)) vs the host oracle")
    seed_run = phase_device_seed(dev, index, runs)

    print("[12] chain kernels vs plain PyTorch (card) vs host C++ vs host "
          "oracle, tolerance 0 (integers and bit-equal doubles, exact)")
    chain_k = phase_chain_kernels(dev, index, runs["pe"]["batch"])

    print("[13] device chain stage: BwaMemAligner(device='cuda', "
          "device_stages=('seed', 'sa_lookup', 'chain') / ('chain',)) vs the "
          "host oracle")
    chain_run = phase_device_chain(dev, index, runs)

    print("[14] chain-to-region kernels vs plain PyTorch (card) vs host wave "
          "runner vs host oracle, tolerance 0 (integers and bit-equal doubles, "
          "exact)")
    fused_k = phase_chain2aln_kernels(dev, index, runs["pe"]["batch"])

    print("[15] fused device path: BwaMemAligner(device='cuda', "
          "device_pipeline=True) vs the host oracle")
    fused_run = phase_fused(dev, index, runs, chain_run, big)
    big["index"].close()
    index.close()

    fm_src = "bwamem_tpu_torch/csrc/fmindex.cu"
    print(json.dumps({"kernels": [
        {"name": "ksw_extend", "route": "cuda",
         "source": "bwamem_tpu_torch/csrc/extend.cu",
         "replaces": "bwamem_tpu/ops/extend_pallas.py:83",
         "launches": runs["pe"]["launches"], "max_abs_err": max(err3, err5),
         "ms": ms, "plain_ms": plain_ms, **ksw_bound},
        {"name": "occ4", "route": "cuda", "source": fm_src,
         "replaces": "bwamem_tpu/ops/fmindex_tpu.py:249",
         "launches": big["launches"]["occ4"],
         "max_abs_err": max(fm_err["occ4"], big["rank"]["occ4"][2]),
         "ms": big["rank"]["occ4"][0], "plain_ms": big["rank"]["occ4"][1],
         **big["rank"]["occ4"][3]},
        {"name": "bwt_extend", "route": "cuda", "source": fm_src,
         "replaces": "bwamem_tpu/ops/fmindex_tpu.py:296",
         "launches": big["launches"]["bwt_extend"],
         "max_abs_err": max(fm_err["bwt_extend"], big["rank"]["bwt_extend"][2]),
         "ms": big["rank"]["bwt_extend"][0],
         "plain_ms": big["rank"]["bwt_extend"][1],
         **big["rank"]["bwt_extend"][3]},
        {"name": "sa_lookup", "route": "cuda", "source": fm_src,
         "replaces": "bwamem_tpu/ops/fmindex_tpu.py:382",
         "launches": sa["pe"]["launches"],
         "max_abs_err": max(fm_err["sa_lookup"], seed_k["walks_err"]),
         "ms": big["sa_ms"], "plain_ms": big["sa_plain_ms"], **big["sa_bound"]},
        {"name": "backward_search", "route": "cuda", "source": fm_src,
         "replaces": "bwamem_tpu/ops/seed_tpu.py:27",
         "launches": big["launches"]["backward_search"],
         "max_abs_err": big["rank"]["backward_search"][2],
         "ms": big["rank"]["backward_search"][0],
         "plain_ms": big["rank"]["backward_search"][1],
         **big["rank"]["backward_search"][3]},
        {"name": "op_probe", "route": "cuda",
         "source": "bwamem_tpu_torch/csrc/op_probe.cu",
         "replaces": "benchmarks/mosaic_probe.py:44",
         "launches": probe["launches"], "max_abs_err": probe["err"],
         "ms": probe["ms"], "plain_ms": probe["plain_ms"], **probe["bound"]},
    ] + [
        {"name": name, "route": "cuda", "source": "bwamem_tpu_torch/csrc/seed.cu",
         "replaces": SEED_REPLACES[name],
         "launches": seed_run["calls"][name],
         "launches_are": f"calls of the __device__ function {name} inside "
                         "collect_intv_kernel in the main path's run, as that "
                         "kernel counts them",
         "own_kernel_launches": seed_run["launches"][name],
         "max_abs_err": seed_k[name]["err"], "ms": seed_k[name]["ms"],
         "plain_ms": seed_k[name]["plain_ms"], **seed_k[name]["bound"]}
        for name in ("smem1a", "strategy1")
    ] + [
        {"name": name, "route": "cuda", "source": "bwamem_tpu_torch/csrc/seed.cu",
         "replaces": SEED_REPLACES[name],
         "launches": seed_run["launches"][name],
         "max_abs_err": seed_k[name]["err"], "ms": seed_k[name]["ms"],
         "plain_ms": seed_k[name]["plain_ms"], **seed_k[name]["bound"]}
        for name in ("collect_intv", "sample_ks")
    ] + [
        {"name": name, "route": "cuda", "source": "bwamem_tpu_torch/csrc/chain.cu",
         "replaces": "bwamem_tpu/ops/chain_tpu.py:41",
         "launches": chain_run["launches"][name],
         "max_abs_err": chain_k[name]["err"], "ms": chain_k[name]["ms"],
         "plain_ms": chain_k[name]["plain_ms"], **chain_k[name]["bound"]}
        for name in ("chain", "chain_emit")
    ] + [
        {"name": name, "route": "cuda",
         "source": "bwamem_tpu_torch/csrc/chain2aln.cu",
         "replaces": "bwamem_tpu/ops/pipeline_fused.py:111",
         "launches": fused_run["launches"][name],
         "max_abs_err": fused_k[name]["err"], "ms": fused_k[name]["ms"],
         "plain_ms": fused_k[name]["plain_ms"], **fused_k[name]["bound"]}
        for name in ("chain2aln_prep", "chain2aln")
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
