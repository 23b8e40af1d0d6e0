#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bwamem_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit if it fails:

1. the card: its name and power limit as nvidia-smi reports them; no card
   (torch.cuda.is_available() false) exits at once;
2. build: compiles csrc/extend.cu with nvcc for sm_90a and prints the
   compiler's register and spill report;
3. kernel against plain: the SW extension kernel against the plain
   PyTorch version on the card and the host C++ ksw_extend2, field for
   field and exactly, on seeded batches (a 4096-job main-path wave, the JAX
   tests' ragged shapes, edge cases, zdrop=0, non-default scoring);
4. main path: the port's BwaMemAligner(device="cuda") aligns 6,000 pairs of
   150 bp reads (and 2,000 reads single-end) on bench.py's 4.6 Mbp "ecoli"
   synthetic genome; every record must equal bwamem_tpu's host aligner's,
   the kernel must have run, and at least half of the extension jobs must
   have gone to the card; then the PE batch runs once more under
   torch.profiler for the card's busy and idle share;
5. timing: the kernel and the plain version on the largest wave of phase 4,
   with CUDA events after a warm-up.

The last three lines are a JSON object describing each kernel, the card's
name and power limit, and {"ok": true, "device": {...}}.  Nothing of JAX is
imported.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_PAIRS = 6000
N_SE = 2000
SEED = 1234


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


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


def phase_kernel_vs_plain(dev, kernel_fn):
    """Phase 3: kernel = plain (on the card) = host C++ ksw_extend2."""
    import torch

    from bwamem_tpu.engine import native_ksw
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


def _ecoli_index():
    import numpy as np

    from bwamem_tpu.index import image
    from bwamem_tpu.index.build import build_index
    from bwamem_tpu.utils.fasta import Fasta, FastaContig
    from bwamem_tpu.utils.synth import synthetic_genome

    codes = synthetic_genome(4_600_000, np.random.default_rng(SEED))
    img = os.path.join(ROOT, "build", "smoke", f"ecoli_{SEED}_sa8.img")
    if not os.path.exists(img):
        os.makedirs(os.path.dirname(img), exist_ok=True)
        idx = build_index(Fasta([FastaContig("chr", "", codes)]), sa_intv=8)
        image.write_image(img + ".tmp", idx)
        os.replace(img + ".tmp", img)
    return codes, img


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


def _timed(aligner, reads, sync):
    t0 = time.perf_counter()
    out = aligner.align_seqs(reads)
    sync()
    return out, time.perf_counter() - t0


def phase_main_path(dev):
    """Phase 4: the port's aligner against the host aligner, PE and SE."""
    import numpy as np
    import torch

    from bwamem_tpu import BwaMemAligner as HostAligner
    from bwamem_tpu import BwaMemIndex, BwaMemPairEndStats
    from bwamem_tpu.utils.synth import simulate_pairs
    from bwamem_tpu.utils.timers import TIMERS
    from bwamem_tpu_torch import BwaMemAligner
    from bwamem_tpu_torch.engine.extend_batch import STATS
    from bwamem_tpu_torch.ops import extend as ext

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    codes, img = _ecoli_index()
    index = BwaMemIndex(img)
    rng = np.random.default_rng(SEED + 1)
    warm = simulate_pairs(codes, rng, 8)
    reads = simulate_pairs(codes, rng, N_PAIRS)
    print(f"  genome 4.6 Mbp + index + {len(reads)} reads in "
          f"{time.perf_counter() - t0:.1f} s")
    runs = {}
    for mode, batch in (("pe", reads), ("se", reads[:N_SE])):
        host, port = HostAligner(index), BwaMemAligner(index, device=dev)
        if mode == "pe":
            for a in (host, port):
                a.align_pairs()
                a.set_proper_pair_end_stats(BwaMemPairEndStats.of(350, 35))
        for a in (host, port):
            a.align_seqs(warm)
        ref, t_host = _timed(host, batch, sync)
        STATS.reset()
        TIMERS.reset()
        ext.LAUNCHES = 0
        got, t_port = _timed(port, batch, sync)
        launches = ext.LAUNCHES
        stages = TIMERS.snapshot()
        ok = sum(
            [vars(x) for x in g] == [vars(x) for x in r] for g, r in zip(got, ref)
        )
        aligned = sum(1 for r in got if r and not (r[0].sam_flag & 0x4))
        share = STATS.device_share()
        print(f"  {mode}: {len(batch)} reads, records equal {ok}/{len(batch)}, "
              f"aligned {aligned}; port {len(batch) / t_port:.1f} reads/s "
              f"({t_port:.2f} s), host {len(batch) / t_host:.1f} reads/s "
              f"({t_host:.2f} s)")
        print(f"  {mode}: kernel launches {launches}, device_extend_jobs "
              f"{STATS.device_extend_jobs} in {STATS.device_extend_waves} waves, "
              f"host_extend_jobs {STATS.host_extend_jobs} in "
              f"{STATS.host_extend_waves} waves, device share {share:.4f}")
        rest = t_port - sum(stages.values())
        print(f"  {mode}: port seconds by stage: " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages.items())
            + f", pairing+records {rest:.3f}; inside extend: device waves "
            f"{STATS.device_wave_seconds:.3f} (pack, copies, kernel), host "
            f"waves {STATS.host_wave_seconds:.3f}")
        if ok != len(batch):
            raise AssertionError(f"{mode}: records differ from the host aligner")
        if aligned < 0.95 * len(batch):
            raise AssertionError(f"{mode}: only {aligned} reads aligned")
        if launches <= 0 or share < 0.5:
            raise AssertionError(f"{mode}: the extension did not run on the card")
        runs[mode] = dict(launches=launches, wave=STATS.largest_wave)
        if mode == "pe":
            busy, wall = _device_busy(port, batch, dev)
            print(f"  pe: again under torch.profiler: card busy {busy:.4f} s of "
                  f"{wall:.2f} s, idle share {1 - busy / wall:.4f}")
    index.close()
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


def phase_timing(dev, wave):
    """Phase 5: kernel and plain version on the largest main-path wave."""
    import torch

    from bwamem_tpu.api.options import MemOptions
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
    print(f"  largest wave B={B} Q={Q} T={t.shape[1]}: kernel {ms:.4f} ms, "
          f"ksw_extend_cuda (checks, conversions, kernel) {wrapper_ms:.4f} ms, "
          f"plain PyTorch {plain_ms:.4f} ms")
    return ms, plain_ms, err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from bwamem_tpu_torch.ops import extend as ext
    from bwamem_tpu_torch.utils import cudabuild

    dev = torch.device("cuda", 0)
    card = _card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib = cudabuild.build("extend")
    info = cudabuild.BUILD_INFO["extend"]
    print(f"[2] nvcc built {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in info["log"].splitlines():
        print(f"    {line}")

    print("[3] kernel vs plain PyTorch (card) vs host C++ ksw_extend2, "
          "tolerance 0 (int32, exact)")
    err3 = phase_kernel_vs_plain(dev, ext.ksw_extend_cuda)

    print("[4] main path: BwaMemAligner(device='cuda') vs bwamem_tpu host")
    runs = phase_main_path(dev)

    print("[5] kernel timing on the largest PE wave")
    ms, plain_ms, err5 = phase_timing(dev, runs["pe"]["wave"])

    print(json.dumps({"kernels": [{
        "name": "ksw_extend", "route": "cuda",
        "source": "bwamem_tpu_torch/csrc/extend.cu",
        "replaces": "bwamem_tpu/ops/extend_pallas.py:83",
        "launches": runs["pe"]["launches"], "max_abs_err": max(err3, err5),
        "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
