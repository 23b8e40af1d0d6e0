#!/usr/bin/env python3
"""Times the wave kernel of bwamem_tpu_torch (csrc/extend.cu) with lane
groups of 32, 16 and 8 lanes a job, on one NVIDIA card.

    python3 tools/ksw_group_timing.py

The package builds one width, extend.cu's ``kGroup``.  This script builds
the other two from copies of csrc/extend.cu and the csrc headers under
build/ksw_groups/, with that one constant changed, by the same nvcc flags
as utils/cudabuild.py, and prints each build's register report.  It aligns
chip_smoke.py's ecoli PE batch (6,000 pairs of the 4.6 Mbp synthetic genome,
seed 1234) with ``BwaMemAligner(device="cuda")`` to record the largest
extension wave, holds every width's results on that wave and on the
extension cases of utils/extend_cases.py against the package's kernel
(exactly), then times each width on the wave and on its heaviest job alone
with CUDA events, in turns (shipped, the others, the others again, shipped).
The last line is one JSON object of the times.  Nothing of JAX is imported.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the ecoli genome, index and timing helpers)

WIDTHS = (32, 16, 8)
LINE = "constexpr int kGroup = {};  // lanes a job"


def _build(width: int, shipped: int) -> str:
    """The wave kernel at ``width`` lanes a job: a copy of the sources with
    kGroup changed, compiled into build/ksw_groups/g<width>/."""
    from bwamem_tpu_torch.utils import cudabuild

    out = os.path.join(ROOT, "build", "ksw_groups", f"g{width}")
    os.makedirs(out, exist_ok=True)
    for header in os.listdir(cudabuild.CSRC):  # extend.cu's includes
        if header.endswith(".cuh"):
            shutil.copy(os.path.join(cudabuild.CSRC, header), out)
    with open(os.path.join(cudabuild.CSRC, "extend.cu")) as f:
        src = f.read()
    if src.count(LINE.format(shipped)) != 1:
        raise RuntimeError("extend.cu no longer declares kGroup as expected")
    with open(os.path.join(out, "extend.cu"), "w") as f:
        f.write(src.replace(LINE.format(shipped), LINE.format(width)))
    lib = os.path.join(out, "libextend.so")
    res = subprocess.run(
        [cudabuild.nvcc_path(), *cudabuild.ARCH_FLAGS, *cudabuild.FLAGS, "-o",
         lib, os.path.join(out, "extend.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {width} lanes:\n{res.stderr}")
    print(f"[build] {width} lanes a job:\n" + "\n".join(
        "  " + ln for ln in (res.stdout + res.stderr).splitlines()
        if "registers" in ln or "spill" in ln))
    return lib


def _largest_wave(dev):
    import numpy as np

    from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex
    from bwamem_tpu_torch.engine import exec_ctx
    from bwamem_tpu_torch.engine.extend_batch import STATS
    from bwamem_tpu_torch.utils.synth import simulate_pairs

    exec_ctx.KEEP_LARGEST = True
    codes, img, _ = chip_smoke._synthetic_index(chip_smoke.ECOLI_LEN)
    rng = np.random.default_rng(chip_smoke.SEED + 1)
    warm = simulate_pairs(codes, rng, 8)
    reads = simulate_pairs(codes, rng, chip_smoke.N_PAIRS)
    with BwaMemIndex(img) as index:
        port = BwaMemAligner(index, device=dev)
        chip_smoke._pe_setup(port)
        port.align_seqs(warm)
        STATS.reset()
        port.align_seqs(reads)
    return STATS.largest_wave


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ksw_group_timing: no CUDA card", file=sys.stderr)
        return 1
    from bwamem_tpu_torch.api.options import MemOptions
    from bwamem_tpu_torch.engine.state import device_scoring
    from bwamem_tpu_torch.ops import extend as ext
    from bwamem_tpu_torch.utils.extend_cases import ARRAYS, CASES, make_case

    dev = torch.device("cuda", 0)
    card = chip_smoke._card_line()
    print(f"card: {card}")
    with open(os.path.join(ROOT, "bwamem_tpu_torch", "csrc", "extend.cu")) as f:
        src = f.read()
    shipped = next(g for g in WIDTHS if LINE.format(g) in src)
    libs = {shipped: ext._lib()}
    others = [g for g in WIDTHS if g != shipped]
    with ThreadPoolExecutor(len(others)) as ex:
        paths = dict(zip(others, ex.map(lambda g: _build(g, shipped), others)))
    for g, path in paths.items():
        lib = ctypes.CDLL(path)
        ext._bind(lib)
        libs[g] = lib

    def launch(g, q8, t8, scal, mat, plan, pen):
        out = torch.empty((6, q8.shape[0]), dtype=torch.int32, device=dev)
        nxt = torch.empty(1, dtype=torch.int32, device=dev)
        rc = libs[g].bwamem_ksw_extend_launch(
            q8.data_ptr(), q8.stride(0), t8.data_ptr(), t8.stride(0),
            scal.data_ptr(), scal.stride(0), mat.data_ptr(),
            plan.order.data_ptr(), plan.slot.data_ptr(), nxt.data_ptr(),
            plan.scratch.data_ptr(), plan.Qs, plan.Qw, out.data_ptr(),
            q8.shape[0], *pen, torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"{g} lanes: launch failed, cudaError {rc}")
        return out

    # every width against the package's kernel on the extension cases
    for name in CASES:
        case = make_case(name)
        st = case["statics"]
        qs, ts, ql, tl, h0, w, bon, mat = (torch.from_numpy(case[k]).to(dev)
                                            for k in ARRAYS)
        w_adj = ext.band_width(ql, w, bon, st["max_sc"], st["o_del"],
                               st["e_del"], st["o_ins"], st["e_ins"])
        scal = torch.stack([ql, tl, h0, w_adj], 1).int().contiguous()
        mat = mat.int().contiguous()
        q8, t8 = qs.to(torch.uint8), ts.to(torch.uint8)
        plan = ext.plan_wave(scal, mat)
        pen = tuple(st[k] for k in ("o_del", "e_del", "o_ins", "e_ins", "zdrop"))
        ref = launch(shipped, q8, t8, scal, mat, plan, pen)
        for g in others:
            if not torch.equal(launch(g, q8, t8, scal, mat, plan, pen), ref):
                raise AssertionError(f"{g} lanes differ on case {name}")
    print(f"[cases] {len(CASES)} extension cases: every width equals the "
          f"{shipped}-lane kernel")

    sc = device_scoring(MemOptions(), dev)
    opt = (sc.o_del, sc.e_del, sc.o_ins, sc.e_ins, sc.zdrop)
    q, t, qlen, tlen, h0, w, bonus = chip_smoke._wave_tensors(
        _largest_wave(dev), dev)
    w_adj = ext.band_width(qlen, w, bonus, sc.max_sc, sc.o_del, sc.e_del,
                           sc.o_ins, sc.e_ins)
    scal = torch.stack([qlen, tlen, h0, w_adj], dim=1)
    q8, t8 = q.to(torch.uint8), t.to(torch.uint8)
    plan = ext.plan_wave(scal, sc.mat)
    top = int(plan.order[0])
    one = slice(top, top + 1)
    plan1 = ext.plan_wave(scal[one], sc.mat)
    ref = launch(shipped, q8, t8, scal, sc.mat, plan, opt)
    for g in others:
        if not torch.equal(launch(g, q8, t8, scal, sc.mat, plan, opt), ref):
            raise AssertionError(f"{g} lanes differ on the largest wave")
    B, Q = q.shape
    print(f"[wave] the largest ecoli PE wave: B={B} Q={Q} T={t.shape[1]}; "
          f"every width equals the {shipped}-lane kernel; heaviest job {top}")
    times = {g: {"wave_ms": [], "job_ms": []} for g in WIDTHS}
    turns = [shipped] + others + others[::-1] + [shipped]
    for g in turns:
        times[g]["wave_ms"].append(chip_smoke._event_ms(
            lambda: launch(g, q8, t8, scal, sc.mat, plan, opt), 20, dev))
        times[g]["job_ms"].append(chip_smoke._event_ms(
            lambda: launch(g, q8[one], t8[one], scal[one], sc.mat, plan1, opt),
            20, dev))
    for g in WIDTHS:
        warps = libs[g].bwamem_ksw_extend_warps_per_sm(plan.Qw)
        print(f"[time] {g:2d} lanes a job: wave " + ", ".join(
            f"{x:.4f}" for x in times[g]["wave_ms"]) + " ms; heaviest job "
            + ", ".join(f"{x:.4f}" for x in times[g]["job_ms"])
            + f" ms; warps resident a SM {warps}")
        times[g]["warps_per_sm"] = warps
    print(card)
    print(json.dumps({"card": card, "shipped": shipped, "B": B, "Q": Q,
                      "T": int(t.shape[1]),
                      "widths": {str(g): times[g] for g in WIDTHS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
