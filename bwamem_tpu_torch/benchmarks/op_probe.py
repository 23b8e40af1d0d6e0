"""Microprobes of op costs on an NVIDIA card: the port of
benchmarks/mosaic_probe.py.

    python -m bwamem_tpu_torch.benchmarks.op_probe

The same nine probes, with the same names, shapes, dtypes, bodies and
per-iteration op counts, run in one hand-written kernel each
(``csrc/op_probe.cu``):

  * wide32 / wide16 / row32 / scal32 — v = v + v, 32 times, elementwise
  * reduce / reduce-sub — v + max(v) along the lanes / along axis 0
  * roll-lane / roll-sub — roll by one along the lanes / along axis 0
  * prefmax — log-step inclusive prefix max along the lanes

Method: K dependent iterations inside one kernel launch; device time per
iteration from the t(K=16384) - t(K=2048) slope (each t the least of 3
launches timed with CUDA events), per op from the probe's op count.  Before
timing, ``main`` checks in the SASS (``cuobjdump -sass``) that each
kernel's K loop still holds its ops, and prints the counts.

``probe_torch`` is the plain PyTorch version of each body; ``run_probe``
takes it for CPU tensors and launches the kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

B = 512
# launches of the CUDA kernel; bumped only where it is launched
LAUNCHES = 0


def _adds(v):
    for _ in range(32):
        v = v + v
    return v


def _reduce(v):
    return v + v.amax(dim=1, keepdim=True)


def _roll_lane(v):
    for _ in range(8):
        v = torch.roll(v, 1, dims=1) + 1
    return v


def _roll_sub(v):
    for _ in range(8):
        v = torch.roll(v, 1, dims=0) + 1
    return v


def _reduce_sub(v):
    return v + v.amax(dim=0, keepdim=True)


def _prefmax(v):
    col = torch.arange(v.shape[1], device=v.device)[None, :]
    low = v.new_full((), -(1 << 30))
    P = v
    k = 1
    while k < 128:
        P = torch.maximum(P, torch.where(col >= k, torch.roll(P, k, dims=1), low))
        k <<= 1
    return P


@dataclass(frozen=True)
class Probe:
    name: str
    body: Callable[[torch.Tensor], torch.Tensor]
    shape: Tuple[int, int]
    dtype: torch.dtype
    per_iter_ops: int
    kernel: str  # the kernel's name in csrc/op_probe.cu
    # SASS opcodes that carry the body's op, and how many of them one
    # iteration of the kernel's loop must hold per thread
    sass_ops: Tuple[str, ...]
    sass_min: int


_ADD = ("IADD3", "IADD", "VIADD", "IMAD", "LEA", "SHF", "SHL", "HADD2",
        "VIADD2")

PROBES = (
    Probe("wide32", _adds, (B, 128), torch.int32, 32, "probe_wide32",
          _ADD, 32 * 4),
    Probe("wide16", _adds, (B, 128), torch.int16, 32, "probe_wide16",
          _ADD, 32 * 4),
    Probe("scal32", _adds, (B, 1), torch.int32, 32, "probe_scal32", _ADD, 32),
    Probe("row32", _adds, (8, 128), torch.int32, 32, "probe_row32", _ADD,
          32 * 4),
    Probe("reduce", _reduce, (B, 128), torch.int32, 1, "probe_reduce",
          ("REDUX", "SHFL"), 1),
    Probe("roll-lane", _roll_lane, (B, 128), torch.int32, 8,
          "probe_roll_lane", ("SHFL",), 8),
    Probe("roll-sub", _roll_sub, (128, B), torch.int32, 8, "probe_roll_sub",
          ("BAR",), 8),
    Probe("reduce-sub", _reduce_sub, (128, B), torch.int32, 1,
          "probe_reduce_sub", ("BAR",), 1),
    Probe("prefmax", _prefmax, (B, 128), torch.int32, 1, "probe_prefmax",
          ("SHFL",), 1 + 2 + 4 * 5),
)


def probe_torch(p: Probe, x: torch.Tensor, K: int) -> torch.Tensor:
    """K iterations of the probe's body, plain PyTorch."""
    for _ in range(K):
        x = p.body(x)
    return x


def _bind(lib):
    fn = lib.bwamem_op_probe_launch
    fn.restype = ctypes.c_int
    i32, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i32, p, p, i32, i32, i32, p]


def probe_cuda(p: Probe, x: torch.Tensor, K: int) -> torch.Tensor:
    """K iterations of the probe's body in its kernel, on a CUDA tensor of
    the probe's shape and dtype."""
    global LAUNCHES
    from ..utils import cudabuild

    if x.device.type != "cuda":
        raise ValueError(f"probe_cuda needs a CUDA tensor, got {x.device}")
    if tuple(x.shape) != p.shape or x.dtype != p.dtype:
        raise ValueError(f"{p.name} takes {p.dtype} {p.shape}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not 0 <= K < 2**31:
        raise ValueError("K must be a non-negative int32")
    lib = cudabuild.load("op_probe", _bind)
    x = x.contiguous()
    out = torch.empty_like(x)
    rc = lib.bwamem_op_probe_launch(
        PROBES.index(p), x.data_ptr(), out.data_ptr(), p.shape[0], p.shape[1],
        K, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"op_probe kernel {p.kernel} launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    return out


def run_probe(p: Probe, x: torch.Tensor, K: int) -> torch.Tensor:
    """CPU tensors -> ``probe_torch``; CUDA tensors -> the kernel."""
    return (probe_cuda if x.device.type == "cuda" else probe_torch)(p, x, K)


# ------------------------------------------------------------------ SASS

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                    r"([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"(\.L_x_\d+|0x[0-9a-f]+)")


def parse_loops(sass: str) -> Dict[str, Counter]:
    """``cuobjdump -sass`` text -> for each function, the opcodes (without
    modifiers) of its largest loop: the instructions from a backward
    branch's target up to that branch."""
    funcs: Dict[str, list] = {}
    labels: Dict[str, Dict[str, int]] = {}
    cur = None
    pending = []
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = m.group(1)
            funcs[cur], labels[cur] = [], {}
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[cur][lab] = addr
            pending = []
            funcs[cur].append((addr, m.group(3).split(".")[0], m.group(4)))
    loops = {}
    for name, ins in funcs.items():
        best = Counter()
        for addr, op, args in ins:
            if op != "BRA":
                continue
            t = _TARGET.search(args)
            if not t:
                continue
            tgt = t.group(1)
            dest = labels[name].get(tgt) if tgt.startswith(".") else int(tgt, 16)
            if dest is None or dest >= addr:
                continue
            body = Counter(o for a, o, _ in ins if dest <= a <= addr)
            if sum(body.values()) > sum(best.values()):
                best = body
        loops[name] = best
    return loops


def sass_check(lib_path: str) -> Dict[str, Counter]:
    """Each probe kernel's K-loop opcodes from the built library; raises if
    a loop is missing or holds fewer of its ops than the body needs."""
    from ..utils import cudabuild

    tool = os.path.join(os.path.dirname(cudabuild.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], check=True,
                          capture_output=True, text=True).stdout
    loops = parse_loops(sass)
    for p in PROBES:
        body = loops.get(p.kernel, Counter())
        n = sum(body[o] for o in p.sass_ops)
        ops = "adds" if p.sass_ops == _ADD else "/".join(p.sass_ops)
        print(f"  sass {p.kernel:17s} loop {sum(body.values()):4d} instrs, "
              f"{ops:10s} {n:4d} (need >= {p.sass_min})", flush=True)
        if n < p.sass_min:
            raise RuntimeError(f"{p.kernel}: the K loop lost its ops "
                               f"({dict(body)})")
    return loops


# ---------------------------------------------------------------- timing

def _launch_ms(p: Probe, x: torch.Tensor, K: int, reps: int = 3) -> float:
    probe_cuda(p, x, K)  # warm-up
    best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        probe_cuda(p, x, K)
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def timed(p: Probe, device, k_small: int = 2048, k_big: int = 16384):
    """Seconds per iteration of the probe's body on ``device`` (a card)."""
    x = torch.ones(p.shape, dtype=p.dtype, device=device)
    ts = _launch_ms(p, x, k_small)
    tb = _launch_ms(p, x, k_big)
    return (tb - ts) / 1e3 / (k_big - k_small)


def main() -> int:
    if not torch.cuda.is_available():
        print("op_probe: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from ..utils import cudabuild

    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(dev)} ({card})", flush=True)
    sass_check(cudabuild.build("op_probe"))
    for p in PROBES:
        dt = timed(p, dev)
        ns_per_op = dt / p.per_iter_ops * 1e9
        print(f"{p.name:10s} {dt*1e6:9.3f} us/iter  {ns_per_op:8.2f} ns/op",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
