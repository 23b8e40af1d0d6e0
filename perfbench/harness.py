"""The benchmark's runner: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The cell's configuration, traffic mix and metrics are found by their names
in ``BENCHMARK.json``: ``perfbench/configs/<config>.json`` (named by the
configuration's ``file``), ``perfbench/traffic/<traffic>.json`` and
``perfbench/metrics/<metric>.py``, one reader a metric.  A run:

1. set-up, timed from the process's start as ``setup_s``: the program
   imported with the configuration's ``threads`` (as ``bwa mem -t``), the
   CUDA context made, the configuration's genome (its contigs, and which
   are ALT haplotypes) and the program's index image loaded (made and
   cached under ``perfbench/.cache/<config>/`` by the first run in a
   checkout), the aligner opened, the run's batches
   ordered by ``--seed``, a slice of them aligned on the staged route and
   ``warmup_batches`` whole batches on the default one, so that every
   kernel is built and loaded before the window.  Where the run profiles,
   the profiler's first session (its tracer's start and one more batch
   under it) follows; it is the benchmark's instrument, which no user's
   process runs, and its seconds are printed apart, not in ``setup_s``;
2. the window: ``align_seqs`` on one batch after another, a closed loop
   with one client, until a batch ends past ``--seconds``; each batch's
   records are counted, the sampled ones copied, the rest dropped; the
   card's activity is profiled throughout where an end-to-end metric reads
   it, and under ``--trace 1`` (with the host's too, and the program's
   stages as labelled ranges);
3. the device's peak memory read, the program's state freed, and the
   sample of the window's answers held against the plain reference (which
   also counts, once in a checkout, the work that the rooflines divide:
   ``perfbench/work.py``);
4. one JSON line on standard output: the end-to-end metrics (``--trace
   0``) or the per-layer metrics (``--trace 1``), the device, and last the
   numbers that decided ``correct``, each beside its limit (also the last
   lines of standard error).

It exits non-zero and prints no result without the cards the cell asks
for, or when a module of JAX or of the JAX package is loaded once the
window has closed.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from contextlib import nullcontext
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "bwamem_tpu")


def load_cell(workload: str, root: str = ROOT) -> dict:
    """The cell's entry, configuration, traffic and metrics, by name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "perfbench", "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return dict(root=root, workload=w, config=cfg, traffic=traffic,
                end_to_end=e2e, per_layer=layer)


def metric_module(root: str, name: str):
    """``perfbench/metrics/<name>.py``: its ``read(ctx)``, and
    ``NEEDS_WORK`` where it divides the reference's work count."""
    path = os.path.join(root, "perfbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def set_threads(cfg: dict) -> None:
    """The configuration's host threads (``bwa mem -t``), for the program's
    OpenMP loops and torch's; before either is loaded."""
    os.environ["OMP_NUM_THREADS"] = str(cfg["threads"])


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _open_index(cfg: dict, genome, cache: str):
    """The program's index image of the genome: made by the port's
    ``build_index`` at the configuration's ``sa_intv`` the first time, one
    FASTA contig a contig in the configuration's order, with the ALT
    contigs named in ``ref.alt`` beside it (as ``hs38DH.fa.alt`` lies beside
    its FASTA) and flagged by the port's ``read_alt_into``, as bwa's
    ``bns_restore`` flags them; then loaded, as a deployment loads a bwa
    image."""
    from bwamem_tpu_torch import BwaMemIndex
    from bwamem_tpu_torch.index import image
    from bwamem_tpu_torch.index.build import build_index
    from bwamem_tpu_torch.index.bwtfile import read_alt_into
    from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig

    path = os.path.join(cache, "ref.img")
    if not os.path.exists(path):
        idx = build_index(Fasta([FastaContig(name, "", codes)
                                 for name, codes in genome.contigs]),
                          sa_intv=cfg["index"]["sa_intv"])
        if genome.alt:
            alt = os.path.join(cache, "ref.alt")
            with open(alt, "w") as f:
                f.writelines(f"{name}\n" for name, _ in genome.contigs
                             if name in genome.alt)
            read_alt_into(alt, idx.bns)
        tmp = f"{path}.{os.getpid()}.tmp"
        image.write_image(tmp, idx)
        os.replace(tmp, path)
        del idx
    return BwaMemIndex(path)


def _aligner(index, traffic: dict, device: str, **kw):
    """The port's aligner as a caller of this traffic opens it (on the
    default route unless ``kw`` names another), paired with the traffic's
    insert statistics."""
    from bwamem_tpu_torch import BwaMemAligner, BwaMemPairEndStats

    aligner = BwaMemAligner(index, device=device, **kw)
    if traffic["paired"]:
        aligner.align_pairs()
        p = traffic["pe_stats"]
        aligner.set_proper_pair_end_stats(BwaMemPairEndStats.of(
            p["average"], p["std"], p["low"], p["high"]))
    return aligner


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None) -> dict:
    """One run of ``cell``; returns the result object (``checks`` last)."""
    t0 = time.perf_counter() if t0 is None else t0
    split = {}

    def mark(name, since):
        now = time.perf_counter()
        split[name] = now - since
        return now

    t = time.perf_counter()
    split["interpreter_and_torch"] = t - t0
    import torch

    torch.set_num_threads(int(cell["config"]["threads"]))

    from bwamem_tpu_torch.engine.pipeline_device import FUSED_STATS
    from bwamem_tpu_torch.utils.timers import TIMERS

    from . import check, genome as genome_mod, traffic as traffic_mod
    from . import trace as trace_mod
    from . import work as work_mod

    t = mark("import", t)
    on_card = device.startswith("cuda")
    if on_card:
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    t = mark("cuda_context", t)
    cfg, tr = cell["config"], cell["traffic"]
    cache = os.path.join(cell["root"], "perfbench", ".cache", cfg["name"])
    genome = genome_mod.load(cfg, cache)
    t = mark("genome", t)
    index = _open_index(cfg, genome, cache)
    t = mark("index_image", t)
    aligner = _aligner(index, tr, device)
    pool = traffic_mod.make_pool(tr, genome, seed)
    t = mark("traffic", t)
    # the fused path sends the reads a budget flags through the staged
    # route (host seeding and chaining, the extension waves): align a slice
    # of the cell's reads on that route, so that its libraries and kernels
    # are built and loaded before the window, whichever reads it meets
    _aligner(index, tr, device, device_pipeline=False).align_seqs(
        pool[0].seqs[:tr["warmup_staged_reads"]])
    t = mark("warmup_staged_route", t)
    # the card's activity is profiled in a --trace 0 run only where an
    # end-to-end metric reads it (the profiler's start costs seconds)
    watch = on_card and any(
        m["source"] == "device_trace" for m in cell["end_to_end"])
    for i in range(tr["warmup_batches"]):
        aligner.align_seqs(pool[i % len(pool)].seqs)
        if on_card:
            torch.cuda.synchronize()
        t = mark(f"warmup_batch_{i}", t)
    profiling_s = 0.0
    if watch or trace:
        # the profiler's first session starts its tracer: do that here, and
        # keep its seconds out of setup_s
        p0 = t
        prof = trace_mod.profiler(trace, on_card)
        prof.start()
        t = mark("profiler_start", t)
        aligner.align_seqs(pool[0].seqs)
        if on_card:
            torch.cuda.synchronize()
        t = mark("warmup_batch_profiled", t)
        prof.stop()
        del prof
        t = mark("profiler_stop", t)
        profiling_s = t - p0

    # ------------------------------------------------------------ window
    sample = check.Sample(tr["sample"], seed, tr["paired"])
    gc.collect()
    TIMERS.reset()
    FUSED_STATS.reset()
    lat, reads, unanswered, b = [], 0, 0, 0
    prof = trace_mod.profiler(trace, on_card) if (watch or trace) else None
    ranges = (trace_mod.stage_ranges(TIMERS) if trace
              else nullcontext())
    with ranges:
        if prof is not None:
            p0 = time.perf_counter()
            prof.start()
            profiling_s += time.perf_counter() - p0
        setup_s = time.perf_counter() - t0 - profiling_s
        with (torch.profiler.record_function(trace_mod.WINDOW) if trace
              else nullcontext()):
            w0 = time.perf_counter()
            deadline = w0 + seconds
            while True:
                pool_no = b % len(pool)
                batch = pool[pool_no]
                s = time.perf_counter()
                with (torch.profiler.record_function(trace_mod.BATCH)
                      if trace else nullcontext()):
                    out = aligner.align_seqs(batch.seqs)
                e = time.perf_counter()
                lat.append(e - s)
                reads += len(batch)
                unanswered += (len(batch) if len(out) != len(batch)
                               else out.count([]))
                if len(out) == len(batch):
                    sample.offer(pool_no, out)
                del out
                b += 1
                if e >= deadline:
                    break
            if on_card:
                torch.cuda.synchronize()
            w1 = time.perf_counter()
        if prof is not None:
            prof.stop()
    stage_s = TIMERS.snapshot()
    fused = dict(device_reads=FUSED_STATS.device_reads,
                 host_reads=FUSED_STATS.host_reads,
                 seconds=dict(FUSED_STATS.seconds))
    leaked = forbidden_modules()
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name() if on_card else "cpu",
               count=cell["workload"]["chips"],
               memory_peak_bytes=int(torch.cuda.max_memory_allocated())
               if on_card else 0)
    card = host = None
    if prof is not None:
        card = trace_mod.device_summary(prof)
        if trace:
            host = trace_mod.host_summary(prof, card["busy"])
        del prof
    window_s = w1 - w0
    _say("window: " + json.dumps(dict(
        seconds=window_s, batches=b, reads=reads,
        reads_per_s=reads / window_s, stage_s=stage_s, fused=fused)))
    _say("setup split: " + json.dumps(dict(
        setup_s=setup_s, profiling_s=profiling_s, **split,
        threads=dict(torch=torch.get_num_threads(),
                     omp=os.environ.get("OMP_NUM_THREADS")))))

    # ------------------------------------------- against the reference
    del aligner
    index.close()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    tc = time.perf_counter()
    ref = check.reference_index(genome, device)
    cmp = check.compare(sample, pool, ref, tr)
    _say(f"reference: {time.perf_counter() - tc:.3f} s for "
         f"{cmp['reads']} sampled reads")
    for d in cmp["shown"]:
        _say("differs: " + json.dumps(d))
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    mods = {m["name"]: metric_module(cell["root"], m["name"]) for m in wanted}
    work = None
    if any(getattr(mod, "NEEDS_WORK", False) for mod in mods.values()):
        tc = time.perf_counter()
        work = work_mod.cached(cache, cell["workload"]["traffic"], ref, tr,
                               genome)
        _say(f"work: {time.perf_counter() - tc:.3f} s; " + json.dumps(work))

    ctx = SimpleNamespace(
        seconds=window_s, reads=reads, batches=b, latencies_s=lat,
        setup_s=setup_s, stage_s=stage_s, fused=fused, card=card, host=host,
        kind=dev["kind"], read_len=tr["read_len"], seq_len=ref.seq_len,
        work=work)
    metrics = {}
    for m in wanted:
        v = mods[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    result = dict(correct=False, attempted=reads, failed=unanswered,
                  metrics=metrics, device=dev)
    if trace:
        dev["busy_s"] = card["busy_s"] if card else 0.0
        dev["window_s"] = host["window_s"] if host else window_s
        if card:
            by_short = {}
            for name, sec in card["by_name"].items():
                k = trace_mod.short_name(name)
                by_short[k] = by_short.get(k, 0.0) + sec
            top = sorted(by_short.items(), key=lambda kv: -kv[1])
            gaps = sorted(host["idle_by_stage"].items(),
                          key=lambda kv: -kv[1])
            result["breakdown"] = dict(device_ops=[list(x) for x in top[:10]],
                                       idle_gaps=[list(x) for x in gaps[:10]])
    checks = dict(
        reads_unanswered=dict(value=unanswered, limit=0),
        sampled_reads_differing=dict(value=cmp["differ"], limit=0),
        sampled_reads_compared=dict(value=cmp["reads"],
                                    limit=f">= {min(tr['sample'], 1)}"),
    )
    result["correct"] = (unanswered == 0 and cmp["differ"] == 0
                         and cmp["reads"] >= 1)
    result["checks"] = checks
    result["forbidden_modules"] = leaked
    return result


def main(argv=None, t0: float | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    cache = os.path.join(ROOT, "perfbench", ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    set_threads(cell["config"])
    import torch

    need = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        _say(f"this cell needs {need} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), t0=t0)
    leaked = result.pop("forbidden_modules") or forbidden_modules()
    if leaked:
        _say("modules of JAX or of the JAX package were loaded: "
             + ", ".join(leaked))
        return 3
    for name, c in result["checks"].items():
        _say(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
