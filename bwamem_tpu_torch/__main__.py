"""Command-line front end of the port: bwa-style `index` and `mem`.

The counterpart of bwamem_tpu/__main__.py, with its flags and its output:

    python -m bwamem_tpu_torch index ref.fa [-o ref.fa.img] [--sa-intv 8]
    python -m bwamem_tpu_torch mem ref.fa.img r1.fq [r2.fq] > out.sam

`mem` runs on the card by default (``--device cuda``), every batch through
the fused device path (seeding to regions in the port's kernels);
``--no-device-pipeline`` keeps the extension waves on the card and, with
``--device-stages``, the seeding, SA walks and chaining; ``--device cpu`` is
the whole-batch host route.  ``--devices N [--idx-shards K]`` aligns over a
mesh of the first N cards (``parallel.mesh.make_mesh(N, idx_shards=K)``,
the aligner's ``mesh``): more cards than the machine has, or ``--devices``
with ``--device cpu``, is an error (exit code 2); no flag builds a virtual
mesh.  Every route ends in the aligner's host C++
(the whole-batch call or its tail), whose records become SAM lines through
``api.sam.aln2sam``; a read's hash tie-breaks take its ordinal in the
input stream, so the output does not depend on ``-K`` or ``--shard``.
The prefetch thread only parses FASTQ; every call to the card is made on
the main thread.  The stages ``cli_open`` (the index and the aligner),
``cli_fastq`` (waiting for the next parsed chunk), ``cli_encode`` and
``cli_sam`` time the command's own work beside
the aligner's stages in ``bwamem_tpu_torch.metrics()``; with
``BWAMEM_TPU_METRICS`` set, ``mem`` dumps the snapshot after every batch
and once more when it ends.
"""
from __future__ import annotations

import argparse
import sys

TAG = "[bwamem_tpu_torch]"


class _Prefetcher:
    """Double-buffered chunk reader: the next chunk is parsed on a
    background thread while the current one aligns ([EXT] kt_pipeline's
    read/process overlap in mem_process_seqs' driver)."""

    def __init__(self, make_chunk):
        import queue as _queue
        import threading as _threading

        self._q = _queue.Queue(maxsize=1)
        self._done = object()

        def run():
            while True:
                chunk = make_chunk()
                if not chunk:
                    self._q.put(self._done)
                    return
                self._q.put(chunk)

        self._t = _threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        from .utils.timers import TIMERS

        while True:
            with TIMERS.stage("cli_fastq"):
                item = self._q.get()
            if item is self._done:
                return
            yield item


def _chunker(stream, chunk_bases: int, paired: bool):
    """Group reads by total base count ([EXT] mem_process_seqs chunking:
    actual_chunk_size bases per batch, pairs never split)."""

    def make_chunk():
        out = []
        bases = 0
        while bases < chunk_bases:
            try:
                if paired:
                    r1, r2 = next(stream)
                    out.append((r1, r2))
                    bases += len(r1.seq) + len(r2.seq)
                else:
                    r = next(stream)
                    out.append(r)
                    bases += len(r.seq)
            except StopIteration:
                break
        return out

    return _Prefetcher(make_chunk)


def _interleaved_pairs(it):
    """Pair up an interleaved stream (bwa mem -p smart pairing,
    MEM_F_SMARTPE, BwaMemAligner.java:76-84): reads 2i and 2i+1 are mates.
    A dangling final read is dropped with a warning, matching bwa's
    behavior on a truncated interleaved file."""
    while True:
        r1 = next(it, None)
        if r1 is None:
            return
        r2 = next(it, None)
        if r2 is None:
            print(
                f"{TAG} -p: odd number of reads in interleaved input; "
                f"dropping unpaired final read {r1.name!r}",
                file=sys.stderr,
            )
            return
        yield r1, r2


def cmd_index(args) -> int:
    import os

    from .api.index import BwaMemIndex

    out = args.output or (args.fasta + ".img")
    if args.sa_intv is not None:
        os.environ["BWAMEM_TPU_SA_INTV"] = str(args.sa_intv)
    BwaMemIndex.create_index_image_from_fasta_file(args.fasta, out)
    if args.bwa_files:
        BwaMemIndex.index_reference(args.fasta, args.fasta)
    print(f"{TAG} wrote index image {out}", file=sys.stderr)
    return 0


def _sam_lines(opt, anns, reads, codes, recs) -> str:
    """The SAM lines of a batch: per read each (record, mate's first record
    | None) of the aligner's ``_align_codes_raw``."""
    from .api.sam import aln2sam

    lines = []
    for r, q, per in zip(reads, codes, recs):
        alns = [a for a, _ in per]
        for w, (a, m) in enumerate(per):
            lines.append(aln2sam(opt, anns, r.name, q, r.qual, a, w, m,
                                 records=alns))
    return "".join(line + "\n" for line in lines)


def cmd_mem(args) -> int:
    import os

    from .api.aligner import BwaMemAligner
    from .api.index import BwaMemIndex
    from .api.options import MEM_F_SMARTPE
    from .api.pestats import BwaMemPairEndStats
    from .api.sam import sam_header
    from .utils import metrics
    from .utils.encoding import seq_to_codes_batch
    from .utils.fastq import read_fastx
    from .utils.timers import TIMERS

    ref = args.reference
    if not os.path.exists(ref) and os.path.exists(ref + ".img"):
        ref = ref + ".img"
    if ref.endswith((".fa", ".fasta", ".fa.gz", ".fasta.gz")):
        img = ref + ".img"
        if not os.path.exists(img):
            print(f"{TAG} building index image {img}...", file=sys.stderr)
            BwaMemIndex.create_index_image_from_fasta_file(ref, img)
        ref = img
    # --shard I/N: align only the reads whose stream ordinal % N == I, with
    # the engine's ids taken from the ORIGINAL ordinals, so the hash
    # tie-breaks (mem_mark_primary_se's Wang hash) are the unsharded run's
    # and the shards' outputs merge to exactly its SAM (the reference's
    # Spark/Yarn pattern, BwaMemIndex.java:22-27)
    shard_i, shard_n = 0, 1
    if args.shard:
        try:
            shard_i, shard_n = (int(x) for x in args.shard.split("/"))
            if not 0 <= shard_i < shard_n:
                raise ValueError(args.shard)
        except ValueError:
            print(f"{TAG} bad --shard {args.shard!r} (want I/N)",
                  file=sys.stderr)
            return 2

    def _take_shard(it):
        return (r for j, r in enumerate(it) if j % shard_n == shard_i)

    stages = tuple(s for s in (args.device_stages or "").split(",") if s)
    if args.idx_shards is not None and args.devices is None:
        print(f"{TAG} --idx-shards needs --devices", file=sys.stderr)
        return 2
    if args.devices is not None and args.device != "cuda":
        print(f"{TAG} --devices aligns over a mesh of cards, not on "
              f"--device {args.device}", file=sys.stderr)
        return 2
    with TIMERS.stage("cli_open"):
        index = BwaMemIndex(ref)
        try:
            mesh = None
            if args.devices is not None:
                from .parallel.mesh import make_mesh

                mesh = make_mesh(args.devices, idx_shards=args.idx_shards or 1)
            aligner = BwaMemAligner(index, device=None if mesh else args.device,
                                    device_stages=stages,
                                    device_pipeline=args.device_pipeline,
                                    mesh=mesh)
        except (RuntimeError, ValueError) as exc:
            print(f"{TAG} {exc} (--device cpu aligns on the host)",
                  file=sys.stderr)
            index.close()
            return 2
    opt = aligner.options
    if args.T is not None:
        opt.T = args.T
    if args.k is not None:
        opt.min_seed_len = args.k
    if args.threads is not None:
        opt.n_threads = args.threads
    out = sys.stdout
    anns = index._require().idx.bns.anns
    out.write(sam_header(anns))
    smart = bool(args.smart_pairing)
    if smart and args.mates is not None:
        print(f"{TAG} -p takes ONE interleaved file; ignoring mates "
              "argument (bwa mem -p semantics)", file=sys.stderr)
        args.mates = None
    paired = args.mates is not None or smart
    if paired:
        aligner.align_pairs()
        if smart:
            opt.flag |= MEM_F_SMARTPE
        if args.insert_mean is not None:
            aligner.set_proper_pair_end_stats(
                BwaMemPairEndStats.of(args.insert_mean, args.insert_std)
            )
        if smart:
            # shard by PAIR ordinal so mates never split across shards
            src = (p for j, p in enumerate(
                _interleaved_pairs(read_fastx(args.reads)))
                if j % shard_n == shard_i)
        else:
            src = zip(_take_shard(read_fastx(args.reads)),
                      _take_shard(read_fastx(args.mates)))
    else:
        src = _take_shard(read_fastx(args.reads))
    if args.chunk_size:
        opt.chunk_size = args.chunk_size
    chunk_bases = opt.chunk_size * max(opt.n_threads, 1)
    n_done = 0
    for batch in _chunker(src, chunk_bases, paired=paired):
        reads = [r for pair in batch for r in pair] if paired else batch
        with TIMERS.stage("cli_encode"):
            codes = seq_to_codes_batch([r.seq for r in reads])
        # ids: the stream ordinal of the batch's first pair (PE) or read (SE)
        first = n_done // 2 if paired else n_done
        recs = aligner._align_codes_raw(
            codes, id_base=first * shard_n + shard_i, id_stride=shard_n)
        with TIMERS.stage("cli_sam"):
            out.write(_sam_lines(opt, anns, reads, codes, recs))
        n_done += len(reads)
        print(f"{TAG} processed {n_done} reads", file=sys.stderr)
    out.flush()
    index.close()
    sink = os.environ.get("BWAMEM_TPU_METRICS")
    if sink:  # once more, with the last batch's cli_sam
        metrics._dump(sink)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bwamem_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_idx = sub.add_parser("index", help="build an index image from FASTA")
    p_idx.add_argument("fasta")
    p_idx.add_argument("-o", "--output", default=None)
    p_idx.add_argument(
        "--bwa-files", action="store_true",
        help="also write bwa-format .amb/.ann/.bwt/.pac/.sa files",
    )
    p_idx.add_argument(
        "--sa-intv", type=int, default=None,
        help="sampled-SA density (power of two; default 32 = bwa interop; "
        "8 quarters SA-walk latency for 4x sample storage; output-identical)",
    )
    p_idx.set_defaults(func=cmd_index)
    p_mem = sub.add_parser("mem", help="align reads, SAM to stdout")
    p_mem.add_argument("reference", help="index image (or FASTA to auto-index)")
    p_mem.add_argument("reads")
    p_mem.add_argument("mates", nargs="?", default=None)
    p_mem.add_argument(
        "-p", "--smart-pairing", action="store_true",
        help="smart pairing: the reads file is interleaved paired-end "
             "(bwa mem -p / MEM_F_SMARTPE); a mates file is ignored",
    )
    p_mem.add_argument("-T", type=int, default=None, help="score threshold")
    p_mem.add_argument("-k", type=int, default=None, help="min seed length")
    p_mem.add_argument(
        "-K", "--chunk-size", type=int, default=None,
        help="bases per processing chunk (mem_process_seqs chunk_size; "
             "default: the option's 10Mbp x n_threads)",
    )
    p_mem.add_argument("-t", "--threads", type=int, default=None)
    p_mem.add_argument("--insert-mean", type=float, default=None)
    p_mem.add_argument("--insert-std", type=float, default=50.0)
    p_mem.add_argument(
        "--device", default="cuda",
        help="torch device of the aligner (default cuda: a card is "
             "required; cpu: the whole-batch host route)",
    )
    p_mem.add_argument(
        "--device-stages", default=None, metavar="S1,S2",
        help="comma list of seed,sa_lookup,chain to also run on --device "
             "(the aligner's device_stages; used with --no-device-pipeline)",
    )
    p_mem.add_argument(
        "--device-pipeline", action=argparse.BooleanOptionalAction,
        default=None,
        help="the fused device path, seeding to regions on --device "
             "(default: on a CUDA device, off on the CPU); "
             "--no-device-pipeline keeps the extension waves and "
             "--device-stages",
    )
    p_mem.add_argument(
        "--devices", type=int, default=None, metavar="N",
        help="align over a mesh of the first N cards (the aligner's mesh: "
             "the fused path a sub-batch a card, or with "
             "--no-device-pipeline the waves and --device-stages split "
             "over them); more than the machine has is an error",
    )
    p_mem.add_argument(
        "--idx-shards", type=int, default=None, metavar="K",
        help="the mesh's idx axis (divides --devices)",
    )
    p_mem.add_argument(
        "--shard", default=None, metavar="I/N",
        help="align only reads with ordinal %% N == I (cluster partitioning; "
             "shard outputs merge to exactly the unsharded SAM — for "
             "paired-end provide --insert-mean, since inferred insert "
             "stats are per-process by design)",
    )
    p_mem.set_defaults(func=cmd_mem)
    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
