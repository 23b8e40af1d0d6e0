"""Two processes joined by ``torch.distributed`` (gloo, localhost), each
aligning its host shard of a PE batch on the CPU
(``parallel.distributed.align_shard``: mates together, each pair at its
ordinal in the whole batch), the records gathered with
``all_gather_object`` and merged in input order: the merge equals one
process's records, field for field (tolerance 0), on a genome with an
exact repeat, where the ordinals decide between equal hits.  The JAX
package's counterpart is tests/test_distributed.py; on the card both
processes share ``cuda:0`` (chip_smoke.py phase 18)."""
import json
import os
import socket
import subprocess
import sys

import numpy as np

from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex, BwaMemPairEndStats
from bwamem_tpu_torch.index import image
from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.utils.fasta import Fasta, FastaContig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json, sys
from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex, BwaMemPairEndStats
from bwamem_tpu_torch.parallel import distributed as dist

coord, pid, img, reads_file, out_file = sys.argv[1:6]
got = dist.init_distributed(coord, 2, int(pid))
assert got == (int(pid), 2), got
reads = [bytes.fromhex(h) for h in json.load(open(reads_file))]
with BwaMemIndex(img) as idx:
    al = BwaMemAligner(idx, device="cpu")
    al.align_pairs()
    al.set_proper_pair_end_stats(BwaMemPairEndStats.of(250, 25))
    lo, recs = dist.align_shard(al, reads, int(pid), 2)
recs = [[vars(a) for a in r] for r in recs]
merged = dist.merge_shards(dist.gather_shards(lo, recs), len(reads))
dist.shutdown()
json.dump({"lo": lo, "n": len(recs), "merged": merged}, open(out_file, "w"))
"""


def _genome(path):
    """A genome with an exact 8 kb repeat, where the hash tie-breaks
    (which take each pair's ordinal) pick between equal hits, and 30
    pairs drawn from it, every other one inside the repeat."""
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, 60_000).astype(np.uint8)
    codes[40_000:48_000] = codes[10_000:18_000]
    image.write_image(path, build_index(Fasta([FastaContig("g", "", codes)])))
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = []
    for i in range(30):
        isize = int(rng.integers(180, 300))
        s = (int(rng.integers(10_000, 17_600)) if i % 2
             else int(rng.integers(0, len(codes) - isize - 1)))
        reads.append(bases[codes[s: s + 70]].tobytes())
        reads.append(bases[(3 - codes[s + isize - 70: s + isize])[::-1]].tobytes())
    return reads


def test_two_gloo_processes_merge_to_one_process(tmp_path):
    img = str(tmp_path / "g.img")
    reads = _genome(img)
    reads_file = str(tmp_path / "reads.json")
    json.dump([r.hex() for r in reads], open(reads_file, "w"))
    worker = str(tmp_path / "worker.py")
    open(worker, "w").write(_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    outs = [str(tmp_path / f"out{i}.json") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, worker, f"127.0.0.1:{port}", str(i), img, reads_file,
         outs[i]], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], errs
    res = [json.load(open(o)) for o in outs]
    assert [r["lo"] for r in res] == [0, 30] and sum(r["n"] for r in res) == 60
    with BwaMemIndex(img) as idx:
        al = BwaMemAligner(idx, device="cpu")
        al.align_pairs()
        al.set_proper_pair_end_stats(BwaMemPairEndStats.of(250, 25))
        want = [[vars(a) for a in r] for r in al.align_seqs(reads)]
    # JSON turns the records' tuples and ints the same way for both sides
    want = json.loads(json.dumps(want))
    assert res[0]["merged"] == res[1]["merged"] == want
    assert sum(1 for r in want if r and r[0]["ref_id"] >= 0) > 50
    # the repeat's pairs really tie: their primary hits lie in both copies
    starts = {r[0]["ref_start"] // 10_000 for r in want[2::4] if r}
    assert {1, 4} <= starts
