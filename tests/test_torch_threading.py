"""The port's concurrency contract, as the JAX package's (tests/
test_threading.py): the index is shared and reference-counted, aligners are
cheap and one per thread; on ``device="cpu"``, the whole-batch host route
and the plain versions of the fused device path.  Each thread's records
equal a single-threaded run's."""
import threading

import pytest

from bwamem_tpu_torch import BwaMemAligner, BwaMemIndex
from test_torch_sam import ROTAVIRUS
from test_torch_wire import _batch

READ_L1 = b"GGCTTTTAATGCTTTTCAGTGGTTGCTGCTCAAGATGGAGTCTACTCAGCAGATGGTAAGCTCTATTATT"


@pytest.fixture()
def index():
    idx = BwaMemIndex(ROTAVIRUS)
    yield idx
    if idx.is_open():
        idx.close()


def _records(out):
    return [[vars(a) for a in r] for r in out]


@pytest.mark.parametrize("route, n_threads, reps",
                         (({}, 8, 5), (dict(device_pipeline=True), 3, 1)),
                         ids=("host", "fused"))
def test_one_aligner_per_thread(index, route, n_threads, reps):
    seqs = _batch(3)
    with BwaMemAligner(index, device="cpu", **route) as a:
        want = _records(a.align_seqs(seqs))
    results, errors = {}, []

    def worker(tid):
        try:
            with BwaMemAligner(index, device="cpu", **route) as aligner:
                for _ in range(reps):
                    r = aligner.align_seqs([READ_L1])
                    assert r[0][0].ref_start == 0
                results[tid] = _records(aligner.align_seqs(seqs))
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert len(results) == n_threads
    assert all(r == want for r in results.values())


def test_close_races_with_alignment(index):
    """close() must refuse while any aligner holds a reference, and succeed
    once all are done — never corrupt state."""
    barrier = threading.Barrier(2, timeout=60)

    def aligner_thread():
        a = BwaMemAligner(index, device="cpu")
        index.ref_index()
        barrier.wait()
        barrier.wait()  # hold the ref while the main thread tries close
        index.de_ref_index()
        a.close()

    t = threading.Thread(target=aligner_thread)
    t.start()
    barrier.wait()
    with pytest.raises(RuntimeError):
        index.close()
    barrier.wait()
    t.join(timeout=60)
    assert not t.is_alive()
    index.close()
    assert not index.is_open()
    with pytest.raises(RuntimeError):
        BwaMemAligner(index, device="cpu")
