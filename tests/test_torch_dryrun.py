"""``parallel.dryrun.dryrun_multichip`` (the counterpart of
__graft_entry__.py ``dryrun_multichip``) on a virtual CPU mesh of four
devices at a small size: PE records on a (2, 2) mesh and the whole stage
stack on a (4, 1) mesh equal to the single-device route's, the sharded
occ4 step equal to the host oracle, and the seed+SA step on a synthetic
index equal to the host oracle and, on tables sharded over 2 and over 4
shards, bit-equal to the unsharded run (tolerance 0: integer results).
On the card it runs at full size in chip_smoke.py phase 18."""
import pytest
import torch

from bwamem_tpu_torch.parallel.dryrun import dryrun_multichip


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dryrun_on_a_virtual_cpu_mesh():
    out = dryrun_multichip(["cpu"] * 4, big_len=128 * 4096,
                           shard_counts=(2, 4), n_pairs=4, n_sub=4,
                           min_seed_len=10)
    assert out["mesh"] == {"data": 2, "idx": 2}
    assert out["full_stack"]["mesh"] == {"data": 4, "idx": 1}
    assert out["records"] >= out["reads"] and out["mapped"] > 0
    big = out["big"]
    assert big["seq_len"] == 128 * 4096 * 1 and big["shard_counts"] == [2, 4]
    assert big["intervals"] > 0 and big["rbegs"] > 0
    assert big["flagged"] < big["reads"]


def test_dryrun_on_an_odd_device_count_has_no_idx_axis():
    out = dryrun_multichip(["cpu"] * 3, big_len=0, n_pairs=3, n_sub=2)
    assert out["mesh"] == {"data": 3, "idx": 1} and "big" not in out
