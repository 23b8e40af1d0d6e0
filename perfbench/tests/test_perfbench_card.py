"""The tiny cells on the card's default route (the fused device path), traced
and not: correct, with the card's busy time read from the profile."""
from __future__ import annotations

import pytest
from perfbench_tiny import tiny_root

from perfbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_on_the_card(tmp_path, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    root = tiny_root(tmp_path)
    cell = harness.load_cell("tiny.pe", root)
    r = harness.run_cell(cell, 2**31 + 3, 2.0, trace)
    assert r.pop("forbidden_modules") == []
    assert r["correct"] is True
    assert r["device"]["platform"] == "gpu"
    if trace:
        assert r["device"]["busy_s"] > 0
        assert r["breakdown"]["device_ops"]
