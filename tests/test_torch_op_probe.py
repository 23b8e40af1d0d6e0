"""The port of benchmarks/mosaic_probe.py: each plain PyTorch probe body
against a numpy statement of mosaic_probe.py's body (np.roll, wrapping
int32/int16 adds, the masked prefix max), exactly, at small K; the probe
table against mosaic_probe.py's own; the SASS loop reader on both of
cuobjdump's branch notations.  Imports no JAX: mosaic_probe.py is read as
text.  The CUDA kernel is held against the plain version in
test_torch_cuda.py."""
import ast
import os

import numpy as np
import pytest
import torch

from bwamem_tpu_torch.benchmarks import op_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BY_NAME = {p.name: p for p in op_probe.PROBES}


def _np_adds(v):
    for _ in range(32):
        v = v + v
    return v


def _np_roll(axis):
    def body(v):
        for _ in range(8):
            v = np.roll(v, 1, axis=axis) + v.dtype.type(1)
        return v
    return body


def _np_prefmax(v):
    col = np.arange(v.shape[1])[None, :]
    P = v
    k = 1
    while k < 128:
        s = np.roll(P, k, axis=1)
        P = np.maximum(P, np.where(col >= k, s, -(1 << 30)).astype(v.dtype))
        k <<= 1
    return P


NUMPY_BODIES = {
    "wide32": _np_adds, "wide16": _np_adds, "scal32": _np_adds,
    "row32": _np_adds,
    "reduce": lambda v: v + v.max(axis=1, keepdims=True),
    "roll-lane": _np_roll(1), "roll-sub": _np_roll(0),
    "reduce-sub": lambda v: v + v.max(axis=0, keepdims=True),
    "prefmax": _np_prefmax,
}


def _mosaic_probes():
    """(name, shape, dtype name, per_iter_ops) of each probe() call in
    benchmarks/mosaic_probe.py, read from its syntax tree."""
    with open(os.path.join(ROOT, "benchmarks", "mosaic_probe.py")) as f:
        tree = ast.parse(f.read())
    consts = {t.id: n.value.value for n in tree.body
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(n.value, ast.Constant)}
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "probe"):
            name, _, shape, dtype, ops = node.args[:5]
            dims = tuple(consts[e.id] if isinstance(e, ast.Name) else e.value
                         for e in shape.elts)
            out.append((name.value, dims, dtype.attr, ops.value))
    return out


def test_probe_table_is_mosaic_probes():
    ours = [(p.name, p.shape, str(p.dtype).replace("torch.", ""),
             p.per_iter_ops) for p in op_probe.PROBES]
    assert ours == _mosaic_probes()


@pytest.mark.parametrize("name", list(BY_NAME))
@pytest.mark.parametrize("start", ["ones", "random"])
def test_plain_body_matches_numpy(name, start):
    p = BY_NAME[name]
    dt = np.int16 if p.dtype == torch.int16 else np.int32
    if start == "ones":
        x = np.ones(p.shape, dt)
    else:
        x = np.random.default_rng(7).integers(-5000, 5000, p.shape).astype(dt)
    K = 3
    exp = x
    for _ in range(K):
        exp = NUMPY_BODIES[name](exp)
    before = op_probe.LAUNCHES
    got = op_probe.run_probe(p, torch.from_numpy(x), K)
    assert op_probe.LAUNCHES == before  # the CPU never launches the kernel
    assert got.dtype == p.dtype and tuple(got.shape) == p.shape
    assert np.array_equal(got.numpy(), exp.astype(dt))


def test_prefmax_is_an_inclusive_prefix_max():
    x = np.random.default_rng(8).integers(-100, 100, (4, 128)).astype(np.int32)
    got = op_probe._prefmax(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.maximum.accumulate(x, axis=1))


def test_kernel_needs_a_card():
    p = op_probe.PROBES[0]
    with pytest.raises(ValueError):
        op_probe.probe_cuda(p, torch.ones(p.shape, dtype=p.dtype), 4)
    if not torch.cuda.is_available():
        assert op_probe.main() == 1


SASS_ADDR = """
        Function : probe_scal32
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0080*/                   IADD3 R5, R5, R5, RZ ;
        /*0090*/                   IADD3 R5, R5, R5, RZ ;
        /*00a0*/                   LEA R5, R5, R5, 0x0 ;
        /*00b0*/                   ISETP.NE.AND P0, PT, R4, RZ, PT ;
        /*00c0*/               @P0 BRA 0x80 ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   BRA 0xe0;
        Function : probe_reduce
        /*0000*/                   EXIT ;
"""

SASS_LABEL = """
        Function : probe_roll_lane
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_0:
        /*0040*/                   SHFL.IDX PT, R3, R2, R6, 0x1f ;
        /*0050*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0060*/              @!P0 BRA `(.L_x_0) ;
        /*0070*/                   EXIT ;
.L_x_1:
        /*0080*/                   BRA `(.L_x_1);
"""


def test_sass_loop_reader():
    loops = op_probe.parse_loops(SASS_ADDR)
    assert loops["probe_scal32"] == {"IADD3": 2, "LEA": 1, "ISETP": 1, "BRA": 1}
    assert loops["probe_reduce"] == {}
    loops = op_probe.parse_loops(SASS_LABEL)
    assert loops["probe_roll_lane"] == {"SHFL": 1, "IADD3": 1, "BRA": 1}
