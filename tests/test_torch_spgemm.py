"""The port's SpGEMM (``sparsex_tpu_torch/ops/spgemm.py``, ``spx.spgemm``)
against the JAX package's on the CPU.

The counterparts of ``tests/test_spmm.py:166-232``: ``spgemm_coo`` equal
to the reference's array for array on seeded random operands (square,
rectangular, float32 and float64, an empty product); C = A @ B tuned from
it, its stored entries and SpMV against the dense product and the
reference's C; the API entry point on a rectangular pair and the refusal
of mismatched shapes; the panel stream at ``panel=96`` against the dense
product and the reference's panels; and an operand tuned with
``OP_REORDER`` (RCM), whose product must be the reference's.
"""

import numpy as np
import pytest
import torch

import sparsex_tpu as ref
from sparsex_tpu.config import Config as RefConfig
from sparsex_tpu.csx import CsxMatrix as RefCsxMatrix
from sparsex_tpu.errors import SparsexError as RefSparsexError
from sparsex_tpu.ops import spgemm as ref_spgemm

import chip_smoke
import sparsex_tpu_torch as spt
from sparsex_tpu_torch.csx import CsxMatrix
from sparsex_tpu_torch.ops import spgemm as tsp
from test_spmm import _dense, _mk

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_port_config():
    spt.Config.reset()
    yield
    spt.Config.reset()


def _options(**options):
    for cfg in (spt.Config.instance(), RefConfig.instance()):
        for key, value in options.items():
            cfg.set(key, str(value))


def _both(nr, nc, rows, cols, vals):
    return (CsxMatrix.from_coo(nr, nc, rows, cols, vals, device="cpu"),
            RefCsxMatrix.from_coo(nr, nc, rows, cols, vals))


def _random_coo(rng, nr, nc, m, dtype):
    key = np.unique(rng.integers(0, nr * nc, m))
    r, c = key // nc, key % nc
    return r, c, rng.standard_normal(r.size).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(60, 60, 60), (50, 90, 30), (7, 3, 5)])
@pytest.mark.parametrize("seed", [0, 1])
def test_spgemm_coo_equals_the_reference(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    nr, nk, nc = shape
    ar, ac, av = _random_coo(rng, nr, nk, 4 * nr, dtype)
    br, bc, bv = _random_coo(rng, nk, nc, 4 * nk, dtype)
    got = tsp.spgemm_coo(ar, ac, av, br, bc, bv, nr, nk, nc)
    want = ref_spgemm.spgemm_coo(ar, ac, av, br, bc, bv, nr, nk, nc)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_spgemm_coo_empty_product():
    """A's columns meet none of B's rows: empty arrays of A's dtype."""
    ar, ac, av = np.array([0, 1]), np.array([0, 0]), np.ones(2, np.float32)
    br, bc, bv = np.array([1]), np.array([2]), np.ones(1, np.float32)
    got = tsp.spgemm_coo(ar, ac, av, br, bc, bv, 2, 2, 3)
    want = ref_spgemm.spgemm_coo(ar, ac, av, br, bc, bv, 2, 2, 3)
    assert [g.size for g in got] == [0, 0, 0] and got[2].dtype == np.float32
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_spgemm_oracle():
    """tests/test_spmm.py:166."""
    _options(**{"spx.preproc.xform": "all"})
    n = 300
    ra, ca, va = _mk(n, seed=8, kinds=("dia", "h", "rand"))
    rb, cb, vb = _mk(n, seed=9, kinds=("dia", "v", "rand"))
    A, RA = _both(n, n, ra, ca, va)
    B, RB = _both(n, n, rb, cb, vb)
    C = tsp.spgemm(A, B)
    RC = ref_spgemm.spgemm(RA, RB)
    assert C.device == torch.device("cpu") and C.nnz == RC.nnz
    dense = _dense(n, ra, ca, va) @ _dense(n, rb, cb, vb)
    x = np.random.default_rng(10).standard_normal(n)
    y = C.matvec(x).numpy()
    assert np.abs(y - dense @ x).max() / np.abs(dense @ x).max() < 1e-10
    assert np.abs(y - np.asarray(RC.matvec(x))).max() < 1e-10 * np.abs(y).max()
    rc, cc, vc = C.tocoo()
    assert np.allclose(dense[rc, cc], vc, rtol=1e-12, atol=1e-12)
    for g, w in zip((rc, cc, vc), RC.tocoo()):
        assert np.array_equal(g, np.asarray(w))


def test_spgemm_rectangular_and_api():
    """tests/test_spmm.py:187: ``spx.spgemm`` on Matrix handles, and
    SparsexError on mismatched shapes (both packages refuse)."""
    rng = np.random.default_rng(11)
    ra = rng.integers(0, 100, 600)
    ca = rng.integers(0, 200, 600)
    rb = rng.integers(0, 200, 500)
    cb = rng.integers(0, 80, 500)

    def mk(r, c, nc):
        _, u = np.unique(r * nc + c, return_index=True)
        r, c = r[u], c[u]
        o = np.lexsort((c, r))
        return r[o], c[o], rng.standard_normal(r.size)

    ra, ca, va = mk(ra, ca, 200)
    rb, cb, vb = mk(rb, cb, 80)
    A, RA = _both(100, 200, ra, ca, va)
    B, RB = _both(200, 80, rb, cb, vb)
    C = spt.spgemm(spt.Matrix(csx=A), spt.Matrix(csx=B))
    RC = ref.spgemm(ref.Matrix(csx=RA), ref.Matrix(csx=RB))
    assert isinstance(C, spt.Matrix) and (C.nrows, C.ncols) == (100, 80)
    Ad = np.zeros((100, 200))
    Ad[ra, ca] = va
    Bd = np.zeros((200, 80))
    Bd[rb, cb] = vb
    x = rng.standard_normal(80)
    y = spt.matvec_mult(1.0, C, x).numpy()
    want = (Ad @ Bd) @ x
    assert np.abs(y - want).max() / (np.abs(want).max() + 1e-30) < 1e-10
    ry = np.asarray(ref.matvec_mult(1.0, RC, x))
    assert np.abs(y - ry).max() <= 1e-10 * np.abs(ry).max()
    with pytest.raises(spt.SparsexError):
        tsp.spgemm(B, B)  # 80 != 200
    with pytest.raises(RefSparsexError):
        ref_spgemm.spgemm(RB, RB)
    with pytest.raises(spt.SparsexError):
        next(tsp.spgemm_panel(B, B))


def test_spgemm_panel_stream():
    """tests/test_spmm.py:217: float32 operands, panels of 96 columns (the
    last 64 wide), each a tensor on A's device of A's dtype."""
    _options(**{"spx.tpu.value_dtype": "float32"})
    n = 256
    ra, ca, va = _mk(n, seed=12, kinds=("dia", "rand"))
    rb, cb, vb = _mk(n, seed=13, kinds=("dia", "rand"))
    va, vb = va.astype(np.float32), vb.astype(np.float32)
    A, RA = _both(n, n, ra, ca, va)
    B, RB = _both(n, n, rb, cb, vb)
    dense = _dense(n, ra, ca, va) @ _dense(n, rb, cb, vb)
    C = np.zeros((n, n), np.float32)
    widths = []
    refs = dict(ref_spgemm.spgemm_panel(RA, RB, panel=96))
    for j0, panel in tsp.spgemm_panel(A, B, panel=96):
        assert isinstance(panel, torch.Tensor)
        assert panel.dtype == torch.float32 and panel.device == A.device
        C[:, j0: j0 + panel.shape[1]] = panel.numpy()
        widths.append(panel.shape[1])
        want = np.asarray(refs[j0])
        assert np.abs(panel.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert widths == [96, 96, 64]
    assert np.abs(C - dense).max() / np.abs(dense).max() < 1e-5


@pytest.mark.parametrize("side", ["A", "B"])
def test_spgemm_of_a_reordered_operand(side):
    """An operand tuned with OP_REORDER holds the RCM-permuted matrix; the
    product of it is the reference's, entry for entry."""
    _options(**{"spx.preproc.xform": "all"})
    n = 240
    rows, cols, vals = _mk(n, seed=14, kinds=("dia", "h", "v", "rand"))
    rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    key, u = np.unique(rows * n + cols, return_index=True)
    rows, cols, vals = key // n, key % n, np.concatenate([vals, vals])[u]
    inp = chip_smoke.csr_input(spt, rows, cols, vals, n)
    rinp = chip_smoke.csr_input(ref, rows, cols, vals, n)
    P = spt.mat_tune(inp, spt.OP_REORDER, device="cpu")
    RP = ref.mat_tune(rinp, ref.OP_REORDER)
    assert np.array_equal(P.permutation, RP.permutation)
    Q, RQ = _both(n, n, *_mk(n, seed=15, kinds=("dia", "rand")))
    Q, RQ = spt.Matrix(csx=Q), ref.Matrix(csx=RQ)
    pair, rpair = ((P, Q), (RP, RQ)) if side == "A" else ((Q, P), (RQ, RP))
    C = spt.spgemm(*pair)
    RC = ref.spgemm(*rpair)
    for g, w in zip(C.csx.tocoo(), RC.csx.tocoo()):
        assert np.array_equal(g, np.asarray(w))
    x = np.random.default_rng(16).standard_normal(n)
    y = spt.matvec_mult(1.0, C, x).numpy()
    ry = np.asarray(ref.matvec_mult(1.0, RC, x))
    assert np.abs(y - ry).max() <= 1e-10 * np.abs(ry).max()
