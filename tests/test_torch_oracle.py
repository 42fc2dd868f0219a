"""The port's host oracle (``sparsex_tpu_torch/ops/oracle.py``) and its
native CSR SpMV binding against the JAX package's on the same inputs.

``csr_spmv`` through the native C++ kernel and through NumPy, ``coo_spmv``
and ``max_rel_error``, each equal to the reference's (the same code on the
same arrays), on matrices with empty rows (leading and inner ones, which
``np.add.reduceat`` gets wrong), with and without the
``alpha`` / ``beta`` epilogue, in float32 and float64; and
``native.available()`` as the reference's.  One intended divergence: the
reference's NumPy path still calls ``np.add.reduceat`` before its cumsum
fix and raises ``IndexError`` when the last row is empty; the port drops
that dead call, so the reference is compared where the last row holds an
entry and the port alone (against a dense product) where it does not.
"""

import numpy as np
import pytest

from sparsex_tpu import native as ref_native
from sparsex_tpu.ops import oracle as ref_oracle

from sparsex_tpu_torch import native
from sparsex_tpu_torch.ops import oracle


EMPTY = [0, 7, 8, 9]


def _csr_with_empty_rows(dtype, seed=0, n=40, ncols=33, last=False):
    """A CSR matrix whose rows ``EMPTY`` (and the last, with ``last``) are
    empty."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 6, n)
    counts[EMPTY + ([n - 1] if last else [])] = 0
    rowptr = np.zeros(n + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(counts)
    colind = np.concatenate([np.sort(rng.choice(ncols, c, replace=False))
                             for c in counts]).astype(np.int64)
    values = rng.standard_normal(rowptr[-1]).astype(dtype)
    rows = np.repeat(np.arange(n), counts)
    return n, ncols, rowptr, colind, values, rows


def _dense_spmv(n, rows, cols, vals, x):
    return np.bincount(rows, weights=vals.astype(np.float64)
                       * np.asarray(x, np.float64)[cols], minlength=n)


def test_native_available_as_the_reference():
    assert native.available() == ref_native.available()
    assert native.available()   # g++ builds kernels.cpp here


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (2.0, 0.5), (-0.5, 3.0)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_csr_spmv_equals_the_reference(use_native, alpha, beta, dtype):
    n, ncols, rowptr, colind, values, rows = _csr_with_empty_rows(dtype)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(ncols).astype(dtype)
    y = rng.standard_normal(n).astype(dtype)
    got = oracle.csr_spmv(n, rowptr, colind, values, x, y=y, alpha=alpha,
                          beta=beta, use_native=use_native)
    want = ref_oracle.csr_spmv(n, rowptr, colind, values, x, y=y,
                               alpha=alpha, beta=beta, use_native=use_native)
    assert got.dtype == want.dtype == dtype and np.array_equal(got, want)
    exact = alpha * _dense_spmv(n, rows, colind, values, x) + beta * y
    bar = 1e-5 if dtype == np.float32 else 1e-12
    assert oracle.max_rel_error(got, exact) < bar or (
        np.abs(got - exact).max() < bar * np.abs(exact).max())
    assert np.all(got[EMPTY] == (beta * y[EMPTY]).astype(dtype))


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_csr_spmv_with_an_empty_last_row(use_native, dtype):
    n, ncols, rowptr, colind, values, rows = _csr_with_empty_rows(
        dtype, seed=7, last=True)
    x = np.random.default_rng(8).standard_normal(ncols).astype(dtype)
    got = oracle.csr_spmv(n, rowptr, colind, values, x, alpha=2.0,
                          use_native=use_native)
    exact = 2.0 * _dense_spmv(n, rows, colind, values, x)
    bar = 1e-5 if dtype == np.float32 else 1e-13
    assert got.dtype == dtype and got[-1] == 0.0
    assert np.abs(got - exact).max() <= bar * np.abs(exact).max()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_csr_spmv_native_against_numpy(dtype):
    """The two paths of the port agree; without y the epilogue is
    skipped."""
    n, ncols, rowptr, colind, values, _rows = _csr_with_empty_rows(
        dtype, seed=2)
    x = np.random.default_rng(3).standard_normal(ncols).astype(dtype)
    a = oracle.csr_spmv(n, rowptr, colind, values, x, use_native=True)
    b = oracle.csr_spmv(n, rowptr, colind, values, x, use_native=False)
    bar = 1e-6 if dtype == np.float32 else 1e-14
    assert np.abs(a - b).max() <= bar * np.abs(b).max()
    direct = native.csr_spmv(n, rowptr, colind, values, x, nthreads=3)
    assert np.array_equal(direct, a)


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (1.5, -2.0)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_coo_spmv_equals_the_reference(alpha, beta, dtype):
    n, ncols, _rowptr, colind, values, rows = _csr_with_empty_rows(
        dtype, seed=4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(ncols).astype(dtype)
    y = rng.standard_normal(n).astype(dtype)
    got = oracle.coo_spmv(n, rows, colind, values, x, y=y, alpha=alpha,
                          beta=beta)
    want = ref_oracle.coo_spmv(n, rows, colind, values, x, y=y, alpha=alpha,
                               beta=beta)
    assert got.dtype == want.dtype == dtype and np.array_equal(got, want)
    csr = oracle.csr_spmv(n, _rowptr, colind, values, x, y=y, alpha=alpha,
                          beta=beta, use_native=False)
    bar = 1e-5 if dtype == np.float32 else 1e-13
    assert np.abs(got - csr).max() <= bar * np.abs(csr).max()


def test_max_rel_error_equals_the_reference():
    rng = np.random.default_rng(6)
    a = rng.standard_normal(50)
    b = a + 1e-7 * rng.standard_normal(50)
    b[3] = 0.0
    for pair in ((a, b), (b, a), (a, a), (np.zeros(0), np.zeros(0)),
                 (a.astype(np.float32), b)):
        assert oracle.max_rel_error(*pair) == ref_oracle.max_rel_error(*pair)
    assert oracle.max_rel_error(a, a) == 0.0
