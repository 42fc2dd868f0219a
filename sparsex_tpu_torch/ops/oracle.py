"""Reference (oracle) SpMV implementations on the host.

The port's own copy of ``sparsex_tpu/ops/oracle.py`` (same semantics):
every execution path is verified against this serial CSR oracle, mirroring
the reference test strategy (``test/src/CsxCheck.cpp:28-53``: a plain CSR
SpMV built from the same input).  NumPy only; no device is involved.
"""

from __future__ import annotations

import numpy as np


def csr_spmv(nrows, rowptr, colind, values, x, y=None, alpha=1.0, beta=0.0,
             use_native=True):
    """y = alpha * A @ x + beta * y with a plain CSR SpMV.

    Uses the multithreaded native C++ kernel when available
    (``native/kernels.cpp`` ``spx_csr_spmv_*`` — the fast host baseline,
    playing the reference's MKL-adapter role); vectorized NumPy otherwise.
    """
    if use_native and np.asarray(values).dtype in (np.float64, np.float32):
        from sparsex_tpu_torch import native
        out = native.csr_spmv(nrows, rowptr, colind, values, x,
                              alpha=alpha, beta=beta, y=y)
        if out is not None:
            return out
    x = np.asarray(x)
    rowptr = np.asarray(rowptr, dtype=np.int64)
    colind = np.asarray(colind, dtype=np.int64)
    values = np.asarray(values)
    prod = values * x[colind]
    # np.add.reduceat repeats the next segment for an empty row: sum by the
    # cumulative sum instead
    csum = np.concatenate([[0.0], np.cumsum(prod)])
    row_sums = csum[rowptr[1:]] - csum[rowptr[:-1]]
    out = alpha * row_sums
    if y is not None and beta != 0.0:
        out = out + beta * np.asarray(y)
    return out.astype(values.dtype, copy=False)


def coo_spmv(nrows, rows, cols, vals, x, y=None, alpha=1.0, beta=0.0):
    """y = alpha * A @ x + beta * y from COO arrays."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    x = np.asarray(x)
    acc = np.zeros(nrows, dtype=np.result_type(vals.dtype, x.dtype))
    np.add.at(acc, rows, vals * x[cols])
    out = alpha * acc
    if y is not None and beta != 0.0:
        out = out + beta * np.asarray(y)
    return out.astype(vals.dtype, copy=False)


def max_rel_error(a, b) -> float:
    """max |a-b| / max(|b|, tiny) elementwise — the reference comparison
    semantics (``src/internals/Vector.cpp:51-56``)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    denom = np.maximum(np.abs(b), 1e-30)
    return float(np.max(np.abs(a - b) / denom)) if a.size else 0.0


def mixed_rel_err(a, b) -> float:
    """max |a-b| / (|b| + 1e-3*max|b|): relative where |b| is large, scaled
    absolute near zero rows (bench.py's ``_mixed_rel_err``)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if not a.size:
        return 0.0
    scale = 1e-3 * float(np.max(np.abs(b))) + 1e-30
    return float(np.max(np.abs(a - b) / (np.abs(b) + scale)))
