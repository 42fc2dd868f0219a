"""CSR input view.

The port's own copy of ``sparsex_tpu/io/csr.py``,
with its imports pointed at ``sparsex_tpu_torch``: it behaves as the
reference does, so both packages plan alike.

Parity with the reference CSR wrapper (``include/sparsex/internals/Csr.hpp:
38-173``): a zero-copy view over user-provided ``rowptr``/``colind``/
``values`` with 0- or 1-based indexing, element iteration (as vectorized COO
expansion), and linear-scan ``get_value``/``set_value``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from sparsex_tpu_torch.errors import ErrorCode, seterror


@dataclass
class CSR:
    nrows: int
    ncols: int
    rowptr: np.ndarray
    colind: np.ndarray
    values: np.ndarray
    zero_based: bool = True

    def __post_init__(self):
        self.rowptr = np.asarray(self.rowptr)
        self.colind = np.asarray(self.colind)
        self.values = np.asarray(self.values)
        if self.rowptr.ndim != 1 or self.rowptr.size != self.nrows + 1:
            seterror(ErrorCode.SPX_ERR_INPUT_MAT, "rowptr must have nrows+1 entries")
        base = 0 if self.zero_based else 1
        if int(self.rowptr[0]) != base:
            seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                     f"rowptr[0] must be {base} for this indexing base")
        nnz = int(self.rowptr[-1]) - base
        if self.colind.size != nnz or self.values.size != nnz:
            seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                     "colind/values size does not match rowptr[-1]")

    @property
    def nnz(self) -> int:
        base = 0 if self.zero_based else 1
        return int(self.rowptr[-1]) - base

    def tocoo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Expand to 0-based sorted COO arrays (rows, cols, vals)."""
        base = 0 if self.zero_based else 1
        rowptr = self.rowptr.astype(np.int64) - base
        counts = np.diff(rowptr)
        rows = np.repeat(np.arange(self.nrows, dtype=np.int64), counts)
        cols = self.colind.astype(np.int64) - base
        return rows, cols, np.asarray(self.values)

    def get_value(self, row: int, col: int) -> Optional[float]:
        base = 0 if self.zero_based else 1
        lo = int(self.rowptr[row]) - base
        hi = int(self.rowptr[row + 1]) - base
        seg = self.colind[lo:hi].astype(np.int64) - base
        hits = np.nonzero(seg == col)[0]
        if hits.size == 0:
            return None
        return float(self.values[lo + hits[0]])

    def set_value(self, row: int, col: int, value: float) -> bool:
        base = 0 if self.zero_based else 1
        lo = int(self.rowptr[row]) - base
        hi = int(self.rowptr[row + 1]) - base
        seg = self.colind[lo:hi].astype(np.int64) - base
        hits = np.nonzero(seg == col)[0]
        if hits.size == 0:
            return False
        self.values[lo + hits[0]] = value
        return True


def csr_from_coo(nrows: int, ncols: int, rows, cols, vals,
                 index_dtype=np.int32) -> CSR:
    """Build a CSR from 0-based sorted COO arrays."""
    rows = np.asarray(rows, dtype=np.int64)
    rowptr = np.zeros(nrows + 1, dtype=index_dtype)
    np.add.at(rowptr, rows + 1, 1)
    rowptr = np.cumsum(rowptr, dtype=np.int64).astype(index_dtype)
    return CSR(nrows, ncols, rowptr, np.asarray(cols, dtype=index_dtype),
               np.asarray(vals))
