"""The yardstick of the rooflines: the H100's peak and the least bytes
each kind of work must move, counted from the matrix and the algorithm,
never from the port's layout.  Indices are not counted (a format may
compress them), so these are lower bounds for any implementation that
stores the values, and a share of them cannot pass 100 %.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet: 3.35 TB/s of HBM3 at the full 700 W
HBM_BYTES_S = 3.35e12


def spmv_bytes(nnz: int, nrows: int, ncols: int, value_bytes: int,
               beta_nonzero: bool) -> int:
    """One y = alpha A x + beta y: every stored value and x read once, y
    written once, and read once more where beta is not 0."""
    return value_bytes * (nnz + ncols + nrows * (2 if beta_nonzero else 1))


def cg_iteration_bytes(nnz: int, n: int, value_bytes: int) -> int:
    """One CG iteration: every stored value read once, and x, r and p each
    read and written once (the least any fusion of the recurrence can
    move; A p and the dot products can stay on chip)."""
    return value_bytes * (nnz + 6 * n)


def least_seconds(nbytes: float) -> float:
    """The time ``nbytes`` take at the HBM peak."""
    return nbytes / HBM_BYTES_S
