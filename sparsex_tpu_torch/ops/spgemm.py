"""SpGEMM: sparse x sparse -> sparse (C = A @ B).

The port's counterpart of ``sparsex_tpu/ops/spgemm.py``: **symbolic and
numeric product once on the host, every later multiply on the device**.

- ``spgemm_coo``: the reference's vectorized Gustavson expansion over the
  sorted COO forms, unchanged (NumPy), so its arrays equal the
  reference's bit for bit.
- ``spgemm``: the full product, returned as a ``CsxMatrix`` tuned onto A's
  device, so that C's SpMV / SpMM run on the CUDA kernels at once.
- ``spgemm_panel``: B densified in column panels on A's device (one
  ``index_put_`` a panel from B's COO, uploaded once), each C panel one
  SpMM of A (the k-batched kernels on a fused plan); useful when C is
  nearly dense or B is a tall thin operator.

Numerically-cancelled entries (exact 0 after summation) are dropped along
with structural zeros, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sparsex_tpu_torch.config import Config
from sparsex_tpu_torch.csx import CsxMatrix
from sparsex_tpu_torch.errors import ErrorCode, seterror


def _coo_sorted(mat: CsxMatrix):
    r, c, v = mat.tocoo()
    order = np.lexsort((c, r))
    return r[order], c[order], v[order]


def _check_shapes(A: CsxMatrix, B: CsxMatrix) -> None:
    if A.ncols != B.nrows:
        seterror(ErrorCode.SPX_ERR_VEC_DIM,
                 f"spgemm: A is {A.nrows}x{A.ncols}, B is "
                 f"{B.nrows}x{B.ncols}")


def spgemm_coo(ar, ac, av, br, bc, bv, nrows_a: int, ncols_a: int,
               ncols_b: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """C = A @ B on sorted COO triplets; returns sorted COO of C.

    Gustavson expansion, vectorized: every (A(i,k), B(k,j)) flop becomes
    one product entry, then entries are merged by output coordinate.
    O(flops) memory; flops = sum over A entries of B-row lengths.
    """
    # CSR view of B: row starts/lengths
    b_rowptr = np.searchsorted(br, np.arange(ncols_a + 1))
    starts = b_rowptr[ac]
    lens = (b_rowptr[ac + 1] - starts).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, np.zeros(0, dtype=av.dtype)
    out_row = np.repeat(ar, lens)
    a_val = np.repeat(av, lens)
    base = np.repeat(starts, lens)
    run0 = np.repeat(np.cumsum(lens) - lens, lens)
    bidx = base + (np.arange(total) - run0)
    out_col = bc[bidx]
    prod = a_val * bv[bidx]

    key = out_row * np.int64(ncols_b) + out_col
    uniq, inv = np.unique(key, return_inverse=True)
    vals = np.bincount(inv, weights=prod, minlength=uniq.size)
    rows = (uniq // ncols_b).astype(np.int64)
    cols = (uniq % ncols_b).astype(np.int64)
    nz = vals != 0.0
    return rows[nz], cols[nz], vals[nz].astype(av.dtype)


def spgemm(A: CsxMatrix, B: CsxMatrix, *,
           config: Optional[Config] = None) -> CsxMatrix:
    """C = A @ B, returned as a CsxMatrix tuned onto A's device."""
    _check_shapes(A, B)
    ar, ac, av = _coo_sorted(A)
    br, bc, bv = _coo_sorted(B)
    rows, cols, vals = spgemm_coo(ar, ac, av, br, bc, bv,
                                  A.nrows, A.ncols, B.ncols)
    if rows.size == 0:
        # empty product: a single explicit zero keeps the pipeline happy
        rows = np.zeros(1, dtype=np.int64)
        cols = np.zeros(1, dtype=np.int64)
        vals = np.zeros(1, dtype=av.dtype)
    return CsxMatrix.from_coo(A.nrows, B.ncols, rows, cols, vals,
                              config=config, device=A.device)


def spgemm_panel(A: CsxMatrix, B: CsxMatrix, panel: int = 512):
    """Device-resident paneled product: yields (j0, C_panel), C_panel the
    dense (A.nrows, width) tensor of C's columns [j0, j0 + width).

    B's COO goes to A's device once, sorted by column; each panel is
    densified there by one ``index_put_`` and multiplied by one SpMM
    (``A.matmat``; each distinct width is one ("mm", width) graph of A's
    executor, ``exec.MM_GRAPHS`` of them kept).  The panel's dtype is that
    of A's tables (f32 for a bf16 matrix, whose values the port holds in
    f32 arrays), else B's."""
    _check_shapes(A, B)
    br, bc, bv = _coo_sorted(B)
    corder = np.lexsort((br, bc))
    br, bc, bv = br[corder], bc[corder], bv[corder]
    bounds = np.searchsorted(bc, np.arange(0, B.ncols + panel, panel))
    delta = A.shards[0].delta
    dtype = torch.from_numpy(np.asarray(
        delta.vals if delta is not None else bv)[:0]).dtype
    dev = A.device
    rows_d = torch.as_tensor(br, device=dev)
    cols_d = torch.as_tensor(bc, device=dev)
    vals_d = torch.as_tensor(bv, device=dev).to(dtype)
    for pi, j0 in enumerate(range(0, B.ncols, panel)):
        lo, hi = int(bounds[pi]), int(bounds[pi + 1])
        p = min(panel, B.ncols - j0)
        Bp = torch.zeros((B.nrows, p), dtype=dtype, device=dev)
        Bp.index_put_((rows_d[lo:hi], cols_d[lo:hi] - j0), vals_d[lo:hi])
        yield j0, A.matmat(Bp)
