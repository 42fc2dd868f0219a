"""Public API of the PyTorch port (counterpart of ``sparsex_tpu/api.py``).

Loading, options and errors are the port's own copies of the reference's
host code (``Input``, the CSR and MMF loaders and the flags below are
copied from ``sparsex_tpu/api.py:42-126``); tuning plans on the host and
the SpMV kernels run on a PyTorch device:

=====================================  =====================================
reference                               sparsex_tpu_torch
=====================================  =====================================
``spx_init / spx_finalize``             ``init() / finalize()``
``spx_input_load_csr / _mmf``           ``input_load_csr / input_load_mmf``
``spx_input_destroy``                   ``input_destroy``
``spx_mat_tune``                        ``mat_tune(input, *flags, device=)``
``spx_mat_get_entry / set_entry``       ``mat_get_entry / mat_set_entry``
``spx_mat_save / restore``              ``mat_save / mat_restore(filename,
                                        device=)``
``spx_mat_get_partition``               ``mat_get_partition``
``spx_mat_destroy``                     ``mat_destroy``
``spx_matvec_mult``                     ``matvec_mult(alpha, A, x, device=)``
``spx_matvec_kernel``                   ``matvec_kernel(alpha, A, x, beta,
                                        y, device=)``
``spx_matvec_kernel_csr``               ``matvec_kernel_csr(..., device=)``
``spx_partition_csr``                   ``partition_csr``
``matmat_mult`` (SpMM, api.py:209)      ``matmat_mult(alpha, A, X, device=)``
``matmat_kernel`` (api.py:218)          ``matmat_kernel(alpha, A, X, beta,
                                        Y, device=)``
``spgemm`` (api.py:223)                 ``spgemm(A, B)`` (C on A's device)
``spx_option_set / get``                ``option_set / option_get``
``spx_vec_*``                           ``sparsex_tpu_torch.ops.vector``
=====================================  =====================================

``device`` defaults to ``cuda:0`` for tuning and restoring; the SpMV calls
run where the matrix lives, and a ``device`` given to them must name that
device.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from sparsex_tpu_torch.config import Config
from sparsex_tpu_torch.csx import CsxMatrix
from sparsex_tpu_torch.device import resolve_device
from sparsex_tpu_torch.errors import ErrorCode, SparsexError, seterror
from sparsex_tpu_torch.io.csr import CSR
from sparsex_tpu_torch.io.mmf import MMF, load_mmf
from sparsex_tpu_torch.logger import log_info
from sparsex_tpu_torch.parallel.partition import (RowPartition,
                                                  split_rows_by_nnz)
from sparsex_tpu_torch.persist import restore_csx, save_csx
from sparsex_tpu_torch.symmetric import build_symmetric_csx
from sparsex_tpu_torch.timing import span, span_seconds

# Flags mirroring the reference's option macros.
OP_REORDER = "reorder"  # SPX_MAT_REORDER
INDEX_ZERO_BASED = 0    # SPX_INDEX_ZERO_BASED
INDEX_ONE_BASED = 1     # SPX_INDEX_ONE_BASED


def init() -> None:
    """``spx_init`` parity (ref ``src/api/common.c:85-93``): enable the
    default console error/warning reporting.  Idempotent."""
    Config.instance()


def finalize() -> None:
    """``spx_finalize`` parity: nothing process-wide to release (a
    matrix's device memory goes with it, or with ``mat_destroy``)."""


@dataclass
class Input:
    """``spx_input_t`` parity: a loaded, not-yet-tuned matrix."""

    kind: str  # "csr" or "mmf"
    mmf: Optional[MMF] = None
    csr: Optional[CSR] = None

    @property
    def nrows(self) -> int:
        src = self.mmf if self.kind == "mmf" else self.csr
        return src.nrows

    @property
    def ncols(self) -> int:
        src = self.mmf if self.kind == "mmf" else self.csr
        return src.ncols

    def tocoo(self):
        src = self.mmf if self.kind == "mmf" else self.csr
        return src.tocoo()


def input_load_csr(rowptr, colind, values, nrows: int, ncols: int,
                   indexing: int = INDEX_ZERO_BASED) -> Input:
    """``spx_input_load_csr`` parity (ref ``src/api/matvec.c:163``)."""
    csr = CSR(nrows, ncols, rowptr, colind, values,
              zero_based=(indexing == INDEX_ZERO_BASED))
    return Input(kind="csr", csr=csr)


def input_load_mmf(filename: str) -> Input:
    """``spx_input_load_mmf`` parity (ref ``src/api/matvec.c:217``)."""
    cfg = Config.instance()
    mmf = load_mmf(filename, keep_lower=cfg.symmetric,
                   index_dtype=cfg.index_dtype, value_dtype=cfg.value_dtype)
    if cfg.symmetric and not mmf.symmetric:
        seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                 "spx.matrix.symmetric set but input is not symmetric")
    return Input(kind="mmf", mmf=mmf)


@dataclass
class Matrix:
    """``spx_matrix_t`` parity: the tuned handle, resident on a device."""

    csx: CsxMatrix
    permutation: Optional[np.ndarray] = None

    @property
    def nrows(self) -> int:
        return self.csx.nrows

    @property
    def ncols(self) -> int:
        return self.csx.ncols

    @property
    def nnz(self) -> int:
        return self.csx.nnz

    @property
    def device(self) -> torch.device:
        return self.csx.device


@dataclass
class Partition:
    """``spx_partition_t`` parity: row ranges per shard."""

    parts: RowPartition
    nrows: int


def input_destroy(input_: Input) -> None:
    """``spx_input_destroy`` parity (the arrays go with the last
    reference to them)."""
    input_.mmf = None
    input_.csr = None


def mat_tune(input_: Input, *flags: str, device=None) -> Matrix:
    """``spx_mat_tune`` parity: CSX preprocessing and host planning, then
    the plan uploaded to ``device`` (default ``cuda:0``): the fused or
    legacy paged plan, or the plain tables when the planner made none.
    Pass ``OP_REORDER`` to RCM-reorder first.  Under
    ``spx.matrix.symmetric`` the matrix is tuned as its lower triangle and
    diagonal (``symmetric.build_symmetric_csx``; an MMF stored as its lower
    triangle is taken as it is), run in the mode ``spx.tpu.sym_full``
    selects (api.py:148-153)."""
    cfg = Config.instance()
    dev = resolve_device(device)
    before = {name: span_seconds(f"spx.tune.{name}")
              for name in ("sort", "encode", "plan", "upload")}
    rows, cols, vals = input_.tocoo()
    nrows, ncols = input_.nrows, input_.ncols
    permutation = None
    if OP_REORDER in flags:
        from sparsex_tpu_torch.reorder import reorder_rcm
        rows, cols, vals, permutation = reorder_rcm(
            nrows, ncols, rows, cols, vals)
    if cfg.symmetric:
        lower_only = input_.kind == "mmf" and input_.mmf.stored_lower_only
        csx = build_symmetric_csx(nrows, ncols, rows, cols, vals,
                                  already_lower=lower_only, config=cfg,
                                  device=dev)
    else:
        csx = CsxMatrix.from_coo(nrows, ncols, rows, cols, vals, config=cfg,
                                 permutation=permutation, device=dev)
    log_info("tuned matrix on %s: %dx%d nnz=%d csx_size=%dB", dev,
             nrows, ncols, csx.nnz, csx.csx_size())
    log_info("tune split: " + ", ".join(
        f"{name} {span_seconds(f'spx.tune.{name}') - s:.6f} s"
        for name, s in before.items())
        + f" of preproc {csx.timers.get_secs('preproc'):.6f} s")
    return Matrix(csx=csx, permutation=permutation)


def mat_get_entry(mat: Matrix, row: int, col: int) -> float:
    """``spx_mat_get_entry`` parity (ref ``src/api/matvec.c:324``)."""
    return mat.csx.get_entry(row, col)


def mat_set_entry(mat: Matrix, row: int, col: int, value: float) -> None:
    """``spx_mat_set_entry`` parity (ref ``src/api/matvec.c:366``): the
    next SpMV plans and uploads the entry's shard again."""
    mat.csx.set_entry(row, col, value)


def mat_save(mat: Matrix, filename: str) -> None:
    """``spx_mat_save`` parity: the reference's archive format
    (``persist.save_csx``)."""
    save_csx(mat.csx, filename, permutation=mat.permutation)


def mat_restore(filename: str, device=None) -> Matrix:
    """``spx_mat_restore`` parity: the matrix on ``device`` (default
    ``cuda:0``), planned from the archive's layouts
    (``persist.restore_csx``)."""
    csx, permutation = restore_csx(filename, device)
    return Matrix(csx=csx, permutation=permutation)


def mat_get_partition(mat: Matrix) -> Partition:
    """``spx_mat_get_partition`` parity (ref ``src/api/matvec.c:485``)."""
    return Partition(parts=mat.csx.partition, nrows=mat.nrows)


def mat_destroy(mat: Matrix) -> None:
    """``spx_mat_destroy`` parity: drops the executors and their CUDA
    graphs."""
    if mat.csx is not None:
        mat.csx.release()
    mat.csx = None


def partition_csr(rowptr, nrows: int, nparts: int) -> Partition:
    """``spx_partition_csr`` parity (ref ``src/api/matvec.c:689``)."""
    counts = np.diff(np.asarray(rowptr, dtype=np.int64))
    return Partition(parts=split_rows_by_nnz(counts, nparts), nrows=nrows)


def _on(mat: Matrix, device) -> None:
    if device is not None and resolve_device(device) != mat.device:
        raise SparsexError(
            ErrorCode.SPX_ERR_ARG_INVALID,
            f"matrix is on {mat.device}, call asked for {device}")


def matvec_mult(alpha: float, mat: Matrix, x, device=None):
    """``spx_matvec_mult`` parity: y = alpha*A*x."""
    with span("spx.api.matvec_mult"):
        _on(mat, device)
        return mat.csx.mult(x, alpha=alpha)


def matvec_kernel(alpha: float, mat: Matrix, x, beta: float, y,
                  device=None):
    """``spx_matvec_kernel`` parity: y = alpha*A*x + beta*y."""
    with span("spx.api.matvec_kernel"):
        _on(mat, device)
        return mat.csx.matvec(x, alpha=alpha, beta=beta, y=y)


def matmat_mult(alpha: float, mat: Matrix, X, device=None):
    """SpMM: Y = alpha*A*X with X of shape (ncols, k) (the reference's
    multi-RHS extension of ``spx_matvec_mult``, api.py:209-215)."""
    with span("spx.api.matmat_mult"):
        _on(mat, device)
        return mat.csx.matmat(X, alpha=alpha, beta=0.0)


def matmat_kernel(alpha: float, mat: Matrix, X, beta: float, Y,
                  device=None):
    """SpMM: Y = alpha*A*X + beta*Y (multi-RHS ``spx_matvec_kernel``,
    api.py:218-220)."""
    with span("spx.api.matmat_kernel"):
        _on(mat, device)
        return mat.csx.matmat(X, alpha=alpha, beta=beta, Y=Y)


def spgemm(a: Matrix, b: Matrix) -> Matrix:
    """C = A @ B as a new tuned matrix on A's device (see
    ``sparsex_tpu_torch/ops/spgemm.py``; ref api.py:223-226)."""
    from sparsex_tpu_torch.ops.spgemm import spgemm as _spgemm
    return Matrix(csx=_spgemm(a.csx, b.csx))


_csr_cache = OrderedDict()
_CSR_CACHE_MAX = 16


def matvec_kernel_csr(rowptr, colind, values, nrows, ncols,
                      alpha: float, x, beta: float, y, device=None):
    """``spx_matvec_kernel_csr`` parity (ref ``src/api/matvec.c:622``,
    api.py:235-259): tunes onto ``device`` (default ``cuda:0``) at the
    first call for the given CSR buffers, then runs ``matvec_kernel``.

    The cache keys on the buffers' identity, as the reference's does (its
    C callers keep the buffers alive); the entry holds strong references to
    the keyed buffers, so a cached id can never alias a freed matrix.  An
    LRU of ``_CSR_CACHE_MAX`` tuned matrices; call
    :func:`matvec_kernel_csr_invalidate` to drop entries eagerly (after a
    change to a buffer's values, for one)."""
    dev = resolve_device(device)
    key = (id(rowptr), id(colind), id(values), nrows, ncols, str(dev))
    entry = _csr_cache.get(key)
    if entry is None:
        inp = input_load_csr(rowptr, colind, values, nrows, ncols)
        entry = (mat_tune(inp, device=dev), rowptr, colind, values)
        _csr_cache[key] = entry
        while len(_csr_cache) > _CSR_CACHE_MAX:
            _csr_cache.popitem(last=False)
    else:
        _csr_cache.move_to_end(key)
    return matvec_kernel(alpha, entry[0], x, beta, y)


def matvec_kernel_csr_invalidate(rowptr=None, colind=None, values=None):
    """Drop the cached tuned matrices of the given CSR buffers (all three
    None: the whole cache; ref api.py:262-271)."""
    if rowptr is None and colind is None and values is None:
        _csr_cache.clear()
        return
    ids = (id(rowptr), id(colind), id(values))
    for key in [k for k in _csr_cache if k[:3] == ids]:
        del _csr_cache[key]


__all__ = ["OP_REORDER", "INDEX_ZERO_BASED", "INDEX_ONE_BASED", "init",
           "finalize", "Input", "Matrix", "Partition", "input_load_csr",
           "input_load_mmf", "input_destroy", "mat_tune", "mat_get_entry",
           "mat_set_entry", "mat_save", "mat_restore", "mat_get_partition",
           "mat_destroy", "partition_csr", "matvec_mult", "matvec_kernel",
           "matvec_kernel_csr", "matvec_kernel_csr_invalidate",
           "matmat_mult", "matmat_kernel", "spgemm"]
