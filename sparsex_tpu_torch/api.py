"""Public API of the PyTorch port (counterpart of ``sparsex_tpu/api.py``).

Loading, options and errors are the reference's own host code, re-exported
unchanged; tuning and the SpMV kernels run on a PyTorch device:

=====================================  =====================================
reference                               sparsex_tpu_torch
=====================================  =====================================
``spx_input_load_csr / _mmf``           ``input_load_csr / input_load_mmf``
``spx_mat_tune``                        ``mat_tune(input, *flags, device=)``
``spx_matvec_mult``                     ``matvec_mult(alpha, A, x, device=)``
``spx_matvec_kernel``                   ``matvec_kernel(alpha, A, x, beta,
                                        y, device=)``
``spx_option_set / get``                ``option_set / option_get``
=====================================  =====================================

``device`` defaults to ``cuda:0`` for tuning; the SpMV calls run where the
matrix lives, and a ``device`` given to them must name that device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from sparsex_tpu.api import (INDEX_ONE_BASED, INDEX_ZERO_BASED, OP_REORDER,
                             Input, input_load_csr, input_load_mmf)
from sparsex_tpu.config import Config
from sparsex_tpu.errors import ErrorCode, SparsexError
from sparsex_tpu.logger import log_info
from sparsex_tpu_torch.csx import CsxMatrix
from sparsex_tpu_torch.device import resolve_device


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


def mat_tune(input_: Input, *flags: str, device=None) -> Matrix:
    """``spx_mat_tune`` parity: CSX preprocessing and host planning, then
    the plan uploaded to ``device`` (default ``cuda:0``).  Pass
    ``OP_REORDER`` to RCM-reorder first."""
    cfg = Config.instance()
    if cfg.symmetric:
        raise NotImplementedError(
            "symmetric matrices (spx.matrix.symmetric) are not ported yet; "
            "see ROADMAP.md Queue 1 item 8")
    dev = resolve_device(device)
    rows, cols, vals = input_.tocoo()
    nrows, ncols = input_.nrows, input_.ncols
    permutation = None
    if OP_REORDER in flags:
        from sparsex_tpu.reorder import reorder_rcm
        rows, cols, vals, permutation = reorder_rcm(
            nrows, ncols, rows, cols, vals)
    csx = CsxMatrix.from_coo(nrows, ncols, rows, cols, vals, config=cfg,
                             permutation=permutation, device=dev)
    log_info("tuned matrix on %s: %dx%d nnz=%d csx_size=%dB", dev,
             nrows, ncols, csx.nnz, csx.csx_size())
    return Matrix(csx=csx, permutation=permutation)


def _on(mat: Matrix, device) -> None:
    if device is not None and resolve_device(device) != mat.device:
        raise SparsexError(
            ErrorCode.SPX_ERR_ARG_INVALID,
            f"matrix is on {mat.device}, call asked for {device}")


def matvec_mult(alpha: float, mat: Matrix, x, device=None):
    """``spx_matvec_mult`` parity: y = alpha*A*x."""
    _on(mat, device)
    return mat.csx.mult(x, alpha=alpha)


def matvec_kernel(alpha: float, mat: Matrix, x, beta: float, y,
                  device=None):
    """``spx_matvec_kernel`` parity: y = alpha*A*x + beta*y."""
    _on(mat, device)
    return mat.csx.matvec(x, alpha=alpha, beta=beta, y=y)


__all__ = ["OP_REORDER", "INDEX_ZERO_BASED", "INDEX_ONE_BASED", "Input",
           "Matrix", "input_load_csr", "input_load_mmf", "mat_tune",
           "matvec_mult", "matvec_kernel"]
