"""CsxMatrix on PyTorch: the tuned matrix handle.

Counterpart of ``sparsex_tpu/csx.py``.  Encoding is the reference's own
(``sparsex_tpu.csx.CsxMatrix.from_coo``: partition, mine, encode); each
shard's reference executor is then wrapped in a
:class:`~sparsex_tpu_torch.ops.exec.CsxExecutor` that plans on the host and
holds the plan on the device.  One shard is supported so far
(``spx.rt.nr_threads`` = 1, the default).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from sparsex_tpu.config import Config
from sparsex_tpu.csx import CsxMatrix as _RefCsxMatrix
from sparsex_tpu.errors import ErrorCode, seterror
from sparsex_tpu_torch.device import resolve_device
from sparsex_tpu_torch.ops.exec import CsxExecutor


@dataclass
class CsxMatrix:
    nrows: int
    ncols: int
    nnz: int
    device: torch.device
    reference: _RefCsxMatrix
    executors: List[CsxExecutor] = field(default_factory=list)
    permutation: Optional[np.ndarray] = None

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows, cols, vals, *,
                 config: Optional[Config] = None,
                 permutation: Optional[np.ndarray] = None,
                 device=None) -> "CsxMatrix":
        """Tune on the host (the reference encoder and planners) and upload
        each shard's fused plan to ``device`` (default ``cuda:0``)."""
        cfg = config or Config.instance()
        if cfg.nr_threads > 1:
            raise NotImplementedError(
                "more than one shard (spx.rt.nr_threads > 1) is not ported "
                "yet; see ROADMAP.md Queue 1 item 5")
        dev = resolve_device(device)
        ref = _RefCsxMatrix.from_coo(nrows, ncols, rows, cols, vals,
                                     config=cfg, permutation=permutation)
        executors = [CsxExecutor.from_reference(ex, dev)
                     for ex in ref.executors]
        return cls(nrows=ref.nrows, ncols=ref.ncols, nnz=ref.nnz,
                   device=dev, reference=ref, executors=executors,
                   permutation=permutation)

    def matvec(self, x, alpha=1.0, beta=0.0, y=None):
        """y = alpha*A*x + beta*y (``spx_matvec_kernel`` semantics, ref
        ``csx.py:108-120``), as a tensor on the matrix's device."""
        if np.ndim(x) != 1:
            raise NotImplementedError(
                "x must be a vector: SpMM is not ported yet; see ROADMAP.md "
                "Queue 1 item 9")
        if np.shape(x)[0] != self.ncols:
            seterror(ErrorCode.SPX_ERR_VEC_DIM,
                     f"x has {np.shape(x)[0]} entries, expected {self.ncols}")
        if y is not None and np.shape(y)[0] != self.nrows:
            seterror(ErrorCode.SPX_ERR_VEC_DIM,
                     f"y has {np.shape(y)[0]} entries, expected {self.nrows}")
        return self.executors[0](x, alpha=alpha, beta=beta, y=y)

    def mult(self, x, alpha=1.0):
        """y = alpha*A*x (``spx_matvec_mult`` parity: y zeroed first)."""
        return self.matvec(x, alpha=alpha, beta=0.0)

    def csx_size(self) -> int:
        return self.reference.csx_size()
