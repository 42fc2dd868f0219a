"""CsxMatrix on PyTorch: the tuned matrix handle.

Counterpart of ``sparsex_tpu/csx.py``.  Tuning is the reference's pipeline
on the port's own copies (``CsxMatrix.from_coo``, csx.py:46-105): the
nnz-balanced row partition, then per shard the DRLE mining and encoding
into ``CsxTables``; each shard's tables are then planned on the host and
held on the device by a :class:`~sparsex_tpu_torch.ops.exec.CsxExecutor`:
the paged plan when the planner made one (fused or legacy paged), else the
plain tables.  One shard is supported so far (``spx.rt.nr_threads`` = 1,
the default).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from sparsex_tpu_torch.config import Config
from sparsex_tpu_torch.device import resolve_device, tune_host_allocator
from sparsex_tpu_torch.errors import ErrorCode, seterror
from sparsex_tpu_torch.logger import log_info
from sparsex_tpu_torch.ops.exec import CsxExecutor
from sparsex_tpu_torch.parallel.partition import (RowPartition,
                                                  row_counts_from_coo,
                                                  split_rows_by_nnz)
from sparsex_tpu_torch.preprocess.encoder import Encoder
from sparsex_tpu_torch.preprocess.mining import is_sorted_rc, lexsort_rc, take1
from sparsex_tpu_torch.preprocess.tables import CsxTables
from sparsex_tpu_torch.timing import TimerCollection


def round_values(vals, value_type: str) -> np.ndarray:
    """``vals`` as the host tables hold them: in ``value_type``, and for a
    bf16 matrix rounded to bf16 through torch and kept as float32 (NumPy
    has no bf16 without ``ml_dtypes``; the reference's tables are bf16)."""
    if value_type != "bfloat16":
        return np.asarray(vals, dtype=value_type)
    v = torch.from_numpy(np.ascontiguousarray(vals, dtype=np.float32))
    return v.to(torch.bfloat16).float().numpy()


def encode_coo(nrows: int, ncols: int, rows, cols, vals,
               cfg: Config) -> Tuple[RowPartition, CsxTables, List[str]]:
    """Partition, mine and encode one shard on the host (the reference's
    ``CsxMatrix.from_coo``, csx.py:46-105, for ``nr_threads`` = 1): returns
    the row partition, the shard's ``CsxTables`` and its encoding log."""
    if cfg._typed("spx.tpu.host_malloc_tune"):
        tune_host_allocator()   # recycle big host temporaries
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = round_values(vals, cfg.value_type)
    part = split_rows_by_nnz(row_counts_from_coo(rows, nrows), 1)
    if not is_sorted_rc(rows, cols):
        order = lexsort_rc(rows, cols)
        rows, cols = take1(rows, order), take1(cols, order)
        vals = take1(vals, order)
    r0 = part.row_start[0]
    enc = Encoder(part.row_end[0] - r0, ncols, rows - r0, cols, vals,
                  config=cfg)
    enc.encode()
    return part, enc.finalize(row_start=r0), enc.encoding_log


@dataclass
class CsxMatrix:
    nrows: int
    ncols: int
    nnz: int
    device: torch.device
    shards: List[CsxTables] = field(default_factory=list)
    executors: List[CsxExecutor] = field(default_factory=list)
    partition: Optional[RowPartition] = None
    permutation: Optional[np.ndarray] = None
    timers: TimerCollection = field(default_factory=TimerCollection)

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows, cols, vals, *,
                 config: Optional[Config] = None,
                 permutation: Optional[np.ndarray] = None,
                 device=None) -> "CsxMatrix":
        """Tune on the host (partition, mine, encode, plan) and upload each
        shard's plan to ``device`` (default ``cuda:0``)."""
        cfg = config or Config.instance()
        if cfg.nr_threads > 1:
            raise NotImplementedError(
                "more than one shard (spx.rt.nr_threads > 1) is not ported "
                "yet; see ROADMAP.md Queue 1 item 5")
        dev = resolve_device(device)
        mat = cls(nrows=int(nrows), ncols=int(ncols), nnz=int(np.size(rows)),
                  device=dev, permutation=permutation)
        mat.timers.start_timer("preproc")
        part, tables, log = encode_coo(nrows, ncols, rows, cols, vals, cfg)
        mat.partition = part
        mat.shards.append(tables)
        mat.executors.append(CsxExecutor.from_tables(tables, dev))
        log_info("shard 0: rows [%d,%d) nnz=%d encodings=%s csx_size=%dB",
                 part.row_start[0], part.row_end[0], mat.nnz,
                 ",".join(log) or "none", tables.csx_size())
        mat.timers.pause_timer("preproc")
        return mat

    def matvec(self, x, alpha=1.0, beta=0.0, y=None):
        """y = alpha*A*x + beta*y (``spx_matvec_kernel`` semantics, ref
        ``csx.py:108-127``), as a tensor on the matrix's device; an x of
        shape (ncols, k) gives the SpMM (nrows, k), as in the reference."""
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

    def matmat(self, X, alpha=1.0, beta=0.0, Y=None):
        """SpMM: Y = alpha*A*X + beta*Y with X (ncols, k), as a tensor
        (nrows, k) on the matrix's device (ref ``csx.py:227-244``, with its
        shape checks)."""
        if np.ndim(X) != 2 or np.shape(X)[0] != self.ncols:
            seterror(ErrorCode.SPX_ERR_VEC_DIM,
                     f"X must be ({self.ncols}, k), got {tuple(np.shape(X))}")
        if Y is not None and tuple(np.shape(Y)) != (self.nrows,
                                                    np.shape(X)[1]):
            seterror(ErrorCode.SPX_ERR_VEC_DIM,
                     f"Y must be ({self.nrows}, {np.shape(X)[1]})")
        return self.matvec(X, alpha=alpha, beta=beta, y=Y)

    def csx_size(self) -> int:
        return sum(t.csx_size() for t in self.shards)
