"""CsxMatrix on PyTorch: the tuned matrix handle.

Counterpart of ``sparsex_tpu/csx.py``.  Tuning is the reference's pipeline
on the port's own copies (``CsxMatrix.from_coo``, csx.py:46-105): the
nnz-balanced row partition into ``spx.rt.nr_threads`` shards, then per
shard, in a thread pool, the DRLE mining and encoding into ``CsxTables``;
each shard's tables are then planned on the host and held on the device by
a :class:`~sparsex_tpu_torch.ops.exec.CsxExecutor`: the paged plan when the
planner made one (fused or legacy paged), else the plain tables.  A matrix
of several shards runs them as one
:class:`~sparsex_tpu_torch.ops.exec.ShardsExecutor` (one CUDA graph a call
on the card for all shards).

The host tables are the source of every value: ``set_entry`` writes them
and marks the shard stale; the next SpMV plans and uploads that shard again
and drops every graph that read it (the reference's lazy invalidation,
csx.py:367-379), so that a sweep of writes plans once.
"""

from __future__ import annotations

import os
import statistics
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, Set, Tuple

import numpy as np
import torch

from sparsex_tpu_torch.config import Config
from sparsex_tpu_torch.device import resolve_device, tune_host_allocator
from sparsex_tpu_torch.errors import ErrorCode, seterror, setwarning
from sparsex_tpu_torch.logger import log_info
from sparsex_tpu_torch.ops.exec import CsxExecutor, ShardsExecutor
from sparsex_tpu_torch.parallel.partition import (RowPartition,
                                                  row_counts_from_coo,
                                                  split_rows_by_nnz)
from sparsex_tpu_torch.preprocess.encoder import Encoder
from sparsex_tpu_torch.preprocess.mining import is_sorted_rc, lexsort_rc, take1
from sparsex_tpu_torch.preprocess.tables import CsxTables
from sparsex_tpu_torch.preprocess.xform import run_step
from sparsex_tpu_torch.timing import TimerCollection


def round_values(vals, value_type: str) -> np.ndarray:
    """``vals`` as the host tables hold them: in ``value_type``, and for a
    bf16 matrix rounded to bf16 through torch and kept as float32 (NumPy
    has no bf16 without ``ml_dtypes``; the reference's tables are bf16)."""
    if value_type != "bfloat16":
        return np.asarray(vals, dtype=value_type)
    v = torch.from_numpy(np.ascontiguousarray(vals, dtype=np.float32))
    return v.to(torch.bfloat16).float().numpy()


def map_shards(fn, nparts: int) -> list:
    """``[fn(i) for i in range(nparts)]``, on a thread pool when there are
    several (the reference's PreprocessThread per partition,
    ``CsxBuild.hpp:290-341``; the hot loops are native C++ and NumPy,
    which release the GIL)."""
    if nparts == 1:
        return [fn(0)]
    workers = min(nparts, max(1, os.cpu_count() or 1))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, range(nparts)))


def shard_encoder(nrows: int, ncols: int, rows, cols, vals, cfg: Config,
                  nparts: int):
    """``(partition, encode)``: the nnz-balanced partition into ``nparts``
    shards of the COO, sorted row-major with the values in the matrix's
    value type (ref csx.py:55-73), and ``encode(i)``, which mines and
    encodes shard i and returns its ``CsxTables`` and encoding log
    (:79-87)."""
    if cfg._typed("spx.tpu.host_malloc_tune"):
        tune_host_allocator()   # recycle big host temporaries
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = round_values(vals, cfg.value_type)
    part = split_rows_by_nnz(row_counts_from_coo(rows, nrows), nparts)
    if not is_sorted_rc(rows, cols):
        order = lexsort_rc(rows, cols)
        rows, cols = take1(rows, order), take1(cols, order)
        vals = take1(vals, order)
    bounds = np.searchsorted(rows, part.row_start + [nrows])

    def encode(i):
        lo, hi = bounds[i], bounds[i + 1]
        r0 = part.row_start[i]
        enc = Encoder(part.row_end[i] - r0, ncols, rows[lo:hi] - r0,
                      cols[lo:hi], vals[lo:hi], config=cfg)
        enc.encode()
        return enc.finalize(row_start=r0), enc.encoding_log

    return part, encode


def encode_coo(nrows: int, ncols: int, rows, cols, vals,
               cfg: Config) -> Tuple[RowPartition, CsxTables, List[str]]:
    """Partition, mine and encode one shard on the host (the reference's
    ``CsxMatrix.from_coo``, csx.py:46-105, for ``nr_threads`` = 1): returns
    the row partition, the shard's ``CsxTables`` and its encoding log."""
    part, encode = shard_encoder(nrows, ncols, rows, cols, vals, cfg, 1)
    return (part,) + encode(0)


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
    symmetric: bool = False
    # the shards' executor (several shards), built at its first use
    _multi: Optional[ShardsExecutor] = field(default=None, init=False,
                                             repr=False)
    # shards whose values changed since their executor was built
    _stale: Set[int] = field(default_factory=set, init=False, repr=False)
    # shards planned and uploaded again after a value write
    replans: int = field(default=0, init=False)

    @classmethod
    def from_coo(cls, nrows: int, ncols: int, rows, cols, vals, *,
                 config: Optional[Config] = None,
                 permutation: Optional[np.ndarray] = None,
                 device=None) -> "CsxMatrix":
        """Tune on the host (partition, mine, encode, plan) and upload each
        shard's plan to ``device`` (default ``cuda:0``)."""
        cfg = config or Config.instance()
        dev = resolve_device(device)
        nparts = max(1, cfg.nr_threads)
        mat = cls(nrows=int(nrows), ncols=int(ncols), nnz=int(np.size(rows)),
                  device=dev, permutation=permutation)
        mat.timers.start_timer("preproc")
        part, encode = shard_encoder(nrows, ncols, rows, cols, vals, cfg,
                                     nparts)
        mat.partition = part

        def build(i):   # encode, plan and upload shard i
            tables, log = encode(i)
            return tables, log, CsxExecutor.from_tables(tables, dev)

        for i, (tables, log, ex) in enumerate(map_shards(build, nparts)):
            mat.shards.append(tables)
            mat.executors.append(ex)
            log_info("shard %d: rows [%d,%d) nnz=%d encodings=%s "
                     "csx_size=%dB", i, part.row_start[i], part.row_end[i],
                     part.nnz_per_part[i], ",".join(log) or "none",
                     tables.csx_size())
        mat.timers.pause_timer("preproc")
        return mat

    # ------------------------------------------------------------------
    def _executor(self) -> CsxExecutor:
        """The executor a call runs: the one shard's, or the shards' one
        :class:`ShardsExecutor`; a shard whose values changed is planned
        and uploaded again first."""
        self._refresh()
        if len(self.executors) == 1:
            return self.executors[0]
        if self._multi is None or self._multi.shards != self.executors:
            self._multi = ShardsExecutor(self.executors, self.nrows,
                                         self.ncols)
        return self._multi

    def _refresh(self) -> None:
        """Plan and upload again each shard whose values changed; its old
        executor and graphs, and the shards' executor with its graph, go
        before the new upload."""
        if not self._stale:
            return
        self._multi = None
        for si in sorted(self._stale):
            self._replan(si)
            self.replans += 1
        self._stale.clear()

    def _replan(self, si: int) -> None:
        self.executors[si] = None
        self.executors[si] = CsxExecutor.from_tables(self.shards[si],
                                                     self.device)

    def release(self) -> None:
        """Drop every executor and its graphs (``mat_destroy``)."""
        self.executors.clear()
        self._multi = None

    def matvec(self, x, alpha=1.0, beta=0.0, y=None):
        """y = alpha*A*x + beta*y (``spx_matvec_kernel`` semantics, ref
        ``csx.py:108-161``), as a tensor on the matrix's device; an x of
        shape (ncols, k) gives the SpMM (nrows, k), as in the reference."""
        if np.shape(x)[0] != self.ncols:
            seterror(ErrorCode.SPX_ERR_VEC_DIM,
                     f"x has {np.shape(x)[0]} entries, expected {self.ncols}")
        if y is not None and np.shape(y)[0] != self.nrows:
            seterror(ErrorCode.SPX_ERR_VEC_DIM,
                     f"y has {np.shape(y)[0]} entries, expected {self.nrows}")
        return self._executor()(x, alpha=alpha, beta=beta, y=y)

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

    def measure_load_imbalance(self, x=None, loops: int = 32,
                               outer: int = 5):
        """Measured seconds per SpMV of each shard and ``(max-min)/min``
        (the reference's per-thread ``spm_mt_thread_t.secs`` report,
        ``SpmMt.hpp:31-63``, ref csx.py:167-225).  Each shard's executor
        runs alone: on the card its own SpMV graph is captured and
        replayed, timed by CUDA events (median of ``outer`` x ``loops``
        replays; the graphs are dropped after); on the CPU its eager body,
        timed by ``time.perf_counter`` the same way.  Logged at INFO as the
        runtime complement of ``parallel.partition.load_imbalance``."""
        self._executor()
        execs = self.executors
        if x is None:
            x = np.random.default_rng(0).standard_normal(self.ncols)
        x = execs[0]._as_vector(x, "x")
        secs = []
        for ex in execs:
            ex(x)
            times = []
            if x.device.type == "cuda":
                g = ex._graphs[("mv",)]
                with ex._on_device():
                    for _ in range(outer):
                        t0 = torch.cuda.Event(enable_timing=True)
                        t1 = torch.cuda.Event(enable_timing=True)
                        t0.record()
                        for _ in range(loops):
                            g.graph.replay()
                        t1.record()
                        t1.synchronize()
                        times.append(t0.elapsed_time(t1) * 1e-3 / loops)
                del ex._graphs[("mv",)], g
            else:
                for _ in range(outer):
                    t0 = time.perf_counter()
                    for _ in range(loops):
                        ex(x)
                    times.append((time.perf_counter() - t0) / loops)
            secs.append(statistics.median(times))
        mn, mx = min(secs), max(secs)
        imb = (mx - mn) / mn if mn > 0 else 0.0
        log_info("==== RUNTIME LOAD BALANCE ====")
        for i, s in enumerate(secs):
            log_info("shard %d: %.3e s/SpMV", i, s)
        log_info("load imbalance (max-min)/min = %.3f", imb)
        return secs, imb

    # ------------------------------------------------------------------
    def csx_size(self) -> int:
        return sum(t.csx_size() for t in self.shards)

    def _find_shard(self, row: int) -> int:
        for i in range(self.partition.nparts):
            s, e = self.partition.bounds(i)
            if s <= row < e:
                return i
        seterror(ErrorCode.SPX_ERR_OUT_OF_BOUNDS, f"row {row} out of bounds")
        return -1

    def _locate(self, row: int, col: int):
        """``(kind, table, index)`` of entry (row, col), or None (copied
        from ref csx.py:259-317): each table kind's closed-form membership
        test, evaluated vectorised per table."""
        si = self._find_shard(row)
        tables = self.shards[si]
        r = row - tables.row_start
        for t in tables.dias:
            o = (r + col) if t.anti else (col - r)
            hits = np.nonzero(t.offsets == o)[0]
            if hits.size and t.mask is not None and t.mask[int(hits[0]), r]:
                return ("dia", t, (int(hits[0]), r))
        d = tables.delta
        if d is not None and d.nnz:
            lo, hi = int(d.rowptr[r]), int(d.rowptr[r + 1])
            hits = np.nonzero(d.cols[lo:hi] == col)[0]
            if hits.size:
                return ("delta", d, lo + int(hits[0]))
        for t in tables.runs:
            sr, sc = run_step(t.enc)
            dr, dc = sr * t.delta, sc * t.delta
            rows64 = t.rows.astype(np.int64)
            cols64 = t.cols.astype(np.int64)
            if dr == 0:
                cand = rows64 == r
                j = np.where(dc != 0, (col - cols64), -1)
            else:
                num = r - rows64
                cand = (num % dr == 0) & (num >= 0)
                j = num // dr
            with np.errstate(divide="ignore", invalid="ignore"):
                if dc != 0:
                    jc = (col - cols64) // dc
                    okc = ((col - cols64) % dc == 0) & (jc >= 0)
                    if dr == 0:
                        j, cand = jc, cand & okc
                    else:
                        cand = cand & okc & (jc == j)
                else:
                    cand = cand & (cols64 == col)
            cand = cand & (j >= 0) & (j < t.sizes.astype(np.int64))
            hits = np.nonzero(cand)[0]
            if hits.size:
                u = int(hits[0])
                return ("run", t, (u, int(j[u])))
        for t in tables.blocks:
            rows64 = t.rows.astype(np.int64)
            cols64 = t.cols.astype(np.int64)
            cand = ((rows64 <= r) & (r < rows64 + t.br)
                    & (cols64 <= col) & (col < cols64 + t.bc))
            hits = np.nonzero(cand)[0]
            if hits.size:
                u = int(hits[0])
                return ("block", t, (u, r - int(rows64[u]),
                                     col - int(cols64[u])))
        return None

    def _check_entry(self, row: int, col: int) -> Tuple[int, int]:
        if not (0 <= row < self.nrows and 0 <= col < self.ncols):
            seterror(ErrorCode.SPX_ERR_OUT_OF_BOUNDS, "entry out of bounds")
        return int(row), int(col)

    def get_entry(self, row: int, col: int) -> float:
        """``spx_mat_get_entry`` parity (ref csx.py:319-339), read from the
        host tables."""
        row, col = self._check_entry(row, col)
        loc = self._locate(row, col)
        if loc is None:
            seterror(ErrorCode.SPX_ERR_ENTRY_NOT_FOUND,
                     f"entry ({row},{col}) not found")
        arr, idx = self._cell(loc)
        return float(arr[idx])

    def _cell(self, loc):
        """The value array and index of a located entry (a symmetric
        matrix's diagonal: its shard's ``dvalues``)."""
        kind, t, idx = loc
        if kind == "diag":
            return self.dvalues[t], idx
        return t.vals, idx

    def _value(self, value: float) -> float:
        """``value`` as a bf16 matrix's tables hold it: rounded to bf16
        (the tables' arrays round to their own dtype on assignment)."""
        if self.shards[0].value_type == "bfloat16":
            return float(round_values([value], "bfloat16")[0])
        return value

    def set_entry(self, row: int, col: int, value: float) -> None:
        """``spx_mat_set_entry`` parity (ref csx.py:341-365): only a stored
        entry can be set (the structure is immutable).  The host tables
        take the value at once; the shard's device copies go stale and are
        planned and uploaded again at the next call."""
        row, col = self._check_entry(row, col)
        loc = self._locate(row, col)
        if loc is None:
            setwarning(ErrorCode.SPX_WARN_ENTRY_NOT_SET,
                       f"entry ({row},{col}) not found; not set")
            return
        arr, idx = self._cell(loc)
        arr[idx] = self._value(value)
        self._stale.add(self._find_shard(row))

    def tocoo(self):
        """Expand all tables back to COO, sorted row-major (copied from ref
        csx.py:381-430)."""
        out_r, out_c, out_v = [], [], []
        for tables in self.shards:
            r0 = tables.row_start
            d = tables.delta
            if d is not None and d.nnz:
                out_r.append(d.row_ids.astype(np.int64) + r0)
                out_c.append(d.cols.astype(np.int64))
                out_v.append(np.asarray(d.vals))
            for t in tables.runs:
                sr, sc = run_step(t.enc)
                lane = np.arange(t.width, dtype=np.int64)
                mask = lane[None, :] < t.sizes[:, None].astype(np.int64)
                rr = (t.rows[:, None].astype(np.int64)
                      + sr * t.delta * lane[None, :] + r0)
                cc = (t.cols[:, None].astype(np.int64)
                      + sc * t.delta * lane[None, :])
                out_r.append(rr[mask])
                out_c.append(cc[mask])
                out_v.append(np.asarray(t.vals)[mask])
            for t in tables.dias:
                kidx, ridx = np.nonzero(t.mask)
                offs = t.offsets[kidx]
                cc = offs - ridx if t.anti else offs + ridx
                out_r.append(ridx.astype(np.int64) + r0)
                out_c.append(cc.astype(np.int64))
                out_v.append(np.asarray(t.vals)[kidx, ridx])
            for t in tables.blocks:
                br_i = np.arange(t.br, dtype=np.int64)
                bc_i = np.arange(t.bc, dtype=np.int64)
                rr = (t.rows[:, None, None].astype(np.int64)
                      + br_i[None, :, None] + r0)
                cc = (t.cols[:, None, None].astype(np.int64)
                      + bc_i[None, None, :])
                U = t.rows.size
                out_r.append(np.broadcast_to(rr, (U, t.br, t.bc)).ravel())
                out_c.append(np.broadcast_to(cc, (U, t.br, t.bc)).ravel())
                out_v.append(np.asarray(t.vals).ravel())
        if not out_r:
            e = np.zeros(0, dtype=np.int64)
            return e, e, np.zeros(0)
        rows = np.concatenate(out_r)
        cols = np.concatenate(out_c)
        vals = np.concatenate(out_v)
        order = np.lexsort((cols, rows))
        return rows[order], cols[order], vals[order]
