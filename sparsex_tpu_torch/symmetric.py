"""Symmetric CSX (CSX-Sym) on PyTorch.

Counterpart of ``sparsex_tpu/symmetric.py``: a symmetric matrix is tuned as
its strict lower triangle plus its diagonal per shard
(``build_symmetric_csx``, the reference's ``SparsePartitionSym``), and its
SpMV applies each stored value twice, in two modes (``spx.tpu.sym_full``):

- **full mirror** (``on``; ``auto`` on a CUDA device): the lower-triangle
  tables mirrored at tune time into full-matrix tables
  (:func:`mirror_full_tables`, copied), which a plain
  :class:`~sparsex_tpu_torch.ops.exec.CsxExecutor` plans and runs on the
  port's main path, SpMM included (ref ``_full_active`` /
  ``_full_executor``, symmetric.py:285-307);
- **per shard** (``off``; ``auto`` on the CPU): the shard's own plan
  (:func:`shard_plan`, the reference's ``_build_sym_arrays``,
  symmetric.py:309-379) in a :class:`SymShardExecutor`, whose SpMV is
  ``local_contrib(..., symmetric=True)``: the lower triangle and the
  diagonal into the shard's rows, the upper mirror into every row
  (``ops/kernels.transposed_contrib``: the transposed paged delta stream
  ``dpagesT`` through the delta-pages kernel and its scatter route
  ``dscatterT`` or the kernel's scatter epilogue).  On the card it replays
  a CUDA graph of its own, as every executor does, the counterpart of the
  reference's ``_compiled_sym_multi`` jit cache (symmetric.py:40-64); its
  SpMM runs the SpMV once per column.

``auto`` mirrors the reference's choice: the full mirror where its kernels
run (the TPU there, the card here), per shard elsewhere.  The reference
builds the per-shard page layouts only in float32 (``pallas_dtype_ok``);
the port plans and runs them in float32 and float64 alike, as it does the
paged plan (ROADMAP Queue 3, intended divergences).

Several shards (``spx.rt.nr_threads`` > 1): the full mirror mirrors them
all into one executor, as the reference does (symmetric.py:300-307); per
shard each shard has its own executor at its own ``row_start``, and one
:class:`~sparsex_tpu_torch.ops.exec.ShardsExecutor` sums the shards'
results, the reference's ``_compiled_sym_multi``.  ``get_entry`` /
``set_entry`` read and write the stored triangle and the diagonal
(``dvalues``); a write drops the mirrored executor at once and the shard's
per-shard plan at the next call.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from sparsex_tpu_torch.config import Config
from sparsex_tpu_torch.csx import CsxMatrix, map_shards, round_values
from sparsex_tpu_torch.device import resolve_device
from sparsex_tpu_torch.errors import ErrorCode, seterror
from sparsex_tpu_torch.logger import log_info
from sparsex_tpu_torch.ops.convert import plan_to_torch
from sparsex_tpu_torch.ops.exec import _DTYPES, CsxExecutor, ShardsExecutor
from sparsex_tpu_torch.ops.kernels import (check_slice, local_contrib,
                                           static_meta, tables_to_arrays)
from sparsex_tpu_torch.ops.pallas_kernels import build_delta_pages
from sparsex_tpu_torch.ops.route import build_scatter_plan, fold_sort_key
from sparsex_tpu_torch.parallel.partition import (row_counts_from_coo,
                                                  split_rows_by_nnz)
from sparsex_tpu_torch.preprocess.encoder import Encoder
from sparsex_tpu_torch.preprocess.encodings import EncType
from sparsex_tpu_torch.preprocess.mining import lexsort_rc, take1
from sparsex_tpu_torch.preprocess.tables import (BlockTable, CsxTables,
                                                 DeltaTable, DiagTable,
                                                 RunTable)
from sparsex_tpu_torch.timing import span


@dataclass
class SymShard:
    tables: CsxTables  # strict lower triangle, partition-local rows
    dvalues: np.ndarray  # diagonal values for the shard's rows


def mirror_full_tables(shards: List[CsxTables],
                       dvalues: List[np.ndarray],
                       nrows: int, ncols: int) -> CsxTables:
    """Full-matrix execution tables mirrored from the lower-triangle shards
    (copied from ``sparsex_tpu/symmetric.py:95-273``).

    Structure is preserved under the mirror — each pattern maps onto
    another first-class pattern, so no encoding information is lost:
      horizontal run    -> vertical run   (same delta, same values)
      vertical run      -> horizontal run
      diagonal run      -> diagonal run   (head swapped)
      anti-diag run     -> anti-diag run  (re-anchored, values reversed)
      (br, bc) block    -> (bc, br) block (values transposed)
      DIA offset o      -> DIA offset -o  (values shifted by o)
      anti-DIA s        -> anti-DIA s     (values reversed around s)
      main diagonal     -> DIA offset 0

    The port's tables carry the matrix's value type (``value_type``), so
    a mirror without delta singles (a banded or stencil matrix) computes
    in it; the reference's executor reads the type off the delta table and
    computes such a mirror in float64.
    """
    val_dtype = None
    dr_l, dc_l, dv_l = [], [], []          # delta triples (dest, col, val)
    runs_acc: dict = {}                     # (enc, delta, width) -> lists
    blocks_acc: dict = {}                   # (br, bc) -> (enc, lists)
    dia_acc: dict = {}                      # (anti, offset) -> dense vec
    dia_cnt = {False: 0, True: 0}

    def _dia_add(anti: bool, off: int, lo: int, vec: np.ndarray):
        # clip to [0, nrows): out-of-range positions hold only the zeros
        # the encoder guarantees outside the matrix (a stored element's
        # column is always in range, and placement index = that column)
        a, b = max(0, -lo), min(vec.size, nrows - lo)
        if b <= a or not np.any(vec[a:b]):
            return
        dst = dia_acc.get((anti, int(off)))
        if dst is None:
            dst = dia_acc[(anti, int(off))] = np.zeros(
                nrows, dtype=vec.dtype)
        dst[lo + a: lo + b] += vec[a:b]
        dia_cnt[anti] += int(np.count_nonzero(vec[a:b]))

    for tables in shards:
        r0 = tables.row_start
        d = tables.delta
        if d is not None and d.nnz:
            val_dtype = d.vals.dtype
            rg = np.asarray(d.row_ids, dtype=np.int64) + r0
            c = np.asarray(d.cols, dtype=np.int64)
            dr_l += [rg, c]
            dc_l += [c, rg]
            dv_l += [d.vals, d.vals]
        for t in tables.runs:
            val_dtype = t.vals.dtype
            rg = np.asarray(t.rows, dtype=np.int64) + r0
            c = np.asarray(t.cols, dtype=np.int64)
            W = t.width
            key = (t.enc, t.delta, W)
            runs_acc.setdefault(key, []).append((rg, c, t.sizes, t.vals))
            if t.enc == EncType.HORIZONTAL:
                tkey = (EncType.VERTICAL, t.delta, W)
                runs_acc.setdefault(tkey, []).append((c, rg, t.sizes,
                                                      t.vals))
            elif t.enc == EncType.VERTICAL:
                tkey = (EncType.HORIZONTAL, t.delta, W)
                runs_acc.setdefault(tkey, []).append((c, rg, t.sizes,
                                                      t.vals))
            elif t.enc == EncType.DIAGONAL:
                runs_acc.setdefault(key, []).append((c, rg, t.sizes,
                                                     t.vals))
            else:  # ANTI_DIAGONAL: re-anchor at the last element and
                #    reverse each unit's values (element j of the mirror
                #    is element S-1-j of the original)
                S = np.asarray(t.sizes, dtype=np.int64)
                dlt = t.delta
                hr = c - (S - 1) * dlt
                hc = rg + (S - 1) * dlt
                idx = S[:, None] - 1 - np.arange(W, dtype=np.int64)[None]
                vrev = np.where(idx >= 0,
                                np.take_along_axis(
                                    t.vals, np.maximum(idx, 0), axis=1),
                                np.zeros((), t.vals.dtype))
                runs_acc.setdefault(key, []).append((hr, hc, t.sizes,
                                                     vrev))
        for t in tables.blocks:
            val_dtype = t.vals.dtype
            rg = np.asarray(t.rows, dtype=np.int64) + r0
            c = np.asarray(t.cols, dtype=np.int64)
            blocks_acc.setdefault((t.br, t.bc), [t.enc, []])[1].append(
                (rg, c, t.vals))
            blocks_acc.setdefault((t.bc, t.br), [t.enc, []])[1].append(
                (c, rg, np.ascontiguousarray(t.vals.transpose(0, 2, 1))))
        for t in tables.dias:
            val_dtype = t.vals.dtype
            np_ = tables.nrows
            for k, o in enumerate(t.offsets):
                o = int(o)
                if not t.anti:
                    og = o - r0          # global offset col - row
                    _dia_add(False, og, r0, t.vals[k])
                    # transposed: z[r+og] += dv[r]*x[r]  ->  offset -og
                    # with values shifted to global rows r+og
                    _dia_add(False, -og, r0 + og, t.vals[k])
                else:
                    sg = o + r0          # global anti index row + col
                    _dia_add(True, sg, r0, t.vals[k])
                    # transposed: z[sg-r] += av[r]*x[r] -> same sg,
                    # values reversed onto rows sg-r
                    _dia_add(True, sg, sg - (r0 + np_ - 1),
                             t.vals[k][::-1])
    # main diagonal -> DIA offset 0
    for tables, dv in zip(shards, dvalues):
        if np.any(dv):
            val_dtype = val_dtype if val_dtype is not None else dv.dtype
            _dia_add(False, 0, tables.row_start,
                     np.asarray(dv, dtype=val_dtype
                                if val_dtype is not None else dv.dtype))

    if val_dtype is None:
        val_dtype = np.float64
    index_dtype = shards[0].delta.cols.dtype if shards[0].delta \
        else np.int32

    # --- delta table (sorted by (row, col)) ---
    delta = None
    total_d = 0
    if dr_l:
        dr = np.concatenate(dr_l)
        dc = np.concatenate(dc_l)
        dv = np.concatenate(dv_l)
        order = np.lexsort((dc, dr))
        dr, dc, dv = dr[order], dc[order], dv[order]
        rowptr = np.zeros(nrows + 1, dtype=np.int64)
        np.cumsum(np.bincount(dr, minlength=nrows), out=rowptr[1:])
        delta = DeltaTable(rowptr=rowptr,
                           cols=dc.astype(index_dtype),
                           vals=dv.astype(val_dtype),
                           row_ids=dr.astype(index_dtype))
        total_d = dr.size

    runs = []
    for (enc, dlt, W), parts in sorted(runs_acc.items()):
        runs.append(RunTable(
            enc=enc, delta=int(dlt),
            rows=np.concatenate([p[0] for p in parts]).astype(index_dtype),
            cols=np.concatenate([p[1] for p in parts]).astype(index_dtype),
            sizes=np.concatenate([p[2] for p in parts]).astype(index_dtype),
            vals=np.concatenate([p[3] for p in parts]).astype(val_dtype)))
    blocks = []
    for (br, bc), (enc, parts) in sorted(blocks_acc.items()):
        blocks.append(BlockTable(
            enc=enc,
            rows=np.concatenate([p[0] for p in parts]).astype(index_dtype),
            cols=np.concatenate([p[1] for p in parts]).astype(index_dtype),
            vals=np.concatenate([p[2] for p in parts]).astype(val_dtype)))
    dias = []
    for anti in (False, True):
        offs = sorted(o for (a, o) in dia_acc if a == anti)
        if offs:
            vals = np.stack([dia_acc[(anti, o)] for o in offs])
            dias.append(DiagTable(
                anti=anti,
                offsets=np.asarray(offs, dtype=np.int64),
                vals=vals.astype(val_dtype), mask=None,
                nnz_count=dia_cnt[anti]))
    nnz_full = (total_d + sum(t.nnz for t in runs)
                + sum(t.nnz for t in blocks) + sum(t.nnz for t in dias))
    return CsxTables(nrows=nrows, ncols=ncols, nnz=int(nnz_full),
                     row_start=0, delta=delta, runs=runs, blocks=blocks,
                     dias=dias, value_type=(shards[0].value_type
                                            or np.dtype(val_dtype).name))


def shard_plan(tables: CsxTables, nrows: int, ncols: int,
               gather_off: Optional[int] = None, z_off: int = 0):
    """``(meta, arrays)``: one shard's paged per-shard plan (host arrays)
    as the reference's ``_build_sym_arrays`` makes its ``_sym_paged``
    (symmetric.py:309-379): the shard's tables (``static_meta``,
    ``tables_to_arrays``) plus page-bucketed layouts of the delta singles
    for BOTH contributions where both sides page: the direct stream
    gathers x at the columns (``dpages``), the transposed one at the
    shard's global rows and scatters into the result by column
    (``dpagesT``, ``nrows`` wide, its padding slots' sentinel row
    ``nrows``), each with its scatter route where one plans (``dscatter``
    into the shard's rows, ``dscatterT`` into all rows), their leftovers
    as ``delta`` and ``delta_t`` (whose ``cols`` are rows of the result).
    The reference pages only float32 values, and runs its plain variant
    (the tables alone) elsewhere; the port runs this plan in any type.

    ``ncols`` is the frame of x.  For the multi-device executor's symmetric
    halo mode (``parallel/shard.py``, the reference's
    ``stack_sym_delta_pages`` with ``gather_off`` and ``col_rebase``,
    shard.py:554-664) the tables' columns are in a window's frame of
    ``ncols`` columns starting at global column ``z_off``: the transposed
    stream gathers x at ``row_ids + gather_off`` (default ``row_start``)
    and scatters to ``cols + z_off``, and ``delta_t``'s columns are global
    rows of the result."""
    meta, arrs = static_meta(tables), tables_to_arrays(tables)
    d = tables.delta
    if d is not None and d.nnz:
        cols = np.asarray(d.cols, dtype=np.int64)
        rows = np.asarray(d.row_ids, dtype=np.int64)
        vals = np.asarray(d.vals)
        r0 = tables.row_start if gather_off is None else gather_off
        rep_d, left_d = build_delta_pages(
            cols, rows, vals, ncols, tables.nrows,
            sort_key=fold_sort_key(rows, tables.nrows, cols))
        rep_t, left_t = build_delta_pages(
            rows + r0, cols + z_off, vals, ncols, nrows,
            sort_key=fold_sort_key(cols + z_off, nrows, rows + r0))
        if rep_d is not None and rep_t is not None:
            qd, npd = rep_d.pop("q"), rep_d.pop("npages")
            qt, npt = rep_t.pop("q"), rep_t.pop("npages")
            arrs["delta_pages"] = rep_d
            arrs["delta_pages_t"] = rep_t
            ld = np.sort(left_d) if left_d.size else left_d
            arrs["delta"] = ({"row_ids": d.row_ids[ld], "cols": d.cols[ld],
                              "vals": d.vals[ld]} if left_d.size else None)
            arrs["delta_t"] = {"row_ids": d.row_ids[left_t],
                               "cols": d.cols[left_t] + z_off,
                               "vals": d.vals[left_t]}
            meta = meta + (("dpages", rep_d["plo"].size, qd, npd),
                           ("dpagesT", rep_t["plo"].size, qt, npt))
            # y-sides through the scatter-routing network (ops/route.py):
            # direct into the shard's rows, transposed into global rows
            for rep, n_dest, key, tag in (
                    (rep_d, tables.nrows, "delta_scatter", "dscatter"),
                    (rep_t, nrows, "delta_scatter_t", "dscatterT")):
                plan = build_scatter_plan(
                    np.asarray(rep["rows"], dtype=np.int64), n_dest)
                if plan is not None:
                    dm, da, rp, rd = plan
                    rep.pop("rows")
                    arrs[key] = {"chunks": da, "res_pos": rp, "res_dest": rd}
                    meta = meta + ((tag, dm, bool(rp.size)),)
    return meta, arrs


class SymShardExecutor(CsxExecutor):
    """One symmetric shard's per-shard SpMV on a device: a
    :class:`CsxExecutor` (the same graphs, epilogue and column loop) whose
    body is ``local_contrib(..., symmetric=True)``, the lower triangle and
    the diagonal into the shard's rows plus the upper mirror into all
    ``nrows_glob`` rows.  ``tables`` are the shard's host tables.  In the
    multi-device executor's symmetric halo mode x is a window of
    ``ncols`` columns from global column ``z_off``, in whose frame the
    shard's rows start at ``gather_off`` (:func:`shard_plan`)."""

    def __init__(self, tables: CsxTables, meta, arrays, dtype: torch.dtype,
                 device: torch.device, nrows_glob: int,
                 ncols: Optional[int] = None,
                 gather_off: Optional[int] = None, z_off: int = 0):
        super().__init__(meta, arrays, tables.nrows,
                         tables.ncols if ncols is None else ncols, dtype,
                         device, variant="sym")
        self.tables = tables
        self.row_start = tables.row_start
        self.gather_off = tables.row_start if gather_off is None else (
            gather_off)
        self.z_off = z_off
        self.nrows_glob = nrows_glob

    @classmethod
    def from_plan(cls, tables: CsxTables, meta, host, dvalues, nrows_glob,
                  device, **frame) -> "SymShardExecutor":
        """Upload one shard's per-shard plan (:func:`shard_plan`) and its
        diagonal values to ``device``; ``frame`` (``ncols``,
        ``gather_off``, ``z_off``) as :func:`shard_plan` was given it."""
        check_slice(meta)
        dtype = _DTYPES[tables.value_type or str(np.asarray(dvalues).dtype)]
        arrays = plan_to_torch(meta, dict(host, dvals=dvalues), device, dtype)
        return cls(tables, meta, arrays, dtype, torch.device(device),
                   nrows_glob, **frame)

    def _matvec(self, x: torch.Tensor) -> torch.Tensor:
        acc, z = local_contrib(self.meta, self.arrays, x,
                               nrows_part=self.nrows, ncols=self.ncols,
                               symmetric=True, row_start=self.gather_off,
                               nrows_glob=self.nrows_glob, z_off=self.z_off)
        z[self.row_start:self.row_start + self.nrows] += acc
        return z


@dataclass
class SymCsxMatrix(CsxMatrix):
    """Symmetric tuned matrix: lower triangle + diagonal per shard.
    ``executors`` holds the executors of the mode in use
    (:meth:`_executor`): the full mirror's one, or one per shard."""

    dvalues: List[np.ndarray] = field(default_factory=list)
    _full_exec: Optional[CsxExecutor] = field(default=None, init=False,
                                              repr=False)
    _shard_execs: Optional[List[SymShardExecutor]] = field(
        default=None, init=False, repr=False)

    def __post_init__(self):
        self.symmetric = True

    def _full_active(self) -> bool:
        """Whether SpMV runs on the mirrored full-expansion executor:
        ``spx.tpu.sym_full`` "on", or "auto" on a CUDA device (the
        reference's "auto" follows its kernels' gate, symmetric.py:
        285-298)."""
        mode = Config.instance().sym_full
        if mode == "auto":
            return self.device.type == "cuda"
        return mode == "on"

    def _full_executor(self) -> CsxExecutor:
        if self._full_exec is None:
            with span("spx.tune.plan"):
                ft = mirror_full_tables(self.shards, self.dvalues,
                                        self.nrows, self.ncols)
            log_info("sym full-expansion tables: nnz=%d sig=%s",
                     ft.nnz, ft.signature())
            self._full_exec = CsxExecutor.from_tables(ft, self.device)
        return self._full_exec

    def _build_sym_arrays(self) -> None:
        """Each shard's per-shard plan (:func:`shard_plan`): the
        reference's ``_sym_paged`` list."""
        self._sym_paged = [shard_plan(t, self.nrows, self.ncols)
                           for t in self.shards]

    def _shard_plan(self, si: int):
        """Shard ``si``'s per-shard plan, made once (an entry of
        ``_sym_paged``; a value write drops it)."""
        if not hasattr(self, "_sym_paged"):
            self._sym_paged = [None] * len(self.shards)
        if self._sym_paged[si] is None:
            with span("spx.tune.plan"):
                self._sym_paged[si] = shard_plan(self.shards[si], self.nrows,
                                                 self.ncols)
        return self._sym_paged[si]

    def _shard_executors(self) -> List[SymShardExecutor]:
        if self._shard_execs is None:
            self._shard_execs = [None] * len(self.shards)
        for si, ex in enumerate(self._shard_execs):
            if ex is None:
                meta, host = self._shard_plan(si)
                self._shard_execs[si] = SymShardExecutor.from_plan(
                    self.shards[si], meta, host, self.dvalues[si],
                    self.nrows, self.device)
        return self._shard_execs

    def _executor(self) -> CsxExecutor:
        """The executor of the mode ``spx.tpu.sym_full`` selects now (built
        at its first use): the full mirror's, the one shard's, or the
        shards' :class:`ShardsExecutor` whose results are summed (the
        reference's ``_compiled_sym_multi``); ``executors`` then holds the
        mode's per-shard executors."""
        self._refresh()
        if self._full_active():
            self.executors[:] = [self._full_executor()]
            return self.executors[0]
        self.executors[:] = self._shard_executors()
        if len(self.executors) == 1:
            return self.executors[0]
        if self._multi is None or self._multi.shards != self.executors:
            self._multi = ShardsExecutor(self.executors, self.nrows,
                                         self.ncols, summed=True)
        return self._multi

    def _replan(self, si: int) -> None:
        """A value of shard ``si`` changed: its per-shard plan and executor
        are made again at their next use (the full mirror was dropped at
        the write)."""
        if hasattr(self, "_sym_paged"):
            self._sym_paged[si] = None
        if self._shard_execs is not None:
            self._shard_execs[si] = None
        self.executors[:] = []

    def release(self) -> None:
        super().release()
        self._full_exec = self._shard_execs = None

    def _locate(self, row: int, col: int):
        """Lower-triangle lookup; the diagonal lives in ``dvalues``
        (ref symmetric.py:452-457)."""
        si = self._find_shard(row)
        if row == col:
            return ("diag", si, row - self.shards[si].row_start)
        return super()._locate(row, col)

    def get_entry(self, row: int, col: int) -> float:
        """An entry of the full matrix: ``col > row`` reads its mirror
        (ref symmetric.py:459-465)."""
        row, col = self._check_entry(row, col)
        return super().get_entry(max(row, col), min(row, col))

    def set_entry(self, row: int, col: int, value: float) -> None:
        """Sets an entry and its mirror (the one stored value; ref
        symmetric.py:467-486).  The mirrored executor is dropped at once,
        the shard's per-shard plan at the next call."""
        row, col = self._check_entry(row, col)
        self._full_exec = None   # mirrored copies go stale on any write
        if self.executors and not isinstance(self.executors[0],
                                             SymShardExecutor):
            self.executors[:] = []
        super().set_entry(max(row, col), min(row, col), value)

    def tocoo(self):
        """Expand to the full (mirrored) COO (ref symmetric.py:488-500)."""
        r, c, v = super().tocoo()
        dr, dv = [], []
        for tables, dvals in zip(self.shards, self.dvalues):
            idx = np.arange(tables.nrows, dtype=np.int64) + tables.row_start
            nzmask = dvals != 0
            dr.append(idx[nzmask])
            dv.append(dvals[nzmask])
        rows = np.concatenate([r, c] + dr)
        cols = np.concatenate([c, r] + dr)
        vals = np.concatenate([v, v] + dv)
        order = np.lexsort((cols, rows))
        return rows[order], cols[order], vals[order]


def build_symmetric_csx(nrows: int, ncols: int, rows, cols, vals, *,
                        already_lower: bool = False,
                        config: Optional[Config] = None,
                        device=None) -> SymCsxMatrix:
    """Build a symmetric CSX from COO input (ref symmetric.py:502-577), on
    ``device`` (default ``cuda:0``), in ``spx.rt.nr_threads`` shards
    encoded on a thread pool, with the executor of the mode in use built.
    ``already_lower=True`` when the input carries only the lower triangle
    (MMF symmetric file loaded with ``keep_lower``); otherwise the strict
    upper triangle is dropped after verifying the pattern is symmetric."""
    cfg = config or Config.instance()
    if nrows != ncols:
        seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                 "symmetric matrices must be square")
    dev = resolve_device(device)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = round_values(vals, cfg.value_type)
    if not already_lower:
        # Verify the pattern is symmetric (cheap hash check), then keep L+D.
        k_fwd = np.sort(rows * ncols + cols)
        k_bwd = np.sort(cols * ncols + rows)
        if not np.array_equal(k_fwd, k_bwd):
            seterror(ErrorCode.SPX_ERR_INPUT_MAT,
                     "matrix marked symmetric but pattern is not symmetric")
        keep = rows >= cols
        rows, cols, vals = rows[keep], cols[keep], vals[keep]

    mat = SymCsxMatrix(nrows=int(nrows), ncols=int(ncols),
                       nnz=int(rows.size), device=dev)
    mat.timers.create_timer("preproc", span="spx.tune")
    mat.timers.start_timer("preproc")
    try:
        nparts = max(1, cfg.nr_threads)
        with span("spx.tune.sort"):
            # the reference balances the lower triangle's nonzeros (its
            # (nnz + n) / 2 symmetric load, SparseInternal.hpp:72-95)
            part = split_rows_by_nnz(row_counts_from_coo(rows, nrows),
                                     nparts)
            mat.partition = part
            order = lexsort_rc(rows, cols)
            rows, cols = take1(rows, order), take1(cols, order)
            vals = take1(vals, order)
            bounds = np.searchsorted(rows, part.row_start + [nrows])

        def encode(i):   # PreprocessThreadSym parity (CsxBuild.hpp:290-341)
            with span("spx.tune.encode"):
                lo, hi = bounds[i], bounds[i + 1]
                r0 = part.row_start[i]
                nr = part.row_end[i] - r0
                pr, pc, pv = rows[lo:hi] - r0, cols[lo:hi], vals[lo:hi]
                diag_mask = (pr + r0) == pc
                dvalues = np.zeros(nr, dtype=vals.dtype)
                dvalues[pr[diag_mask]] = pv[diag_mask]
                enc = Encoder(nr, ncols, pr[~diag_mask], pc[~diag_mask],
                              pv[~diag_mask], config=cfg)
                enc.encode()
                return (enc.finalize(row_start=r0), dvalues,
                        int((~diag_mask).sum()), enc.encoding_log)

        for i, (tables, dvalues, lower, log) in enumerate(
                map_shards(encode, nparts)):
            mat.shards.append(tables)
            mat.dvalues.append(dvalues)
            log_info("sym shard %d: rows [%d,%d) lower-nnz=%d "
                     "encodings=%s", i, part.row_start[i], part.row_end[i],
                     lower, ",".join(log) or "none")
        mat._executor()
    finally:
        mat.timers.pause_timer("preproc")
    return mat


__all__ = ["SymCsxMatrix", "SymShard", "SymShardExecutor",
           "build_symmetric_csx", "mirror_full_tables", "shard_plan"]
