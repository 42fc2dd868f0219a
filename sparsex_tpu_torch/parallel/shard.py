"""Multi-device execution on torch.distributed: one rank per shard.

Counterpart of ``sparsex_tpu/parallel/shard.py`` (``ShardedCsx``, the SPMD
executor over a JAX device mesh).  A matrix tuned in N shards
(``spx.rt.nr_threads``) runs on a process group of N ranks, rank i owning
shard i's rows:

- **replicated** x: each rank runs its shard's executor on the whole x;
- **halo** x: each rank holds one chunk of x and receives the ``halo_k``
  chunks on either side that its tables read (``comm.Comm.ring_window``);
  its tables are split at build time into a local set in its own chunk's
  frame, which runs while the exchange is in flight, and a halo set in
  the window's frame (``_split_tables_for_halo``);
- **symmetric** matrices (the lower triangle and the diagonal a shard):
  each rank's per-shard body (``symmetric.SymShardExecutor``) gives its own
  rows and the upper mirror's partials over every row, which a
  reduce-scatter sums onto the owning ranks (``reduce_z``); in halo mode on
  one table set rebased into the window's frame (``_rebase_tables_window``)
  whose z destinations are global.

Every mode ends with an all-gather of the rows, so that ``matvec`` gives
the whole y on every rank, as the reference returns one global array.

The host functions that decide what each rank computes are the
reference's, copied: the column spans, the x-mode and ``halo_k``
resolution, the halo split, the window rebase and the demotion of
vertical / diagonal runs (:func:`plan_layout`).  What differs, by design:

- the reference stacks every shard's tables into uniform arrays with a
  union signature and zero padding (``stack_shards``,
  ``stack_delta_pages``, ``stack_sym_delta_pages``, ``stack_fused_delta``,
  ``stack_scatter_plans``, ``stack_unit_pages``), and gives the DIA
  tables traced offsets, because ``shard_map`` runs one program with one
  shape on every device.  A rank here is a process of its own, so it
  plans its own tables with the one-device planner (``ops/exec.HostPlan``,
  or ``symmetric.shard_plan``) and runs its own executors and CUDA graphs:
  no union signature, no padding units, static DIA offsets.  Each rank's
  rows are the reference's up to the order of the sums;
- a process group and its rank order take the place of the mesh and its
  axis (the reference's ``("dcn", "ici")`` tuple axis is the launcher's
  rank numbering);
- the demotion's gate is the fused-delta size gate alone: the port's
  kernels run in every value type, where the reference also needs its
  Pallas kernels' backend and f32 (``_pallas_stacking_ok``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sparsex_tpu_torch.config import Config
from sparsex_tpu_torch.device import resolve_device
from sparsex_tpu_torch.logger import log_info
from sparsex_tpu_torch.ops.exec import CsxExecutor
from sparsex_tpu_torch.ops.fused import min_fused_nnz
from sparsex_tpu_torch.parallel.comm import Comm, GatherIndex
from sparsex_tpu_torch.preprocess.tables import (BlockTable, CsxTables,
                                                 DeltaTable, DiagTable,
                                                 RunTable)
from sparsex_tpu_torch.preprocess.xform import run_step


def _col_span(t: CsxTables) -> Tuple[int, int]:
    """[lo, hi) range of x indices one shard's tables reference (copied
    from shard.py:216)."""
    lo, hi = t.ncols, 0
    d = t.delta
    if d is not None and d.nnz:
        lo = min(lo, int(d.cols.min()))
        hi = max(hi, int(d.cols.max()) + 1)
    for rt in t.runs:
        if rt.rows.size == 0:
            continue
        sr, sc = run_step(rt.enc)
        reach = sc * rt.delta * (rt.vals.shape[1] - 1)
        c0 = int(rt.cols.min()) + min(0, reach)
        c1 = int(rt.cols.max()) + max(0, reach)
        lo, hi = min(lo, c0), max(hi, c1 + 1)
    for bt in t.blocks:
        if bt.rows.size:
            lo = min(lo, int(bt.cols.min()))
            hi = max(hi, int(bt.cols.max()) + bt.bc)
    for dt in t.dias:
        if not dt.ndiags:
            continue
        if dt.anti:
            # x idx = s - r, r in [0, nrows)
            lo = min(lo, int(dt.offsets.min()) - (t.nrows - 1))
            hi = max(hi, int(dt.offsets.max()) + 1)
        else:
            # x idx = r + o
            lo = min(lo, int(dt.offsets.min()))
            hi = max(hi, int(dt.offsets.max()) + t.nrows)
    lo = max(0, min(lo, t.ncols))
    hi = max(lo, min(hi, t.ncols))
    return lo, hi


def _mk_delta(nrows: int, rows, cols, vals) -> Optional[DeltaTable]:
    """A delta table of the (row, col, val) triples (shard.py:254)."""
    if rows.size == 0:
        return None
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    rowptr = np.searchsorted(rows, np.arange(nrows + 1)).astype(np.int64)
    return DeltaTable(rowptr=rowptr, cols=cols.astype(np.int64),
                      vals=vals, row_ids=rows.astype(np.int64))


def _split_tables_for_halo(t: CsxTables, i: int, k: int, chunk: int):
    """Split one shard's tables into (local, halo) sets, rebased at build
    time (copied from shard.py:264): local = units whose whole x span lies
    in the shard's own chunk, in own-chunk coordinates [0, chunk); halo =
    the rest, in window coordinates [0, (2k+1)*chunk).  DIA diagonals stay
    local — their few out-of-chunk edge elements spill into the halo delta
    table, so the dominant DIA stream is never duplicated."""
    own_lo, own_hi = i * chunk, (i + 1) * chunk
    base_h = (i - k) * chunk
    win = (2 * k + 1) * chunk

    dl_r, dl_c, dl_v = [], [], []   # local delta
    dh_r, dh_c, dh_v = [], [], []   # halo delta (incl. DIA/unit spills)

    d = t.delta
    if d is not None and d.nnz:
        cols = np.asarray(d.cols, dtype=np.int64)
        rows = np.asarray(d.row_ids, dtype=np.int64)
        vals = np.asarray(d.vals)
        m = (cols >= own_lo) & (cols < own_hi)
        dl_r.append(rows[m]); dl_c.append(cols[m] - own_lo)
        dl_v.append(vals[m])
        dh_r.append(rows[~m]); dh_c.append(cols[~m] - base_h)
        dh_v.append(vals[~m])

    runs_l, runs_h = [], []
    for rt in t.runs:
        if rt.rows.size == 0:
            continue
        sr, sc = run_step(rt.enc)
        reach = sc * rt.delta * (rt.vals.shape[1] - 1)
        c0 = rt.cols + min(0, reach)
        c1 = rt.cols + max(0, reach)
        m = (c0 >= own_lo) & (c1 < own_hi)
        for sel, base, out in ((m, own_lo, runs_l), (~m, base_h, runs_h)):
            if sel.any():
                out.append(RunTable(
                    enc=rt.enc, delta=rt.delta, rows=rt.rows[sel],
                    cols=rt.cols[sel] - base, sizes=rt.sizes[sel],
                    vals=rt.vals[sel]))

    blocks_l, blocks_h = [], []
    for bt in t.blocks:
        if bt.rows.size == 0:
            continue
        m = (bt.cols >= own_lo) & (bt.cols + bt.bc - 1 < own_hi)
        for sel, base, out in ((m, own_lo, blocks_l), (~m, base_h, blocks_h)):
            if sel.any():
                out.append(BlockTable(
                    enc=bt.enc, rows=bt.rows[sel], cols=bt.cols[sel] - base,
                    vals=bt.vals[sel]))

    dias_l = []
    for dt in t.dias:
        if not dt.ndiags:
            continue
        vals = dt.vals.copy()
        mask = (dt.mask if dt.mask is not None else vals != 0)
        r = np.arange(t.nrows, dtype=np.int64)
        for j, o in enumerate(np.asarray(dt.offsets, dtype=np.int64)):
            xi = (o - r) if dt.anti else (r + o)
            out = mask[j] & ((xi < own_lo) | (xi >= own_hi))
            if out.any():
                rr = r[out]
                dh_r.append(rr)
                dh_c.append(xi[out] - base_h)
                dh_v.append(vals[j, out].copy())
                vals[j, out] = 0
        offs = np.asarray(dt.offsets, dtype=np.int64) - own_lo
        dias_l.append(DiagTable(anti=dt.anti, offsets=offs, vals=vals,
                                mask=None, nnz_count=dt.nnz_count))

    def cat(parts, dtype=None):
        if not parts:
            return np.zeros(0, dtype=dtype if dtype is not None else np.int64)
        return np.concatenate(parts)

    vdt = (t.delta.vals.dtype if t.delta is not None
           else (t.dias[0].vals.dtype if t.dias else np.float32))
    delta_l = _mk_delta(t.nrows, cat(dl_r), cat(dl_c), cat(dl_v, vdt))
    delta_h = _mk_delta(t.nrows, cat(dh_r), cat(dh_c), cat(dh_v, vdt))

    local = CsxTables(nrows=t.nrows, ncols=chunk, nnz=t.nnz,
                      row_start=t.row_start, delta=delta_l, runs=runs_l,
                      blocks=blocks_l, dias=dias_l,
                      value_type=t.value_type)
    halo = CsxTables(nrows=t.nrows, ncols=win, nnz=0,
                     row_start=t.row_start, delta=delta_h, runs=runs_h,
                     blocks=blocks_h, dias=[], value_type=t.value_type)
    return local, halo


def _rebase_tables_window(t: CsxTables, base_h: int) -> CsxTables:
    """Copy of one symmetric shard's tables with every x-side coordinate
    rebased into the halo window frame (col' = col - base_h; copied from
    shard.py:452): delta/run/block cols shift; DIA offsets shift (diag o =
    col - row_local, anti s = row_local + col — both linear in col).  Row
    coordinates and ``row_start`` stay GLOBAL; the kernels re-add ``z_off
    = base_h`` to every z destination derived from a column."""
    d = t.delta
    if d is not None:
        d = DeltaTable(rowptr=d.rowptr, cols=d.cols - base_h,
                       vals=d.vals, row_ids=d.row_ids)
    runs = [RunTable(enc=rt.enc, delta=rt.delta, rows=rt.rows,
                     cols=rt.cols - base_h, sizes=rt.sizes, vals=rt.vals)
            for rt in t.runs]
    blocks = [BlockTable(enc=bt.enc, rows=bt.rows, cols=bt.cols - base_h,
                         vals=bt.vals) for bt in t.blocks]
    dias = [DiagTable(anti=dt.anti, offsets=dt.offsets - base_h,
                      vals=dt.vals, mask=dt.mask, nnz_count=dt.nnz_count)
            for dt in t.dias]
    return CsxTables(nrows=t.nrows, ncols=t.ncols, nnz=t.nnz,
                     row_start=t.row_start, delta=d, runs=runs,
                     blocks=blocks, dias=dias, value_type=t.value_type)


def _demote_sr_run_tables(shards: List[CsxTables]) -> List[CsxTables]:
    """Vert/diag/anti-diag run units -> delta elements, per shard (copied
    from shard.py:478, the sharded analogue of exec.py's demotion):
    applied only when every real shard's combined delta stream clears the
    fused gate; otherwise the tables are returned unchanged.  (The
    reference also needs its Pallas backend and f32 values; the port's
    kernels run in every type.)"""
    combined, any_sr = [], False
    for t in shards:
        base = t.delta.nnz if t.delta is not None else 0
        ex = 0
        for rt in t.runs:
            if run_step(rt.enc)[0] != 0 and rt.vals.size:
                ex += int(rt.vals.size)
                any_sr = True
        combined.append(base + ex)
    if not any_sr:
        return shards
    gate = min_fused_nnz()
    if any(c and c < gate for c in combined):
        return shards            # a small real shard: keep legacy plans
    out = []
    for t in shards:
        keep, dr, dc, dv = [], [], [], []
        for rt in t.runs:
            sr, sc = run_step(rt.enc)
            if sr == 0 or not rt.vals.size:
                keep.append(rt)
                continue
            W = rt.width
            lane = np.arange(W, dtype=np.int64)
            rr = (np.asarray(rt.rows, np.int64)[:, None]
                  + (sr * rt.delta) * lane[None, :]).reshape(-1)
            cc = (np.asarray(rt.cols, np.int64)[:, None]
                  + (sc * rt.delta) * lane[None, :]).reshape(-1)
            vv = np.asarray(rt.vals).reshape(-1)
            nz = vv != 0
            dr.append(np.clip(rr, 0, t.nrows - 1)[nz])
            dc.append(np.clip(cc, 0, t.ncols - 1)[nz])
            dv.append(vv[nz])
        if not dr:
            out.append(t)
            continue
        d = t.delta
        rows_all = np.concatenate(
            ([np.asarray(d.row_ids, np.int64)] if d is not None else [])
            + dr)
        cols_all = np.concatenate(
            ([np.asarray(d.cols, np.int64)] if d is not None else []) + dc)
        vals_all = np.concatenate(
            ([np.asarray(d.vals)] if d is not None else []) + dv)
        o = np.lexsort((cols_all, rows_all))
        rows_all, cols_all, vals_all = rows_all[o], cols_all[o], vals_all[o]
        rowptr = np.zeros(t.nrows + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows_all, minlength=t.nrows),
                  out=rowptr[1:])
        cdt = d.cols.dtype if d is not None else np.int32
        rdt = d.row_ids.dtype if d is not None else np.int32
        out.append(replace(
            t, runs=keep,
            delta=DeltaTable(rowptr=rowptr,
                             cols=cols_all.astype(cdt),
                             vals=vals_all,
                             row_ids=rows_all.astype(rdt))))
    return out


@dataclass
class RankSet:
    """What one rank computes: ``tables`` (replicated x: its shard after
    the demotion; symmetric halo: those rebased into the window's frame,
    with ``gather_off`` its first row in that frame and ``z_base`` the
    window's first global column), or ``local`` and ``halo`` (halo x)."""

    tables: Optional[CsxTables] = None
    local: Optional[CsxTables] = None
    halo: Optional[CsxTables] = None
    gather_off: Optional[int] = None
    z_base: int = 0


@dataclass
class Layout:
    """The resolved multi-device layout (``ShardedCsx.__init__``,
    shard.py:1215-1300): the x mode, the halo width ``halo_k`` in chunks
    of ``chunk`` columns, each rank's rows and the table sets of the ranks
    asked for."""

    x_mode: str
    halo_k: int
    chunk: int
    row_start: Tuple[int, ...]
    nrows_loc: Tuple[int, ...]
    sets: Dict[int, RankSet] = field(default_factory=dict)

    @property
    def win(self) -> int:
        """The halo window's columns."""
        return (2 * self.halo_k + 1) * self.chunk


def plan_layout(mat, n_ranks: int,
                ranks: Optional[Sequence[int]] = None) -> Layout:
    """The layout of ``mat`` (its ``shards``, ``nrows``, ``ncols`` and
    ``symmetric``) on ``n_ranks`` ranks, with the table sets of ``ranks``
    (default all): the reference's resolution, copied.  The x mode is
    ``spx.tpu.x_mode``; ``auto`` is halo when ``2 k + 1 < n_ranks``, ``k`` the most chunks any shard's column span (a symmetric
    shard's also its own rows) reaches past its own.  Raises
    ``ValueError`` when the shard count is not ``n_ranks``."""
    if len(mat.shards) != n_ranks:
        raise ValueError(
            f"matrix has {len(mat.shards)} shards but the group has "
            f"{n_ranks} ranks; tune with spx.rt.nr_threads={n_ranks}")
    symmetric = mat.symmetric
    # vert/diag/anti-diag tables demote to delta elements up front
    # (no-op below the fused gate); every mode below sees the result
    shards = _demote_sr_run_tables(mat.shards)
    chunk = -(-mat.ncols // n_ranks)
    k = 0
    for i, (lo, hi) in enumerate(_col_span(t) for t in shards):
        if hi > lo:
            k = max(k, i - lo // chunk, (hi - 1) // chunk - i)
    if symmetric:
        # the window must also cover each shard's OWN row range (the
        # transposed contribution gathers x at global rows; row
        # partitions need not align with column chunks)
        for i, t in enumerate(shards):
            r1 = t.row_start + max(t.nrows, 1)
            k = max(k, i - t.row_start // chunk, (r1 - 1) // chunk - i)
    mode = Config.instance().x_mode
    if mode == "auto":
        mode = "halo" if 2 * k + 1 < n_ranks else "replicated"
    layout = Layout(mode, k, chunk,
                    tuple(int(t.row_start) for t in shards),
                    tuple(int(t.nrows) for t in shards))
    vtype = _value_type(shards)
    for i in (range(n_ranks) if ranks is None else ranks):
        t = replace(shards[i], value_type=vtype)
        if mode == "halo" and symmetric:
            base_h = (i - k) * chunk
            layout.sets[i] = RankSet(
                tables=_rebase_tables_window(t, base_h),
                gather_off=t.row_start - base_h, z_base=base_h)
        elif mode == "halo":
            local, halo = _split_tables_for_halo(t, i, k, chunk)
            layout.sets[i] = RankSet(local=local, halo=halo)
        else:
            layout.sets[i] = RankSet(tables=t)
    return layout


def _value_type(shards: List[CsxTables]) -> str:
    """The matrix's value type: a shard's ``value_type`` (bf16), else the
    dtype of the first values any shard holds.  Each rank's tables carry
    it, so that every rank computes in it: the one-device planner reads
    the type off a table's delta and takes float64 where there is none
    (exec.py:218), and a rank's set may have none where its shard has."""
    for t in shards:
        if t.value_type:
            return t.value_type
    for t in shards:
        for src in ([t.delta] if t.delta is not None else []) + list(
                t.dias) + list(t.runs) + list(t.blocks):
            return np.dtype(src.vals.dtype).name
    return "float64"


def compact_halo(t: CsxTables):
    """``(rows, tables)``: a halo set (no DIA tables) as one delta table of
    its elements over the rows they touch, renumbered in order, or
    ``(None, None)`` for an empty set.  The halo set holds what spills
    over the chunk's edges, so its rows are few and clustered in the
    shard's; planned over all of them, its page layout and scatter route
    would be sized by the shard's rows, several times what the set's own
    rows need (HPCG's stencil).  The rank adds the set's results at
    ``rows``."""
    r, c, v = [], [], []
    d = t.delta
    if d is not None and d.nnz:
        r.append(np.asarray(d.row_ids, np.int64))
        c.append(np.asarray(d.cols, np.int64))
        v.append(np.asarray(d.vals))
    for rt in t.runs:
        sr, sc = run_step(rt.enc)
        lane = np.arange(rt.width, dtype=np.int64)
        r.append((np.asarray(rt.rows, np.int64)[:, None]
                  + sr * rt.delta * lane).reshape(-1))
        c.append((np.asarray(rt.cols, np.int64)[:, None]
                  + sc * rt.delta * lane).reshape(-1))
        v.append(np.asarray(rt.vals).reshape(-1))
    for bt in t.blocks:
        i, j = np.meshgrid(np.arange(bt.br), np.arange(bt.bc), indexing="ij")
        r.append((np.asarray(bt.rows, np.int64)[:, None, None]
                  + i).reshape(-1))
        c.append((np.asarray(bt.cols, np.int64)[:, None, None]
                  + j).reshape(-1))
        v.append(np.asarray(bt.vals).reshape(-1))
    if not r:
        return None, None
    rows, cols, vals = (np.concatenate(a) for a in (r, c, v))
    nz = vals != 0              # the units' padding lanes
    rows, cols, vals = rows[nz], cols[nz], vals[nz]
    if not rows.size:
        return None, None
    uniq = np.unique(rows)
    delta = _mk_delta(uniq.size, np.searchsorted(uniq, rows), cols, vals)
    return uniq, CsxTables(nrows=int(uniq.size), ncols=t.ncols,
                           nnz=int(rows.size), row_start=t.row_start,
                           delta=delta, value_type=t.value_type)


def host_side(csx) -> dict:
    """A tuned matrix's host side, the part :class:`ShardedCsx` reads:
    its sizes, shards and, for a symmetric matrix, its diagonal values (a
    pickle of it hands a matrix to spawned ranks)."""
    return {"nrows": csx.nrows, "ncols": csx.ncols, "nnz": csx.nnz,
            "shards": list(csx.shards), "symmetric": bool(csx.symmetric),
            "dvalues": getattr(csx, "dvalues", None)}


def host_from_coo(nrows: int, ncols: int, rows, cols, vals, cfg,
                  nparts: int) -> dict:
    """:func:`host_side` of the matrix ``CsxMatrix.from_coo`` would tune
    in ``nparts`` shards under ``cfg``: partitioned, mined and encoded on
    the host, with no plan and no executor."""
    from sparsex_tpu_torch.csx import map_shards, shard_encoder
    _part, encode = shard_encoder(nrows, ncols, rows, cols, vals, cfg,
                                  nparts)
    return {"nrows": int(nrows), "ncols": int(ncols),
            "nnz": int(np.size(rows)),
            "shards": [t for t, _log in map_shards(encode, nparts)],
            "symmetric": False, "dvalues": None}


def host_matrix(host: dict):
    """A matrix of :func:`host_side`'s shards that holds no executor."""
    from sparsex_tpu_torch.csx import CsxMatrix
    from sparsex_tpu_torch.symmetric import SymCsxMatrix
    kw = dict(nrows=host["nrows"], ncols=host["ncols"], nnz=host["nnz"],
              device=torch.device("cpu"), shards=list(host["shards"]))
    if host["symmetric"]:
        return SymCsxMatrix(dvalues=list(host["dvalues"]), **kw)
    return CsxMatrix(**kw)


def rank_device(rank: int) -> torch.device:
    """A rank's default device: ``cuda:{LOCAL_RANK or rank}`` modulo the
    GPUs this process sees (raises without CUDA, as ``resolve_device``
    does)."""
    if not torch.cuda.is_available():
        return resolve_device(None)
    local = os.environ.get("LOCAL_RANK")
    idx = int(local) if local is not None else rank
    return torch.device("cuda", idx % torch.cuda.device_count())


class ShardedCsx:
    """SpMV and SpMM of a matrix of N shards on a process group of N ranks
    (the reference's ``ShardedCsx``, shard.py:1165).

    ``mat`` is a tuned matrix's host side: its ``shards`` (and a symmetric
    matrix's ``dvalues``) are read, never its executors, so a matrix tuned
    or restored with ``device="cpu"``, or built from ``csx.encode_coo``'s
    tables, serves, and each rank holds only its own shard on its device.
    ``group`` defaults to the WORLD group, whose rank order is the ring's;
    ``device`` to :func:`rank_device` (never the CPU unless named).  Every
    rank of the group must construct it and make every call, with the same
    arguments.  x placement is ``spx.tpu.x_mode`` (:func:`plan_layout`).

    ``executors`` are this rank's executors: its shard's, the local and
    halo sets' (halo x: the halo set over the rows it touches, added at
    ``halo_rows``, :func:`compact_halo`; none where the set is empty), or
    its symmetric shard's; ``comm`` its collectives.  On the
    card each executor replays its own CUDA graphs; the collectives run
    between them and are not captured, so a solver runs this matrix with
    ``graph=False``."""

    def __init__(self, mat, group=None, device=None):
        self.group = dist.group.WORLD if group is None else group
        n = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.device = (rank_device(self.rank) if device is None
                       else resolve_device(device))
        self.layout = lay = plan_layout(mat, n, ranks=(self.rank,))
        self.x_mode, self.halo_k, self.chunk = (lay.x_mode, lay.halo_k,
                                                lay.chunk)
        self.symmetric = mat.symmetric
        self.nrows, self.ncols = int(mat.nrows), int(mat.ncols)
        self.comm = Comm(self.group, self.device)
        self.gather_idx = GatherIndex(lay.row_start, lay.nrows_loc,
                                      self.device)
        s = lay.sets[self.rank]
        dev = self.device
        if self.symmetric:
            from sparsex_tpu_torch.symmetric import SymShardExecutor, \
                shard_plan
            dv = mat.dvalues[self.rank]
            if lay.x_mode == "halo":
                frame = dict(ncols=lay.win, gather_off=s.gather_off,
                             z_off=s.z_base)
            else:
                frame = dict(ncols=self.ncols)
            meta, host = shard_plan(s.tables, self.nrows, **frame)
            self.executors = [SymShardExecutor.from_plan(
                s.tables, meta, host, dv, self.nrows, dev, **frame)]
        elif lay.x_mode == "halo":
            self.executors = [CsxExecutor.from_tables(s.local, dev)]
            rows, halo = compact_halo(s.halo)
            if halo is not None:
                self.halo_rows = torch.from_numpy(rows).to(dev)
                self.executors.append(CsxExecutor.from_tables(halo, dev))
        else:
            self.executors = [CsxExecutor.from_tables(s.tables, dev)]
        self.dtype = self.executors[0].dtype
        r0 = lay.row_start[self.rank]
        log_info("rank %d -> %s (rows [%d,%d), x_mode=%s, halo_k=%d)",
                 self.rank, dev, r0, r0 + lay.nrows_loc[self.rank],
                 lay.x_mode, lay.halo_k)

    # ------------------------------------------------------------------
    def _vector(self, v, name: str, shape) -> torch.Tensor:
        """``v`` on this rank's device in the plan's compute dtype."""
        if isinstance(v, torch.Tensor):
            if v.device != self.device:
                raise ValueError(f"{name} is on {v.device}; this rank's "
                                 f"matrix is on {self.device}")
            t = v.to(self.dtype)
        else:
            t = torch.as_tensor(np.asarray(v), dtype=self.dtype,
                                device=self.device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        return t.contiguous()

    def x_chunk(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of x (rows on the first axis), zero past x's
        end (the reference pads x to N chunks, shard.py:1425)."""
        lo = self.rank * self.chunk
        own = x[lo:lo + self.chunk]
        if own.shape[0] < self.chunk:
            own = torch.cat([own, own.new_zeros(
                (self.chunk - own.shape[0],) + own.shape[1:])])
        return own.contiguous()

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``A @ x`` (x: the whole (ncols[, k]))."""
        ex = self.executors
        lay = self.layout
        if lay.x_mode == "halo":
            xloc = self.x_chunk(x)
            pending = self.comm.ring_window(xloc, lay.halo_k)
            if self.symmetric:
                z = ex[0](pending.wait())
                return self.comm.reduce_scatter_rows(z, lay.row_start,
                                                     lay.nrows_loc)
            acc = ex[0](xloc)        # the local set, while the ring runs
            xwin = pending.wait()
            if len(ex) > 1:
                acc.index_add_(0, self.halo_rows, ex[1](xwin))
            return acc
        if self.symmetric:
            return self.comm.reduce_scatter_rows(ex[0](x), lay.row_start,
                                                 lay.nrows_loc)
        return ex[0](x)

    def _apply(self, x, alpha, beta, y, name):
        low = isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
        shape = (self.ncols,) + tuple(np.shape(x)[1:])
        x = self._vector(x, name, shape)
        out = self.comm.all_gather_rows(self.own_rows(x), self.gather_idx)
        if not (isinstance(alpha, (int, float)) and float(alpha) == 1.0):
            out = out * alpha
        if y is not None and not (isinstance(beta, (int, float))
                                  and float(beta) == 0.0):
            out = out + beta * self._vector(
                y, "y", (self.nrows,) + tuple(shape[1:]))
        return out.to(torch.bfloat16) if low else out

    def matvec(self, x, alpha=1.0, beta=0.0, y=None) -> torch.Tensor:
        """``alpha * A @ x + beta * y``, the whole (nrows,) vector on every
        rank (shard.py:1448); x is the whole (ncols,) vector."""
        if np.ndim(x) != 1:
            raise ValueError(f"x must be ({self.ncols},), got "
                             f"{tuple(np.shape(x))}")
        return self._apply(x, alpha, beta, y, "x")

    def matmat(self, X, alpha=1.0, beta=0.0, Y=None) -> torch.Tensor:
        """The SpMM ``alpha * A @ X + beta * Y`` for X (ncols, k), the
        whole (nrows, k) on every rank: each rank's executors run their
        SpMM (k-batched on a fused plan), the exchanges carry (rows, k)
        blocks (the reference maps the sharded SpMV over the columns,
        shard.py:1457)."""
        if np.ndim(X) != 2 or np.shape(X)[0] != self.ncols:
            raise ValueError(f"X must be ({self.ncols}, k), got "
                             f"{tuple(np.shape(X))}")
        return self._apply(X, alpha, beta, Y, "X")


__all__ = ["Layout", "RankSet", "ShardedCsx", "compact_halo", "host_matrix",
           "host_side", "plan_layout", "rank_device"]
