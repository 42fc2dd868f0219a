"""Host planning and device execution of one encoded partition on PyTorch.

Counterpart of ``CsxExecutor`` (``sparsex_tpu/ops/exec.py:204``), in two
parts:

- :class:`HostPlan`, the reference executor's host half, copied
  (``__init__``'s tables and plain meta, ``_maybe_build_pages``,
  ``_build_fblk``, ``_merge_fused_segments``, exec.py:214-808): it plans
  the paged variant with the port's own planners (NumPy and C++), so its
  ``meta`` / ``arrays`` and ``_pages_meta`` / ``_pages_arrays`` equal the
  reference executor's array for array, with one repair: a fused run table
  whose route instances overlap outside the merged plan is re-planned
  without its fused run (the reference's K1 would route all but one fold
  through the wrong lanes).  Its comments cite the reference's TPU
  measurements (the planners' origins); none is a number of the port;
- :class:`CsxExecutor`, the device half: :meth:`CsxExecutor.from_tables`
  plans on the host and uploads the resulting plan once through
  :func:`~sparsex_tpu_torch.ops.convert.plan_to_torch`.  On the card
  each call replays a CUDA graph of the executor's own (one for the SpMV,
  one per SpMM width k), the counterpart of the reference's compiled-call
  cache (``_compiled`` / ``_compiled_mm``, exec.py:31-130): one launch a
  call where the eager path dispatches every kernel and torch op from
  Python.  On the CPU the path runs eagerly.

A bf16 matrix computes in float32, as the reference's paged variant does
(exec.py:267-270, :861-867): its tables hold bf16-rounded values in
float32 arrays, every kernel runs in f32, a bf16 x (or y) is upcast and
the result cast back to bf16.  The plain-table variant computes in f32 as
well (the reference's runs in bf16 through XLA).

The variant gate (the counterpart of ``_pages_active``, exec.py:827-849,
and of the pick in ``__call__``, :889-892) is simpler on the card: the
paged variant runs whenever the planner made one, the plain-table variant
otherwise, in float32 and float64 alike.  The reference's float32-only gate
(``pallas_dtype_ok``: Mosaic tiles are f32) and its DIA policy
(``_resolve_use_pallas``, :171-201, whose constants are TPU measurements)
are not carried over: on the card the DIA kernel always runs, at any
number of diagonals.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict

import numpy as np
import torch

from sparsex_tpu_torch.device import graph_node_types
from sparsex_tpu_torch.logger import log_warning
from sparsex_tpu_torch.ops.convert import plan_to_torch
from sparsex_tpu_torch.ops.fused import MAX_KB as MM_FUSED_KB
from sparsex_tpu_torch.ops.fused import (build_fused_delta, build_fused_run,
                                         merge_segment_plan, min_fused_nnz,
                                         pad_dias_for_k3,
                                         plan_partial_segment)
from sparsex_tpu_torch.ops.kernels import (check_slice, fused_mm_contrib,
                                           fused_mm_ok, local_contrib,
                                           static_meta, tables_to_arrays,
                                           unmerged_overlapping_runs)
from sparsex_tpu_torch.ops.pallas_kernels import (build_delta_pages,
                                                  build_unit_pages)
from sparsex_tpu_torch.ops.route import build_scatter_plan, fold_sort_key
from sparsex_tpu_torch.preprocess.encodings import EncType
from sparsex_tpu_torch.preprocess.tables import CsxTables
from sparsex_tpu_torch.preprocess.xform import run_step
from sparsex_tpu_torch.timing import count_max, span

# the compute dtype of each value type: bf16 matrices compute in f32
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.float32}
MM_GRAPHS = 4   # SpMM graphs an executor keeps (least recently used out)


class HostPlan:
    """The host half of the reference executor: one partition's plain
    tables (``meta``, ``arrays``) and, after :meth:`_maybe_build_pages`,
    its paged plan (``_pages_meta``, ``_pages_arrays``; both None when the
    planner made none)."""

    def __init__(self, tables: CsxTables):
        self.tables = tables
        self.meta = static_meta(tables)
        self.arrays = tables_to_arrays(tables)
        # (the reference's CsxTables, which tests plan here, has no
        # value_type: its bf16 arrays name their own dtype)
        self._dtype = getattr(tables, "value_type", None) or str(
            np.dtype(tables.delta.vals.dtype) if tables.delta is not None
            else "float64")
        self._pages_tried = False
        self._pages_meta = None
        self._pages_arrays = None

    def _maybe_build_pages(self) -> None:
        """Lazily reorganize tables into page-bucketed Pallas layouts
        (host-side sorting; done once per executor): the delta table gets
        the element-page layout, run/block tables get unit-page gather
        plans.  ``build_delta_pages``/``build_unit_pages`` decide
        applicability per table."""
        if self._pages_tried:
            return
        self._pages_tried = True
        ncols = self.tables.ncols
        arrays = dict(self.arrays)
        changed = False
        if self._dtype == "bfloat16":
            # compute-in-f32: a bf16 matrix's page/route variant holds f32
            # copies of every value stream (the reference keeps its bf16
            # tables for the fallback path; the port's host tables are
            # already f32, so these are copies of the same values).
            def _f32(tree):
                if tree is None:
                    return None
                out = dict(tree)
                if "vals" in out:
                    out["vals"] = np.asarray(out["vals"], dtype=np.float32)
                return out
            arrays["delta"] = _f32(arrays["delta"])
            arrays["runs"] = [_f32(t) for t in arrays["runs"]]
            arrays["blocks"] = [_f32(t) for t in arrays["blocks"]]
            arrays["dias"] = [_f32(t) for t in arrays["dias"]]
            changed = True

        # --- delta + DIA planning runs AFTER the unit tables (below) so
        # unpageable unit-table tails can DEMOTE into the delta table:
        # bulk lane-placed/paged slots cost ~1 us per 1024 elements where
        # the serialized XLA tail gather costs ~6.6 ns PER ELEMENT ---
        dmeta_entry = None
        dscatter_entry = None
        dfused_entry = None
        d = self.tables.delta
        demoted = []   # (rows, cols, vals) element triples from tails

        def _scatter_entry(entry_arrays, dest_flat):
            """Route plan for a unit table's y scatter, in the shared-K3
            segment form (``ops/fused.plan_partial_segment``); returns
            the static meta entry (or None), storing arrays in place."""
            seg = plan_partial_segment(dest_flat, self.tables.nrows)
            if seg is None:
                return None
            inst_meta, seg_arrays, has_res, M_pad = seg
            entry_arrays["fscatter"] = seg_arrays
            return ("fs", inst_meta, has_res, M_pad)

        def _run_entry(enc_i, delta, width, t):
            """A run table planned without a fused run pipeline: its
            unit-page gather plan (x-reading types only) and y-side
            route; returns (meta entry, arrays, whether either was
            planned)."""
            sr, sc = run_step(EncType(enc_i))
            planned = False
            plan_entry, entry_arrays = None, t
            if sc != 0 and width >= 2:
                lane = np.arange(width, dtype=np.int64)
                gidx = (t["cols"][:, None].astype(np.int64)
                        + (sc * delta) * lane[None, :])
                flat = np.clip(gidx, 0, ncols - 1).reshape(-1)
                order, n_pageable, plan = build_unit_pages(flat, width,
                                                           ncols)
                if plan is not None:
                    entry_arrays = {
                        "rows": t["rows"][order], "cols": t["cols"][order],
                        "vals": t["vals"][order],
                        "plan": {k: plan[k] for k in ("plo", "sl")},
                    }
                    plan_entry = (plan["T"], plan["q"], plan["g"],
                                  plan["npages"])
                    planned = True
            rows64 = np.asarray(entry_arrays["rows"], dtype=np.int64)
            if sr == 0:
                dest = rows64  # one partial per unit
            else:
                lane = np.arange(width, dtype=np.int64)
                dest = np.clip(rows64[:, None] + (sr * delta) * lane[None],
                               0, self.tables.nrows - 1).reshape(-1)
            if entry_arrays is t:
                entry_arrays = dict(t)
            scat_entry = _scatter_entry(entry_arrays, dest)
            if scat_entry is not None:
                planned = True
            return ((enc_i, delta, width, plan_entry, scat_entry),
                    entry_arrays, planned)

        # --- run tables: unit-page gather plans (x-reading types only)
        #     + y-side scatter routes ---
        # vert/diag/anti-diag units write W INDEPENDENT dest rows — they
        # are exactly W delta elements, and the fused delta pipeline
        # (one lane-placed K1 slot per element, shared K2/K3, single y
        # write) beats the legacy unit-paged + partial-segment chain.
        # Demote those tables wholesale when the combined delta stream
        # clears the fused gate (below it they keep the legacy plans).
        base_delta = int(d.nnz) if (d is not None and d.nnz) else 0
        sr_elems = sum(
            int(np.asarray(t["rows"]).size) * w_
            for (e_, d_, w_), t in zip(self.meta[2], arrays["runs"])
            if run_step(EncType(e_))[0] != 0)
        demote_sr = (sr_elems
                     and base_delta + sr_elems >= min_fused_nnz())

        run_meta = []
        run_arrays = []
        # run_meta index of each fused run pipeline -> its paged units as a
        # run table (enc, delta, width, arrays), for the re-plan below
        frun_units = {}
        for (enc_i, delta, width), t in zip(self.meta[2], arrays["runs"]):
            sr, sc = run_step(EncType(enc_i))
            if sr != 0 and demote_sr:
                lane = np.arange(width, dtype=np.int64)
                trows = (np.asarray(t["rows"], dtype=np.int64)[:, None]
                         + (sr * delta) * lane[None, :]).reshape(-1)
                tcols = (np.asarray(t["cols"], dtype=np.int64)[:, None]
                         + (sc * delta) * lane[None, :]).reshape(-1)
                tvals = np.asarray(t["vals"]).reshape(-1)
                nz = tvals != 0
                demoted.append(
                    (np.clip(trows, 0, self.tables.nrows - 1)[nz],
                     np.clip(tcols, 0, ncols - 1)[nz], tvals[nz]))
                run_meta.append((enc_i, delta, width, None, None,
                                 ("cvt",)))
                run_arrays.append({})
                changed = True
                continue
            # horizontal runs whose width divides 128: the fully fused
            # kernel (gather + FMA + sliding-sum + G1 -> shared K3)
            if sr == 0 and width >= 2 and 128 % width == 0:
                cols_u = np.asarray(t["cols"], dtype=np.int64)
                rows_u = np.asarray(t["rows"], dtype=np.int64)
                fmeta_r, farr_r, order_r, n_page_r = build_fused_run(
                    cols_u, rows_u, np.asarray(t["vals"]), ncols,
                    self.tables.nrows, width, step=sc * delta)
                if fmeta_r is not None:
                    tail = order_r[n_page_r:]
                    head = order_r[:n_page_r]
                    frun_units[len(run_meta)] = (
                        enc_i, delta, width,
                        {k: np.asarray(t[k])[head]
                         for k in ("rows", "cols", "vals")})
                    run_meta.append((enc_i, delta, width, None, None,
                                     ("frun", fmeta_r, 0)))
                    run_arrays.append({"frun": farr_r})
                    if tail.size:
                        lane = np.arange(width, dtype=np.int64)
                        tcols = (cols_u[tail][:, None]
                                 + (sc * delta) * lane[None, :]).reshape(-1)
                        tvals = np.asarray(t["vals"])[tail].reshape(-1)
                        nz = tvals != 0
                        demoted.append((np.repeat(rows_u[tail], width)[nz],
                                        np.clip(tcols, 0, ncols - 1)[nz],
                                        tvals[nz]))
                    changed = True
                    continue
            entry, entry_arrays, planned = _run_entry(enc_i, delta, width,
                                                      t)
            changed = changed or planned
            run_meta.append(entry)
            run_arrays.append(entry_arrays)

        # --- block tables: unit-page gather plans + y-side routes ---
        block_meta = []
        block_arrays = []
        for (enc_i, br, bc), t in zip(self.meta[3], arrays["blocks"]):
            plan_entry, entry_arrays = None, t
            # a (br, bc) block is br width-bc step-1 runs: ride the fused
            # run pipeline (lane-placed K1 + shared merged route) as a
            # PSEUDO run table — the whole legacy fblk chain (paged
            # gather + XLA FMA/roll + per-row segments, ~52us on the
            # blocky bench) collapses into the rlp kernel
            if bc >= 2 and 128 % bc == 0:
                U = int(np.asarray(t["rows"]).size)
                cols_b = np.tile(np.asarray(t["cols"], dtype=np.int64), br)
                rows_b = (np.asarray(t["rows"], dtype=np.int64)[None, :]
                          + np.arange(br, dtype=np.int64)[:, None]
                          ).reshape(-1)
                vals_b = np.ascontiguousarray(
                    np.asarray(t["vals"]).transpose(1, 0, 2)).reshape(
                    br * U, bc)
                fmeta_b, farr_b, order_b, n_page_b = build_fused_run(
                    cols_b, rows_b, vals_b, ncols, self.tables.nrows, bc)
                if fmeta_b is not None:
                    tail = order_b[n_page_b:]
                    head = order_b[:n_page_b]
                    frun_units[len(run_meta)] = (
                        int(EncType.HORIZONTAL), 1, bc,
                        {"rows": rows_b[head], "cols": cols_b[head],
                         "vals": vals_b[head]})
                    run_meta.append(
                        (int(EncType.HORIZONTAL), 1, bc, None, None,
                         ("frun", fmeta_b, 0)))
                    run_arrays.append({"frun": farr_b})
                    if tail.size:
                        tcols = (cols_b[tail][:, None]
                                 + np.arange(bc, dtype=np.int64)[None, :]
                                 ).reshape(-1)
                        tvals = vals_b[tail].reshape(-1)
                        nz = tvals != 0
                        demoted.append((np.repeat(rows_b[tail], bc)[nz],
                                        np.clip(tcols, 0, ncols - 1)[nz],
                                        tvals[nz]))
                    block_meta.append((enc_i, br, bc, None, None,
                                       ("cvt",)))
                    block_arrays.append({})
                    changed = True
                    continue
            if bc >= 2:
                gidx = (t["cols"][:, None].astype(np.int64)
                        + np.arange(bc, dtype=np.int64)[None, :])
                flat = np.clip(gidx, 0, ncols - 1).reshape(-1)
                order, n_pageable, plan = build_unit_pages(flat, bc, ncols)
                if plan is not None and 128 % bc == 0:
                    # fully fused blocks: the gathered grid stays in
                    # (T, 8, 128) form; each block row r becomes a routed
                    # segment (XLA lane-roll sliding sums -> shared K3);
                    # no thin (U, bc) reshape, no batched einsum
                    fblk = self._build_fblk(t, order, plan, br, bc, ncols)
                    if fblk is not None:
                        entry_arrays, seg_metas, n_tail = fblk
                        tail = entry_arrays.pop("_tail")
                        if tail.size:
                            tr = np.asarray(t["rows"], np.int64)[tail]
                            tc = np.asarray(t["cols"], np.int64)[tail]
                            tv = np.asarray(t["vals"])[tail]  # (U,br,bc)
                            rr = (tr[:, None, None]
                                  + np.arange(br, dtype=np.int64)[None, :,
                                                                  None])
                            cc2 = (tc[:, None, None]
                                   + np.arange(bc, dtype=np.int64)[None,
                                                                   None])
                            rr = np.broadcast_to(rr, tv.shape).reshape(-1)
                            cc2 = np.broadcast_to(cc2,
                                                  tv.shape).reshape(-1)
                            tvf = tv.reshape(-1)
                            nz = tvf != 0
                            demoted.append(
                                (np.clip(rr, 0,
                                         self.tables.nrows - 1)[nz],
                                 np.clip(cc2, 0, ncols - 1)[nz],
                                 tvf[nz]))
                        plan_entry = (plan["T"], plan["q"], plan["g"],
                                      plan["npages"])
                        block_meta.append((enc_i, br, bc, plan_entry,
                                           None, ("fblk", seg_metas,
                                                  n_tail)))
                        block_arrays.append(entry_arrays)
                        changed = True
                        continue
                if plan is not None:
                    entry_arrays = {
                        "rows": t["rows"][order], "cols": t["cols"][order],
                        "vals": t["vals"][order],
                        "plan": {k: plan[k] for k in ("plo", "sl")},
                    }
                    plan_entry = (plan["T"], plan["q"], plan["g"],
                                  plan["npages"])
                    changed = True
            rows64 = np.asarray(entry_arrays["rows"], dtype=np.int64)
            dest = np.clip(rows64[:, None] + np.arange(br, dtype=np.int64),
                           0, self.tables.nrows - 1).reshape(-1)
            if entry_arrays is t:
                entry_arrays = dict(t)
            scat_entry = _scatter_entry(entry_arrays, dest)
            if scat_entry is not None:
                changed = True
            block_meta.append((enc_i, br, bc, plan_entry, scat_entry))
            block_arrays.append(entry_arrays)

        # --- delta + DIA: the fused 3-kernel pipeline (ops/fused.py),
        # over the matrix's delta singles PLUS every demoted unit-table
        # tail element ---
        vdt = (np.dtype(np.float32) if self._dtype == "bfloat16"
               else np.dtype(self._dtype))
        if d is not None and d.nnz:
            dvals = np.asarray(d.vals).astype(vdt, copy=False)
            cols64 = np.asarray(d.cols, dtype=np.int64)
            rows64 = np.asarray(d.row_ids, dtype=np.int64)
        else:
            dvals = np.zeros(0, dtype=vdt)
            cols64 = np.zeros(0, dtype=np.int64)
            rows64 = np.zeros(0, dtype=np.int64)
        if demoted:
            rows64 = np.concatenate(
                [rows64] + [r.astype(np.int64) for r, _, _ in demoted])
            cols64 = np.concatenate(
                [cols64] + [c.astype(np.int64) for _, c, _ in demoted])
            dvals = np.concatenate(
                [dvals] + [v.astype(vdt, copy=False) for _, _, v in demoted])
            # the demoted elements must reach SOME delta path even when
            # no paged/fused layout applies below
            arrays["delta"] = {"row_ids": rows64, "cols": cols64,
                               "vals": dvals}
            changed = True
        if dvals.size:
            fmeta, farrs = build_fused_delta(cols64, rows64, dvals,
                                             ncols, self.tables.nrows)
            if fmeta is not None:
                arrays["fused"] = farrs
                arrays["delta"] = None  # leftover lives inside farrs
                dfused_entry = ("dfused", fmeta)
                changed = True
        if dvals.size and dfused_entry is None:
            rep, leftover = build_delta_pages(
                cols64, rows64, dvals, ncols, self.tables.nrows,
                sort_key=fold_sort_key(rows64, self.tables.nrows, cols64))
            if rep is not None:
                q, npages = rep.pop("q"), rep.pop("npages")
                T = rep["plo"].size
                arrays["delta_pages"] = rep
                if leftover.size:
                    lo = np.sort(leftover)
                    arrays["delta"] = {
                        "row_ids": rows64[lo], "cols": cols64[lo],
                        "vals": dvals[lo]}
                else:
                    arrays["delta"] = None
                dmeta_entry = ("dpages", T, q, npages)
                changed = True
                # y side: route products through the static scatter network
                # instead of the serialized XLA scatter (ops/route.py).
                plan = build_scatter_plan(
                    np.asarray(rep["rows"], dtype=np.int64),
                    self.tables.nrows)
                if plan is not None:
                    dmetas, darrs, res_pos, res_dest = plan
                    rep.pop("rows")  # never read on the routed path
                    arrays["delta_scatter"] = {
                        "chunks": darrs, "res_pos": res_pos,
                        "res_dest": res_dest}
                    dscatter_entry = ("dscatter", dmetas,
                                      bool(res_pos.size))

        if not changed:
            return
        # --- merged route plan: ONE K2/K3 instance set over the
        # concatenation of every fused segment's source grid.  K2's cost
        # is ~fixed per instance (colors x W2 transposes, ~60us measured
        # r3), so per-segment instances multiply it; the merged plan
        # collapses them (the single biggest structured-matrix lever).
        fall_entry = None
        try:
            fall_entry = self._merge_fused_segments(
                arrays, dfused_entry, run_meta, run_arrays,
                block_meta, block_arrays)
        except Exception:  # pragma: no cover - merge must never break
            import traceback
            log_warning("merged fused plan failed; keeping per-segment "
                        "plans:\n%s", traceback.format_exc())
        # a fused run whose route instances overlap in source rows (the
        # multi-fold fallback of build_fused_run) runs right only inside
        # the merged plan, whose lane gathers apply one G1 per instance;
        # K1's single G1 would keep one fold's wires.  The port re-plans
        # such a run outside the merged plan as its paged units with their
        # own route, the way a table without a fused run is planned (its
        # unpageable tail stays demoted in the delta).  The reference keeps
        # it, and gives a wrong y wherever its paged variant runs.
        for ri in unmerged_overlapping_runs((None, None, run_meta, (), (),
                                             fall_entry)):
            log_warning("fused run table %d: route instances overlap "
                        "outside a merged plan; re-planned without its "
                        "fused run", ri)
            run_meta[ri], run_arrays[ri], _ = _run_entry(*frun_units[ri])
        # pop host-only stashes regardless of merge outcome
        if "fused" in arrays:
            for k in ("_dest", "_tile_group", "_cols_at_pos",
                      "_vals_flat"):
                arrays["fused"].pop(k, None)
        for a in run_arrays:
            if "frun" in a:
                for k in ("_dest", "_punit", "_cols_u_o", "_vals2d_o"):
                    a["frun"].pop(k, None)
        for a in block_arrays:
            a.pop("_dest_r", None)

        # DIA tables ride the shared K3 whenever ANY fused segment exists
        # (delta pipeline or a unit table's routed partials)
        k3dias_entry = None

        def _seg_fused(e):
            # a segment enqueues into the shared K3 when it carries either
            # a routed-partial scatter ("fs" at e[4]) or a fully fused
            # run/block pipeline ("frun"/"fblk" at e[5])
            return ((len(e) > 4 and e[4] and e[4][0] == "fs")
                    or (len(e) > 5 and e[5]
                        and e[5][0] in ("frun", "fblk")))

        any_fs = (dfused_entry is not None
                  or any(_seg_fused(e) for e in run_meta + block_meta))
        if any_fs and self.meta[4]:
            dia_offs, dv, anti_offs, adv = pad_dias_for_k3(
                self.meta[4], arrays["dias"], self.tables.nrows)
            if dv is not None:
                arrays["dias_fused_dv"] = dv
            if adv is not None:
                arrays["dias_fused_adv"] = adv
            # keep the raw per-offset grids too: SpMV reads only the
            # padded K3 streams (jit prunes unused args), but the SpMM
            # column loop runs with skip_dias and adds the DIA part as
            # ONE (rows, k) slab pass that reads each dv grid once
            # instead of once per column
            k3dias_entry = ("k3dias", dia_offs, anti_offs)
        arrays["runs"] = run_arrays
        arrays["blocks"] = block_arrays
        self._pages_arrays = arrays
        meta = list(self.meta)
        meta[2] = tuple(run_meta)
        meta[3] = tuple(block_meta)
        extras = [e for e in (dmeta_entry, dscatter_entry, dfused_entry,
                              k3dias_entry, fall_entry) if e]
        self._pages_meta = tuple(meta) + tuple(extras)

    def _build_fblk(self, t, order, plan, br: int, bc: int, ncols: int):
        """Fused-block segments: per block row r, a routed segment whose
        source is the gathered grid after a width-bc sliding lane sum
        (destinations at unit-end lanes, ref ``block_row_tmpl.c``'s
        register-blocked FMA role).  Returns (entry_arrays, seg_metas,
        n_tail) or None."""
        T, g = plan["T"], plan["g"]
        n_page = T * g
        U = t["rows"].shape[0]
        rows_o = t["rows"][order].astype(np.int64)
        vals_o = np.asarray(t["vals"])[order]        # (U, br, bc)
        nrows = self.tables.nrows
        entry_arrays = {
            "plan": {k: plan[k] for k in ("plo", "sl")},
        }
        # per-r value grids in gathered-grid order
        vg = np.zeros((br, T, 8, 128), dtype=vals_o.dtype)
        vg[:, :, :, :] = np.moveaxis(
            vals_o[:n_page], 1, 0).reshape(br, T, 8, 128)
        entry_arrays["valsg"] = vg
        seg_metas = []
        dest = np.full(T * 1024, nrows, dtype=np.int64)
        ends = np.arange(n_page, dtype=np.int64) * bc + (bc - 1)
        dest_rs = []
        for r in range(br):
            dest[ends] = rows_o[:n_page] + r
            dest_rs.append(dest.copy())
            seg = plan_partial_segment(dest_rs[-1], nrows)
            if seg is None:
                return None
            inst_meta, seg_arrays, has_res, M_pad = seg
            entry_arrays[f"fb_{r}"] = seg_arrays
            seg_metas.append((inst_meta, has_res, M_pad))
        entry_arrays["_dest_r"] = dest_rs
        entry_arrays["_tail"] = order[n_page:]   # caller demotes to delta
        return entry_arrays, tuple(seg_metas), 0

    def _merge_fused_segments(self, arrays, dfused_entry, run_meta,
                              run_arrays, block_meta, block_arrays):
        """Build the merged ("fall") plan over every fused segment's
        source grid; repacks delta/run G1 wires in place and stores the
        merged instance arrays under ``arrays["fall"]``.  Returns the
        static extras entry or None."""
        nrows = self.tables.nrows
        seg_desc = []
        dest_list = []
        tg = None
        if dfused_entry is not None and "_dest" in arrays.get("fused", {}):
            dest_list.append(arrays["fused"]["_dest"])
            tg = arrays["fused"].get("_tile_group")
            seg_desc.append(("delta",))
        for ri, e in enumerate(run_meta):
            if (len(e) > 5 and e[5] and e[5][0] == "frun"
                    and "_dest" in run_arrays[ri].get("frun", {})):
                dest_list.append(run_arrays[ri]["frun"]["_dest"])
                seg_desc.append(("run", ri))
        for bi, e in enumerate(block_meta):
            if (len(e) > 5 and e[5] and e[5][0] == "fblk"
                    and "_dest_r" in block_arrays[bi]):
                for r, d in enumerate(block_arrays[bi]["_dest_r"]):
                    dest_list.append(d)
                    seg_desc.append(("blk", bi, r))
        if len(dest_list) < 2:
            return None     # a single segment is already one instance

        merged = merge_segment_plan(dest_list, nrows,
                                    delta_tile_group=tg)
        if merged is None:
            log_warning("merged fused plan not applicable; the %d fused "
                        "segments keep separate route instances",
                        len(dest_list))
            return None
        inst_meta, marrays, bounds, has_res = merged

        # identity G1 in the segment kernels: the merged instances apply
        # their own G1 at runtime (overlapping folds, see merged_e1s);
        # run/delta kernels then emit RAW grids.  Identity wires on a
        # padded tile read its zeros, so padding stays exact.
        # All per-segment mutations are STAGED and applied only after the
        # whole merge succeeds: an exception mid-loop (caught by the
        # caller, which keeps the per-segment plans) must not leave a
        # segment kernel holding identity G1 wires (ADVICE r3).
        ident = np.broadcast_to(np.arange(128, dtype=np.int32),
                                (8, 128)).astype(np.int32)
        staged_mg = []   # (target_dict, new_mg) applied on success
        res_pos = marrays.pop("res_pos", None)
        res_dest = marrays.pop("res_dest", None)
        res_desc = []
        for si, (kind, *ids) in enumerate(seg_desc):
            b0, b1 = bounds[si], bounds[si + 1]
            if kind == "delta":
                f = arrays["fused"]
                for mk in ("mg", "mg2"):   # hybrid tail carries mg2
                    if mk not in f:
                        continue
                    low = np.asarray(f[mk]) & 0x3FFF
                    staged_mg.append(
                        (f, mk,
                         (low | ((ident + 1) << 16)).astype(np.int32)))
            elif kind == "run":
                fr = run_arrays[ids[0]]["frun"]
                low = np.asarray(fr["mg"]) & 0x3FFF
                staged_mg.append(
                    (fr, "mg",
                     (low | ((ident + 1) << 16)).astype(np.int32)))
            if res_pos is not None and res_pos.size:
                m = (res_pos >= b0 * 128) & (res_pos < b1 * 128)
                if not m.any():
                    continue
                lp_ = res_pos[m].astype(np.int64) - b0 * 128
                dd = res_dest[m].astype(np.int32)
                if kind == "delta":
                    f = arrays["fused"]
                    cap = f["_cols_at_pos"]
                    # merged-order flat values (hybrid layouts interleave
                    # two K1 parts; per-part "vals" would misindex)
                    vflat = (f["_vals_flat"] if "_vals_flat" in f
                             else np.asarray(f["vals"]).reshape(-1))
                    marrays["dres_cols"] = np.minimum(
                        cap[lp_], self.tables.ncols - 1).astype(np.int32)
                    marrays["dres_vals"] = vflat[lp_]
                    marrays["dres_dest"] = dd
                    res_desc.append(("dres",))
                elif kind == "run":
                    ri = ids[0]
                    fr = run_arrays[ri]["frun"]
                    u = fr["_punit"][lp_]
                    marrays[f"rres_{ri}_cols"] = fr["_cols_u_o"][u].astype(
                        np.int32)
                    marrays[f"rres_{ri}_vals"] = fr["_vals2d_o"][u]
                    marrays[f"rres_{ri}_dest"] = dd
                    res_desc.append(("rres", ri))
                else:
                    bi, r = ids
                    marrays[f"bres_{bi}_{r}_pos"] = lp_.astype(np.int32)
                    marrays[f"bres_{bi}_{r}_dest"] = dd
                    res_desc.append(("bres", bi, r))
        # merge fully planned: NOW apply the staged mg repacks and drop
        # the (dead) per-segment instance arrays
        for tgt, mk, new_mg in staged_mg:
            tgt[mk] = new_mg
        if any(k == "delta" for k, *_ in seg_desc):
            f = arrays["fused"]
            for i in range(len(dfused_entry[1][3])):
                for kk in ("g2a", "g2b", "g2c", "g3"):
                    f.pop(f"{kk}_{i}", None)
        for kind, *ids in seg_desc:
            if kind == "run":
                fr = run_arrays[ids[0]]["frun"]
                for i in range(len(run_meta[ids[0]][5][1][3])):
                    for kk in ("g2a", "g2b", "g2c", "g3"):
                        fr.pop(f"{kk}_{i}", None)
            elif kind == "blk":
                bi, r = ids
                block_arrays[bi].pop(f"fb_{r}", None)
        arrays["fall"] = marrays
        return ("fall", tuple(seg_desc), inst_meta,
                tuple(bounds), tuple(res_desc))


class _Graph:
    """One captured executor call: the CUDA graph, the static input it
    reads, the static output it writes, and the device memory its private
    pool took during the capture (bytes)."""

    __slots__ = ("graph", "x", "out", "nbytes")

    def __init__(self, graph, x, out, nbytes):
        self.graph, self.x, self.out, self.nbytes = graph, x, out, nbytes


class CsxExecutor:
    """Callable SpMV executor for one partition's plan on a device."""

    def __init__(self, meta, arrays, nrows: int, ncols: int,
                 dtype: torch.dtype, device: torch.device,
                 variant: str = "paged"):
        self.meta = meta
        self.variant = variant    # "paged" or "plain" (the plain tables)
        self.arrays = arrays
        self.nrows = nrows
        self.ncols = ncols
        self.dtype = dtype        # the compute dtype (f32 for a bf16 matrix)
        self.device = device
        # ("mv",) and ("mm", k) -> _Graph, least recently used first; kept
        # here, not in a module cache, so that each graph's memory pool is
        # freed with its executor
        self._graphs = OrderedDict()

    @classmethod
    def from_tables(cls, tables: CsxTables, device) -> "CsxExecutor":
        """Plan ``tables`` on the host (:class:`HostPlan`) and upload the
        paged plan, or the plain tables when the planner made none, to
        ``device``; raises ``NotImplementedError`` for a plan outside the
        ported slice."""
        with span("spx.tune.plan"):
            plan = HostPlan(tables)
            plan._maybe_build_pages()
        return cls.from_plan(plan, device)

    @classmethod
    def from_plan(cls, plan: HostPlan, device) -> "CsxExecutor":
        """Upload ``plan`` (its paged plan, planned here unless it was
        planned or restored before, else its plain tables) to ``device``;
        raises ``NotImplementedError`` for a plan outside the ported
        slice."""
        plan._maybe_build_pages()
        if plan._pages_meta is not None:
            variant, meta, host = "paged", plan._pages_meta, plan._pages_arrays
        else:
            variant, meta, host = "plain", plan.meta, plan.arrays
        check_slice(meta)
        dtype = _DTYPES[plan._dtype]
        arrays = plan_to_torch(meta, host, device, dtype)
        return cls(meta, arrays, plan.tables.nrows, plan.tables.ncols,
                   dtype, torch.device(device), variant)

    def __call__(self, x, alpha=1.0, beta=0.0, y=None):
        """``alpha * A @ x + beta * y`` for x (ncols,), or the SpMM for X
        (ncols, k); the epilogue is elided when alpha is 1 and when beta is
        0 or y is absent (exec.py:894-907).  On the card ``A @ x`` is
        replayed from the executor's graph (:meth:`_replayed`) and the
        epilogue runs after it, so one graph serves every alpha and beta.
        A bf16 x is computed in the plan's dtype and gives a bf16 result
        (exec.py:861-867).  The result is always a new tensor."""
        with span("spx.exec.call"):
            low = isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
            x = self._as_vector(x, "x")
            apply_alpha = not (isinstance(alpha, (int, float))
                               and float(alpha) == 1.0)
            apply_beta = not (y is None or (isinstance(beta, (int, float))
                                            and float(beta) == 0.0))
            with self._on_device():
                if x.dim() == 2:
                    # the graph reads X.T, copied in k-major, and writes Y.T
                    acc, static = self._replayed(("mm", x.shape[1]),
                                                 self._matmat, x.T)
                    yt, acc = acc, acc.T.contiguous()  # a view only at k = 1
                    static = static and acc.data_ptr() == yt.data_ptr()
                else:
                    acc, static = self._replayed(("mv",), self._matvec, x)
                with span("spx.exec.epilogue"):
                    if apply_alpha:
                        acc = acc * alpha
                    if apply_beta:
                        acc = acc + beta * self._as_vector(y, "y")
                    if low:
                        acc = acc.to(torch.bfloat16)
                    elif static and not (apply_alpha or apply_beta):
                        acc = acc.clone()   # never the graph's own output
        return acc

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """``A @ X`` for X (ncols, k) on the plan's device, run eagerly:
        (nrows, k).  :meth:`__call__` replays the same body from a graph.

        A fused plan (:func:`fused_mm_ok`) runs the reference's k-batched
        path (exec.py:86-101): chunks of ``MM_FUSED_KB`` columns of the
        k-major X.T through :func:`fused_mm_contrib`, whose kernels read the
        metadata once per chunk.  Any other plan (the legacy paged and the
        plain-table variants) runs the SpMV once per column, as the
        reference's column loop does (:102-118); the DIA tables run inside
        each column's SpMV, where the reference adds them in one XLA slab
        pass (:120-130), which has no kernel of its own.  The reference's
        v5e-measured ``MM_COLUMN_LOOP_MAX`` (:851-876) is not carried over:
        the k-batched kernels run for every k."""
        with self._on_device():
            return self._matmat(X.T.contiguous()).T.contiguous()

    def _matvec(self, x: torch.Tensor) -> torch.Tensor:
        return local_contrib(self.meta, self.arrays, x,
                             nrows_part=self.nrows, ncols=self.ncols)

    def _matmat(self, xt: torch.Tensor) -> torch.Tensor:
        """The k-major SpMM: (k, ncols) contiguous -> (k, nrows)."""
        k = xt.shape[0]
        if self.variant == "paged" and fused_mm_ok(self.meta):
            outs = [fused_mm_contrib(self.meta, self.arrays,
                                     xt[c0:c0 + MM_FUSED_KB],
                                     nrows_part=self.nrows, ncols=self.ncols)
                    for c0 in range(0, k, MM_FUSED_KB)]
        else:
            outs = [self._matvec(xt[j])[None] for j in range(k)]
        if not outs:
            return xt.new_zeros((0, self.nrows))
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    def _replayed(self, key, body, x):
        """``(body(x), whether that is a graph's static output)``.

        On the card ``body`` runs from this executor's CUDA graph for
        ``key``: each call copies x into the graph's static input and
        replays the graph on the current stream.  The graph is captured at
        the first call for its key (:meth:`_capture`); up to
        ``MM_GRAPHS`` SpMM widths keep theirs.  On the CPU, and under a
        capture of the caller's own (the counterpart of the reference's
        tracer check, exec.py:859-860: the kernels then launch into the
        caller's graph), ``body`` runs eagerly."""
        if (x.device.type != "cuda" or not x.numel()
                or torch.cuda.is_current_stream_capturing()):
            return body(x.contiguous()), False
        g = self._graphs.get(key)
        if g is None:
            with span("spx.exec.capture"):
                g = self._capture(key, body, x)
        else:
            self._graphs.move_to_end(key)
        g.x.copy_(x)
        try:
            with span("spx.exec.replay"):
                g.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"replaying the CUDA graph of {key} failed: "
                               f"{e}") from e
        return g.out, True

    def _capture(self, key, body, x) -> _Graph:
        """Capture ``body`` on a static copy of x into a new graph for
        ``key``.  It runs eagerly once first, on a side stream: the kernels'
        build at first launch and the device copies the launchers cache
        (``_launch._offsets_tensor``, ``kernels._steps``) cannot happen
        under a capture.  A failed capture raises, naming ``key``; nothing
        falls back to the eager path."""
        static_x = x.clone(memory_format=torch.contiguous_format)
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            body(static_x)
        current.wait_stream(side)
        # keep_graph: the captured graph stays inspectable (its kernel
        # nodes); it is instantiated at its first replay
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.graph(graph):
                reserved = torch.cuda.memory_reserved()
                out = body(static_x)
        except Exception as e:
            raise RuntimeError(f"capturing the CUDA graph of {key} failed: "
                               f"{e}") from e
        g = _Graph(graph, static_x, out,
                   torch.cuda.memory_reserved() - reserved)
        count_max("graph.bytes_max", g.nbytes)
        label = "exec.graph_nodes." + "".join(str(k) for k in key)
        types = graph_node_types(graph)
        count_max(label, sum(types.values()))
        for kind, n in types.items():
            count_max(f"{label}.{kind}", n)
        self._graphs[key] = g
        widths = [k for k in self._graphs if k[0] == "mm"]
        for old in widths[:-MM_GRAPHS]:
            del self._graphs[old]
        return g

    def graph_bytes(self) -> dict:
        """Device memory each of the executor's graphs took at its capture,
        by key (bytes)."""
        return {key: g.nbytes for key, g in self._graphs.items()}

    def _on_device(self):
        """The matrix's CUDA device made current for one executor call, so
        that every kernel launches on the operands' device (the ctypes
        launchers take the CUDA runtime's current device); nothing on the
        CPU.  Entered once a call, not once a launch."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _as_vector(self, v, name: str) -> torch.Tensor:
        """``v`` as a tensor of the plan's compute dtype on the plan's
        device (a bf16 tensor is upcast)."""
        if isinstance(v, torch.Tensor):
            if v.device != self.device:
                raise ValueError(f"{name} is on {v.device}; the matrix is "
                                 f"on {self.device}")
            return v.to(self.dtype).contiguous()
        a = np.asarray(v)
        if a.dtype.kind not in "fiu":
            raise TypeError(f"{name}: dtype {a.dtype} is not numeric")
        return torch.as_tensor(np.ascontiguousarray(a), dtype=self.dtype,
                               device=self.device)


class ShardsExecutor(CsxExecutor):
    """Several shards of one matrix on one device as one executor, the
    counterpart of the reference's one program for all shards
    (``_compiled_multi``, exec.py:135-157; symmetric: ``_compiled_sym_multi``,
    symmetric.py:40-64), itself the reference C library's single
    barrier-synchronised dispatch (``CsxKernels.cpp:35-80``).

    Its body runs each shard's eager body in turn on the one x: each
    shard's rows are concatenated into one result, or, for ``summed``
    (the per-shard symmetric shards, whose bodies give each a result over
    every row), the shards' results are added.  The SpMM holds each
    shard's own k-major body, k-batched on a shard whose plan is fused and
    once per column otherwise.  On the card a call replays one CUDA graph
    of this executor's for all shards (x copied in once; the alpha/beta
    epilogue and a bf16 x's casts once a call); the shards' own graphs are
    not captured for it."""

    def __init__(self, shards, nrows: int, ncols: int, summed: bool = False):
        ex0 = shards[0]
        super().__init__(None, None, nrows, ncols, ex0.dtype, ex0.device,
                         variant="shards")
        self.shards = list(shards)
        self.summed = summed

    def _matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._combine([ex._matvec(x) for ex in self.shards])

    def _matmat(self, xt: torch.Tensor) -> torch.Tensor:
        return self._combine([ex._matmat(xt) for ex in self.shards])

    def _combine(self, parts):
        """The shards' results (rows on the last axis) as one."""
        if not self.summed:
            return torch.cat(parts, dim=-1)
        out = parts[0]
        for p in parts[1:]:
            out.add_(p)
        return out
