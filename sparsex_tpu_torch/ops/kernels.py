"""One partition's SpMV contribution on PyTorch.

Counterpart of ``local_contrib`` (``sparsex_tpu/ops/kernels.py:259-736``),
ported for the 1-D paths of the paged variant (``_pages_meta``), of the
plain-table variant (the executor's ``meta``, when the planner made no
paged one) and of a symmetric shard's per-shard plan
(``symmetric.shard_plan``), with the reference's own queue
(``k3_pending``, ``k3_post``, ``fall_pieces``) and one shared K3 at the
end:

- the shared ``x2f`` page grid of the fused K1 calls (:320-331,
  ``shared_page_grid``);
- ``dfused``, the fused delta pipeline (:332-350), its K1 lane-placed
  (``lp``, bulk and tail) or dense-tile (``sl``);
- the standalone DIA tables with static offsets (``dia_contrib``, :352-361,
  :78-127), through the DIA kernel;
- the shared ``x2`` page grid of every legacy paged consumer (:392-402,
  ``paged_grid``) and ``dpages``, the page-bucketed delta product with
  its scatter-add in the kernel (the scatter epilogue), or its products
  through their scatter route ``dscatter``
  (:403-422, ``route.apply_scatter_plan``: five lane gathers per route
  instance) and the route's residual adds; or ``drows``, the port's
  row-blocked layout of a stream without a route (``ops/exec.device_layout``):
  the products summed in shared memory per row block, then added into y;
- the plain delta singles (gather + segment sum, :454-459);
- ``frun`` fused run tables (:541-569; K1 ``rlp{W}`` or ``run{W}``) and
  the plain or paged run tables (:570-588), their partials through the
  paged-units kernel for a paged table's pageable prefix (``_gather_units``
  :471-491 and the sums, in one kernel); ``cvt`` tables are skipped
  (:536-540, :603-606);
- the plain or paged block tables (:647-665), likewise;
- ``fblk`` fused block tables (:607-646): the unit-page gather of x in
  grid form, per block row the products and a log-step lane-roll sum
  (``fblk_streams``), each row's stream through its own routed segment
  (as ``fs``) or the merged plan, the unpageable tail by an einsum;
- a run or block table's partial-segment route ``fs`` (``_scatter_partials``
  :493-515: G1 lane gather, T1 and K2 per instance into the shared K3, its
  residuals in ``k3_post``) or its legacy scatter plan (:516-528, through
  ``route.apply_scatter_plan``); the other tables scatter-add;
- the ``fall`` merged plan over the trimmed, concatenated K1 outputs and
  fblk block-row streams of its segments (``merged_source``) with its
  ``dres`` / ``rres`` / ``bres`` residuals (:684-716);
- the shared K3 with the ``k3dias`` DIA tables, then the ``k3_post`` adds
  (:718-734);
- on a symmetric shard, the diagonal's ``dvals * x_own`` first and the
  upper mirror's contributions ``z`` last (``transposed_contrib``: the
  transposed paged delta ``dpagesT`` through its scatter route
  ``dscatterT`` or the kernel's scatter epilogue, the DIA tables'
  transposed windows, the leftovers ``delta_t``, the run and block tables'
  transposed scatters).

A k-major x (k, ncols) runs the same composition with every kernel in its
k-batched variant (``fused_mm_ok`` / ``fused_mm_contrib``,
kernels.py:739-916): plans with a fused segment only, no paged delta,
fblk table or standalone DIA table; a paged run or block table's units
are gathered by a clipped take there and scatter-added, as the
reference's SpMM does.

Every other table class or extra raises ``NotImplementedError`` naming the
ROADMAP.md queue item that ports it; nothing runs silently by another
route.  ``static_meta`` and ``tables_to_arrays`` are the port's copies of
the reference's (kernels.py:41-75), which the host planner starts from.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparsex_tpu_torch.ops.fused import (MAX_KB, L, add_products,
                                         add_totals, fused_delta_a1,
                                         fused_delta_e1s,
                                         fused_run_a1, fused_run_e1s,
                                         instances_overlap, k1_style,
                                         k3_combine, merged_e1s,
                                         partial_segment_e1s)
from sparsex_tpu_torch.ops.pallas_kernels import (delta_pages_products,
                                                  delta_pages_spmv,
                                                  delta_rowblock_acc,
                                                  dia_spmv, pad_x_pages,
                                                  page_grid,
                                                  paged_gather_grid,
                                                  paged_units)
from sparsex_tpu_torch.ops.route import apply_scatter_plan
from sparsex_tpu_torch.preprocess.encodings import EncType
from sparsex_tpu_torch.preprocess.tables import CsxTables
from sparsex_tpu_torch.preprocess.xform import run_step


def static_meta(tables: CsxTables) -> Tuple:
    """Static signature of one partition's tables (copied from
    ``sparsex_tpu/ops/kernels.py:41``): ``(nrows, ncols, runs, blocks,
    dias)`` with each DIA table's offsets baked in."""
    runs = tuple((int(t.enc), t.delta, t.width) for t in tables.runs)
    blocks = tuple((int(t.enc), t.br, t.bc) for t in tables.blocks)
    dias = tuple((t.anti, tuple(int(o) for o in t.offsets), t.ndiags)
                 for t in tables.dias)
    return (tables.nrows, tables.ncols, runs, blocks, dias)


def tables_to_arrays(tables: CsxTables) -> Dict[str, Any]:
    """The tables' host arrays as the planners take them (copied from
    ``sparsex_tpu/ops/kernels.py:58``)."""
    arrs: Dict[str, Any] = {"delta": None, "runs": [], "blocks": [],
                            "dias": []}
    if tables.delta is not None and tables.delta.nnz:
        arrs["delta"] = {
            "row_ids": tables.delta.row_ids,
            "cols": tables.delta.cols,
            "vals": tables.delta.vals,
        }
    for t in tables.runs:
        arrs["runs"].append({"rows": t.rows, "cols": t.cols, "vals": t.vals})
    for t in tables.blocks:
        arrs["blocks"].append({"rows": t.rows, "cols": t.cols, "vals": t.vals})
    for t in tables.dias:
        arrs["dias"].append({"offsets": t.offsets.astype(np.int32),
                             "vals": t.vals})
    return arrs

def _refuse(what: str) -> None:
    """Refuse a plan part that no planner of the port makes: the
    reference's stacked multi-device classes (``dsfused``, DIA tables with
    traced offsets) included, since each rank of ``parallel/shard.py``
    plans its own tables."""
    raise NotImplementedError(
        f"{what} is not a plan that sparsex_tpu_torch makes or runs")


def _kind(entry):
    """The execution class tag of a run/block entry (``cvt``, ``frun``,
    ``fblk``) or None for a plain table."""
    return entry[5][0] if len(entry) > 5 and entry[5] else None


def unmerged_overlapping_runs(meta):
    """Indices of the fused run tables (``frun``) whose route instances
    overlap in source rows and that no merged plan (``fall``) takes: K1's
    one G1 grid would route all but one fold through the wrong lanes."""
    fall = next((e for e in meta[5:] if e and e[0] == "fall"), None)
    merged = ({ids[0] for kind, *ids in fall[1] if kind == "run"}
              if fall else set())
    return [ri for ri, e in enumerate(meta[2]) if _kind(e) == "frun"
            and ri not in merged and instances_overlap(e[5][1][3])]


def check_slice(meta) -> None:
    """Raise ``NotImplementedError`` unless ``meta`` holds only what the
    port runs.  ``meta`` is the executor's paged ``_pages_meta`` or, when
    the planner made none, its plain-table ``meta``.  Ported: fused delta
    and run segments in every K1 style (lane-placed ``lp`` / ``rlp{W}``,
    dense-tile ``sl`` / ``run{W}``), fused block tables (``fblk``), their
    merged plan with its ``dres`` / ``rres`` / ``bres`` residuals, DIA
    tables riding K3 or standalone (static offsets), the legacy paged delta
    (``dpages``) with or without its scatter route (``dscatter``), or laid
    out in row blocks (``drows``, ``ops/exec.device_layout``), a
    symmetric shard's transposed one (``dpagesT``, ``dscatterT``), plain
    delta singles, and plain or paged (unit-page) run and block tables,
    scatter-added, routed through a partial segment (``fs``) or through a
    legacy scatter plan."""
    _nr, _nc, run_meta, block_meta, dia_meta = meta[:5]
    extras = {e[0]: e[1:] for e in meta[5:] if e}
    for key in extras:
        if key not in ("dfused", "k3dias", "fall", "dpages", "dscatter",
                       "dpagesT", "dscatterT", "drows"):
            _refuse(f"the {key!r} execution class")
    if "dfused" in extras:
        fmeta = extras["dfused"][0]
        k1_style(fmeta[6] if len(fmeta) > 6 else "sl")
        if len(fmeta) > 7 and fmeta[7] is not None:
            k1_style(fmeta[7][0][3])
    overlapping = unmerged_overlapping_runs(meta)
    if overlapping:
        raise NotImplementedError(
            f"fused run tables {overlapping}: their route instances overlap "
            "outside a merged plan, and K1's one G1 grid cannot route them "
            "(the port's HostPlan re-plans such a table)")
    for e in run_meta:
        kind = _kind(e)
        if kind == "cvt":
            continue
        if kind == "frun":
            k1_style(e[5][1][5])
            continue
        if kind is not None:
            _refuse(f"run table class {kind!r}")
    for e in block_meta:
        kind = _kind(e)
        if kind not in (None, "cvt", "fblk"):
            _refuse(f"block table class {kind!r}")
    if "fall" in extras:
        segs, _inst, _bounds, res_desc = extras["fall"]
        for seg in segs:
            if seg[0] not in ("delta", "run", "blk"):
                _refuse(f"merged-plan segment {seg[0]!r}")
        for rd in res_desc:
            if rd[0] not in ("dres", "rres", "bres"):
                _refuse(f"merged-plan residual {rd[0]!r}")
    if "k3dias" not in extras and any(offs is None
                                      for _a, offs, _n in dia_meta):
        _refuse("a DIA table with per-shard (dynamic) offsets")


@functools.lru_cache(maxsize=64)
def _steps(width: int, step: int, device: str):
    """Column (or row) offsets ``step * [0, width)`` of a run's elements."""
    return torch.arange(width, device=device) * step


def _unit_totals(vals2d, cols_u, steps, x, ncols: int):
    """Per-unit run totals ``sum_j vals2d[u, j] * x[cols_u[u] + steps[j]]``,
    columns clamped to [0, ncols); (k, U) for k-major x."""
    return (vals2d * x[..., (cols_u[:, None] + steps).clamp(
        0, ncols - 1)]).sum(-1)


def _run_steps(entry, device):
    """(row step, column offsets of a unit's elements) of a run table."""
    enc_i, delta, width = entry[:3]
    sr, sc = run_step(EncType(enc_i))
    return sr * delta, _steps(width, sc * delta, str(device))


def shared_page_grid(meta, x, ncols: int):
    """ONE padded page grid of x shared by the fused K1 calls, rounded to 8
    pages (kernels.py:320-331); None when the plan has no fused segment.
    It serves every dense-tile window (q <= MAX_Q = 8 pages in a grid of at
    least max(npages, 8)) and every lane-placed window whose q8 divides 8;
    ``fused._k1_x2`` pads its own grid for a part it does not fit (a
    32-page lp tail, unless the grid is a multiple of 32 pages)."""
    extras = {e[0] for e in meta[5:] if e}
    if "dfused" not in extras and not any(_kind(e) == "frun"
                                          for e in meta[2]):
        return None
    npages = -(-ncols // 1024)
    return page_grid(x, ncols, max(8, -(-npages // 8) * 8))


def paged_grid(meta, x, ncols: int):
    """ONE padded page grid of x shared by every legacy paged consumer (the
    ``dpages`` delta stream or its row-blocked ``drows``, a symmetric
    shard's transposed ``dpagesT``, each paged run or block table's unit
    plan), sized by their largest q and npages (kernels.py:392-402); None
    when the plan has none."""
    extras = {e[0]: e[1:] for e in meta[5:] if e}
    sigs = [extras[k][:3] for k in ("dpages", "dpagesT", "drows")
            if k in extras]
    sigs += [e[3] for e in (*meta[2], *meta[3]) if len(e) > 3 and e[3]]
    if not sigs:
        return None
    # (T, q, npages) and (T, q, g, npages): q at index 1, npages last
    return pad_x_pages(x, ncols, max(s[1] for s in sigs),
                       max(s[-1] for s in sigs))


def dia_tables(meta_dias, dias, x, ncols: int):
    """``(offsets, dv, x)`` of each non-empty standalone DIA table as the DIA
    kernel takes it: an anti-diagonal table runs as diagonals ``ncols-1-s``
    over the reversed x (kernels.py:120-123)."""
    out = []
    for (anti, offsets, _nd), t in zip(meta_dias, dias):
        if not offsets:
            continue
        if anti:
            out.append((tuple(ncols - 1 - s for s in offsets), t["vals"],
                        torch.flip(x[:ncols], (0,))))
        else:
            out.append((tuple(offsets), t["vals"], x))
    return out


def dia_contrib(meta_dias, dias, x, nrows_part: int, ncols: int, acc=None):
    """The standalone DIA tables with static offsets (``_dia_contrib_static``
    on its Pallas branch, kernels.py:114-127, 1-D, non-symmetric): one DIA
    kernel per table.  Adds into ``acc`` in place, or returns the first
    table's output when ``acc`` is None.  Any number of diagonals takes the
    kernel (the reference hands more than 64 to an XLA window sum)."""
    for offsets, dv, xs in dia_tables(meta_dias, dias, x, ncols):
        y = dia_spmv(offsets, dv, xs, nrows_part, ncols)
        acc = y if acc is None else acc.add_(y)
    return acc


def _partials(vals, xg, each: bool):
    """A unit table's partials from its gathered x: a (U, W) run table's
    unit sums (U,), or its products (U, W) when ``each``; a (U, br, bc)
    block table's row sums (U, br).  k-major xg (k, U, ...) gives (k, U,
    ...)."""
    if each:
        return vals * xg
    if vals.dim() == 3:
        return (vals * xg.unsqueeze(-2)).sum(-1)
    return (vals * xg).sum(-1)


def _unit_layout(kind: str, entry, device):
    """``(steps, each, offs)`` of a run or block table: the column offsets
    of a unit's x values, whether each product is its own partial, and the
    row offsets of a unit's partials (None: one partial per unit)."""
    dev = str(device)
    if kind == "blocks":
        _enc, br, bc = entry[:3]
        return _steps(bc, 1, dev), False, _steps(br, 1, dev)
    rstep, steps = _run_steps(entry, device)
    if rstep == 0:
        return steps, False, None
    return steps, True, _steps(entry[2], rstep, dev)


def unit_dest(kind: str, entry, t, nrows_part: int):
    """The destination row of each of a run or block table's partials, flat
    (:func:`unit_table_partials`), clamped into the rows where a unit
    spans several."""
    offs = _unit_layout(kind, entry, t["rows"].device)[2]
    if offs is None:
        return t["rows"]
    return (t["rows"][:, None] + offs).clamp(0, nrows_part - 1).reshape(-1)


def unit_table_partials(kind: str, entry, t, x, ncols: int,
                        nrows_part: int, x2, acc=None):
    """``(partials, dest)`` of a plain or paged run (``kind`` "runs") or
    block ("blocks") table in its unit order (kernels.py:471-491, :570-588,
    :647-665): a horizontal run table's unit sums, a diagonal or
    anti-diagonal one's products (each element writes its own row), a block
    table's block-row sums (:func:`_partials`), and the destination row of
    each (:func:`unit_dest`).  A paged table's pageable prefix (its units
    reordered by the planner) takes the paged-units kernel, which gathers,
    multiplies and sums in one pass, the rest and a plain table a clipped
    take; with an SpMV's ``acc`` the kernel also adds the prefix into
    ``acc`` itself, and only the rest is returned.  k-major x (k, ncols)
    takes the clipped take alone, as the reference's SpMM does
    (kernels.py:855)."""
    steps, each, _offs = _unit_layout(kind, entry, x.device)
    dest = unit_dest(kind, entry, t, nrows_part)
    vals, cols = t["vals"], t["cols"]
    plan_sig = entry[3] if len(entry) > 3 else None
    if plan_sig is None or "plan" not in t or x.dim() == 2:
        return _partials(vals, x[..., (cols[:, None] + steps).clamp(
            0, ncols - 1)], each), dest
    T, q, g, _npages = plan_sig
    n = T * g
    nd = dest.shape[0] // cols.shape[0] * n      # the prefix's partials
    plan = t["plan"]
    head = paged_units(plan["plo"], plan["sl"], vals[:n], x2, q, each, acc,
                       None if acc is None else dest[:nd])
    if acc is not None:     # the prefix is in acc: return the rest alone
        head, dest = head[:0], dest[nd:]
    if cols.shape[0] == n:
        return head, dest
    tail = _partials(vals[n:], x[(cols[n:, None] + steps).clamp(
        0, ncols - 1)], each)
    return (tail if acc is not None else torch.cat([head, tail])), dest


def _queue_partial_segment(scat, fs, partials, k3_pending, k3_post,
                           nrows_part: int):
    """A table's partial-segment route (``fs``, kernels.py:502-515), or an
    fblk block row's segment (:622-628): the flat partials, padded to
    M_pad, are the source of the route's instances
    (queued on ``k3_pending`` for the shared K3), their over-capacity
    residuals a ``take`` add on ``k3_post``."""
    _, inst_meta, has_res, m_pad = scat
    flat = partials.reshape(-1)
    if m_pad != flat.shape[0]:
        flat = F.pad(flat, (0, m_pad - flat.shape[0]))
    k3_pending += partial_segment_e1s(inst_meta, fs, flat, nrows_part)
    if has_res:
        k3_post.append(("take", flat, fs["res_pos"], fs["res_dest"]))


def _routed_add(acc, metas, plan, flat, has_res: bool, nrows_part: int):
    """``acc`` plus the flat stream ``flat`` scatter-added through a legacy
    scatter plan (``route.apply_scatter_plan``: the ``dscatter`` route,
    kernels.py:403-418, or a routed table's, :516-528), then its
    over-capacity residuals ``flat[res_pos]`` added at ``res_dest`` in
    place; ``acc`` None gives the routed sum itself."""
    y = apply_scatter_plan(metas, plan["chunks"], flat, nrows_part)
    acc = y if acc is None else acc + y
    if has_res:
        add_totals(acc, flat[plan["res_pos"]], plan["res_dest"])
    return acc


def fblk_streams(meta, arrs, x, ncols: int, x2):
    """``{(bi, r): flat}``: the partial stream of block row r of each fused
    block table ``bi`` (``fblk``, kernels.py:607-621): the unit-page gather
    of the table's x values in (T, 8, 128) grid form (``x2`` the shared
    page grid, :func:`paged_grid`), times ``valsg[r]``, then a width-bc
    sliding lane sum by lane rolls of 1, 2, 4, ... < bc in the reference's
    order, so each unit's bc products sum onto its last lane."""
    out = {}
    for bi, (entry, t) in enumerate(zip(meta[3], arrs["blocks"])):
        if _kind(entry) != "fblk":
            continue
        bc = entry[2]
        xgd = paged_gather_grid(entry[3], t["plan"], x, ncols, x2=x2)
        for r, vg in enumerate(t["valsg"]):
            prod = xgd * vg
            d = 1
            while d < bc:
                prod = prod + torch.roll(prod, d, dims=2)
                d *= 2
            out[(bi, r)] = prod.reshape(-1)
    return out


def merged_source(meta, arrs, x, ncols: int, x2f, blk):
    """The merged (``fall``) plan's source grid (S, L): each segment's raw
    K1 output (the delta bulk and tail, or a fused run table) or a fused
    block table's block-row stream (from ``blk``, :func:`fblk_streams`),
    trimmed to its bound width (K1 outputs are padded to whole tile
    groups; the plan's bounds use the unpadded grids), concatenated in the
    plan's segment order (kernels.py:684-691); (k, S, L) for k-major x."""
    extras = {e[0]: e[1:] for e in meta[5:] if e}
    segs, _inst, bounds, _res = extras["fall"]
    fall_pieces = []
    for i, seg in enumerate(segs):
        if seg[0] == "delta":
            a1 = fused_delta_a1(extras["dfused"][0], arrs["fused"], x, ncols,
                                x2=x2f)
        elif seg[0] == "run":
            a1 = fused_run_a1(meta[2][seg[1]][5][1],
                              arrs["runs"][seg[1]]["frun"], x, ncols, x2=x2f)
        else:
            a1 = blk[seg[1:]].view(-1, L)
        fall_pieces.append(a1[..., : bounds[i + 1] - bounds[i], :])
    return (torch.cat(fall_pieces, dim=-2) if len(fall_pieces) > 1
            else fall_pieces[0])


def fused_mm_ok(meta) -> bool:
    """Whether :func:`fused_mm_contrib` covers this paged meta
    (kernels.py:739): at least one fused segment (the k-batched kernels
    exist for them), and no fblk or legacy paged delta segment (those run
    the SpMV once per column)."""
    run_meta, block_meta = meta[2], meta[3]
    extras = {e[0] for e in meta[5:] if e}
    has_fused = ("dfused" in extras
                 or any(_kind(e) == "frun" for e in run_meta))
    if not has_fused:
        return False
    if any(_kind(e) == "fblk" for e in block_meta):
        return False
    return not extras & {"dpages", "dscatter", "drows"}


def fused_mm_contrib(meta, arrs, xt, *, nrows_part: int, ncols: int):
    """k-major SpMM over the fused pipeline (kernels.py:758): ``xt`` (k,
    ncols), k <= MAX_KB, gives (k, nrows_part).  It is
    :func:`local_contrib` on the k-major x: every kernel runs its
    k-batched variant, which reads the plan's metadata once for the k
    columns; the residual, tail and plain tables run k-major torch glue
    (gathers along the last axis, batched ``index_add_`` along axis 1).
    Caller gate: :func:`fused_mm_ok`."""
    if xt.dim() != 2 or not 1 <= xt.shape[0] <= MAX_KB:
        raise ValueError(f"xt: shape {tuple(xt.shape)}, expected (k, "
                         f"{ncols}) with 1 <= k <= {MAX_KB}")
    return local_contrib(meta, arrs, xt, nrows_part=nrows_part, ncols=ncols)


def local_contrib(meta, arrs, x, *, nrows_part: int, ncols: int,
                  symmetric: bool = False, row_start: int = 0,
                  nrows_glob: int = None, z_off: int = 0):
    """The dense (nrows_part,) contribution of one partition: every fused
    segment's K1 (the delta bulk and tail, each fused run table) and each
    fblk table's block-row streams, then either their per-segment route
    instances or the merged plan's (per-instance G1 lane gather + T1 +
    K2); the standalone DIA tables and the paged delta stream, scatter-added
    or routed; the plain and paged tables' adds; one K3 with
    the DIA tables that ride it, then the residual and spill adds.  A
    k-major x (k, ncols) of a :func:`fused_mm_ok` plan gives (k,
    nrows_part) through the same composition (:func:`fused_mm_contrib`).

    ``symmetric``: the partition is a symmetric shard's strict lower
    triangle (``symmetric.shard_plan``, rows from ``row_start``) and
    ``arrs["dvals"]`` its diagonal (kernels.py:287-300); ``acc`` then
    starts from ``dvals * x_own`` and the result is ``(acc, z)``, ``z`` the
    upper mirror's contributions over all ``nrows_glob`` rows
    (:func:`transposed_contrib`).  Its SpMV is 1-D: an SpMM runs it once
    per column.  In the multi-device executor's symmetric halo mode
    (``parallel/shard.py``) x is a window of the whole x: ``row_start`` is
    then the shard's first row in the window's frame and ``z_off`` the
    window's first column, which every z destination derived from a column
    adds (the reference's ``z_off``, kernels.py:262-266)."""
    if x.dim() not in (1, 2):
        raise ValueError(f"x: shape {tuple(x.shape)} is neither (ncols,) nor "
                         "k-major (k, ncols)")
    run_meta = meta[2]
    extras = {e[0]: e[1:] for e in meta[5:] if e}
    dfused = extras.get("dfused")
    k3dias = extras.get("k3dias")
    fall = extras.get("fall")
    k3_pending = []       # (e1, g3, K, um3) instances for the shared K3
    k3_post = []          # residual adds after it
    acc = None            # the plain tables' adds, made before K3

    def zeros():
        return torch.zeros(x.shape[:-1] + (nrows_part,), dtype=x.dtype,
                           device=x.device)

    lead = x.shape[:-1]   # () for the SpMV, (k,) for k-major x
    if lead and not fused_mm_ok(meta):
        raise ValueError("k-major x needs a plan with a fused segment and no "
                         "segment that runs once per column (fused_mm_ok)")
    x2f = shared_page_grid(meta, x, ncols)
    x2 = paged_grid(meta, x, ncols)      # shared by every paged consumer
    if symmetric:
        acc = own_rows(x, row_start, nrows_part) * arrs["dvals"]
    blk = fblk_streams(meta, arrs, x, ncols, x2)
    if fall is not None:  # every fused segment feeds the merged plan
        k3_pending += merged_e1s(fall[1], arrs["fall"],
                                 merged_source(meta, arrs, x, ncols, x2f,
                                               blk), nrows_part)
    if dfused is not None:
        fmeta, far = dfused[0], arrs["fused"]
        if fall is None:
            k3_pending += fused_delta_e1s(fmeta, far, x, ncols, nrows_part,
                                          x2=x2f)
            if fmeta[4]:   # over-capacity residuals (per-segment plan)
                k3_post.append(("prod", far["res_vals"], far["res_cols"],
                                far["res_dest"]))
        if fmeta[5]:       # unpageable spill, in both modes
            k3_post.append(("prod", far["left_vals"], far["left_cols"],
                            far["left_rows"]))

    dpages, dscatter = extras.get("dpages"), extras.get("dscatter")
    if meta[4] and k3dias is None:       # standalone DIA tables
        acc = dia_contrib(meta[4], arrs["dias"], x, nrows_part, ncols, acc)
    if dscatter is not None:   # the products through their scatter route
        acc = _routed_add(acc, dscatter[0], arrs["delta_scatter"],
                          delta_pages_products(dpages, arrs["delta_pages"],
                                               x, ncols, x2=x2),
                          dscatter[1], nrows_part)
    elif dpages is not None:   # the kernel's scatter epilogue
        acc = delta_pages_spmv(dpages, arrs["delta_pages"], x, nrows_part,
                               ncols, zeros() if acc is None else acc, x2=x2)
    elif "drows" in extras:    # row-blocked: the sums in shared memory
        _T, q, _np, rb = extras["drows"]
        dr = arrs["delta_rows"]
        acc = delta_rowblock_acc(dr["plo"], dr["sl"], dr["lrow"], dr["vals"],
                                 x2, q, zeros() if acc is None else acc,
                                 dr["blk_tile"], rb)

    d = arrs.get("delta")
    if d is not None and d["cols"].shape[0]:
        acc = add_products(zeros() if acc is None else acc, d["vals"],
                           d["cols"], d["row_ids"], x, ncols)

    for entry, t in zip(run_meta, arrs["runs"]):
        if _kind(entry) != "frun":   # cvt: in the delta pipeline; plain
            continue                 # and paged tables: below
        steps = _run_steps(entry, x.device)[1]
        _, fmeta_r, n_tail = entry[5]
        fr = t["frun"]
        if fall is None:
            k3_pending += fused_run_e1s(fmeta_r, fr, x, ncols, nrows_part,
                                        x2=x2f)
            if fmeta_r[4]:   # over-capacity residual unit totals
                k3_post.append(("acc", _unit_totals(
                    fr["res_vals2d"], fr["res_cols_u"], steps, x, ncols),
                    fr["res_dest"], None))
        if n_tail:           # unpageable tail units, in both modes
            k3_post.append(("acc", _unit_totals(
                t["tail_vals"], t["tail_cols"], steps, x, ncols),
                t["tail_rows"], None))

    for bi, (entry, t) in enumerate(zip(meta[3], arrs["blocks"])):
        if _kind(entry) != "fblk":
            continue
        # a fused block table (kernels.py:607-646): each block row's stream
        # through a partial segment of its own, unless the merged plan took
        # them all
        _, seg_metas, n_tail = entry[5]
        if fall is None:
            for r, seg in enumerate(seg_metas):
                _queue_partial_segment(("fs",) + seg, t[f"fb_{r}"],
                                       blk[(bi, r)], k3_pending, k3_post,
                                       nrows_part)
        if n_tail:           # unpageable tail blocks
            _enc, br, bc = entry[:3]
            dev = str(x.device)
            xt = x[(t["tail_cols"][:, None] + _steps(bc, 1, dev)).clamp(
                0, ncols - 1)]
            rows = (t["tail_rows"][:, None] + _steps(br, 1, dev)).clamp(
                0, nrows_part - 1)
            k3_post.append(("acc", torch.einsum(
                "urc,uc->ur", t["tail_vals"], xt).reshape(-1),
                rows.reshape(-1), None))

    for kind, metas in (("runs", run_meta), ("blocks", meta[3])):
        for entry, t in zip(metas, arrs[kind]):
            if _kind(entry) is not None:   # cvt, frun, fblk: handled above
                continue
            # a plain or paged unit table: its partials through its
            # partial-segment route (the SpMV of an fs table; the
            # reference's SpMM keeps the row scatter, kernels.py:497-501)
            # or its legacy scatter plan, else scatter-added, the pageable
            # prefix's by the kernel
            if acc is None:
                acc = zeros()
            scat = entry[4] if len(entry) > 4 and not lead else None
            fs = scat is not None and scat[0] == "fs" and "fscatter" in t
            legacy = scat is not None and not fs and "scatter" in t
            partials, dest = unit_table_partials(
                kind, entry, t, x, ncols, nrows_part, x2,
                None if fs or legacy else acc)
            if fs:
                _queue_partial_segment(scat, t["fscatter"], partials,
                                       k3_pending, k3_post, nrows_part)
            elif legacy:
                smetas, has_res, m_pad = scat
                flat = partials.reshape(-1)
                acc = _routed_add(acc, smetas, t["scatter"], F.pad(
                    flat, (0, m_pad - flat.shape[0])), has_res, nrows_part)
            else:
                add_totals(acc, partials.reshape(lead + (-1,)), dest)

    if fall is not None:  # the merged plan's residuals (its e1s are queued)
        fa = arrs["fall"]
        for rd in fall[3]:
            if rd[0] == "dres":
                k3_post.append(("prod", fa["dres_vals"], fa["dres_cols"],
                                fa["dres_dest"]))
            elif rd[0] == "bres":   # a merged block row's stream
                bi, r = rd[1:]
                k3_post.append(("take", blk[(bi, r)],
                                fa[f"bres_{bi}_{r}_pos"],
                                fa[f"bres_{bi}_{r}_dest"]))
            else:          # "rres": a merged run segment's unit totals
                ri = rd[1]
                steps = _run_steps(run_meta[ri], x.device)[1]
                k3_post.append(("acc", _unit_totals(
                    fa[f"rres_{ri}_vals"], fa[f"rres_{ri}_cols"], steps, x,
                    ncols), fa[f"rres_{ri}_dest"], None))

    # the shared K3: every queued routed instance + the DIA tables, y
    # written once; then the deferred residual adds, in place
    if k3_pending or k3dias is not None:
        dia_offs, anti_offs = k3dias if k3dias is not None else ((), ())
        pack = (dia_offs, arrs.get("dias_fused_dv"), anti_offs,
                arrs.get("dias_fused_adv"))
        y3 = k3_combine(k3_pending, pack, x, nrows_part, ncols)
        acc = y3 if acc is None else acc + y3
    elif acc is None:
        acc = zeros()
    for kind, a, b, c in k3_post:
        if kind == "prod":
            add_products(acc, a, b, c, x, ncols)
        elif kind == "take":   # a routed partial stream's residuals
            add_totals(acc, a[b], c)
        else:
            add_totals(acc, a, b)
    if symmetric:
        return acc, transposed_contrib(
            meta, arrs, x, x2, nrows_part=nrows_part, ncols=ncols,
            row_start=row_start,
            nrows_glob=ncols if nrows_glob is None else nrows_glob,
            z_off=z_off)
    return acc


def own_rows(x, row_start: int, nrows_part: int):
    """``x_own``: the x values at a symmetric shard's own rows, zero past
    x's end (kernels.py:289-300)."""
    own = x[row_start:row_start + nrows_part]
    if own.shape[0] < nrows_part:
        own = F.pad(own, (0, nrows_part - own.shape[0]))
    return own


def transposed_contrib(meta, arrs, x, x2, *, nrows_part: int, ncols: int,
                       row_start: int, nrows_glob: int, z_off: int = 0):
    """``z``, dense over the ``nrows_glob`` rows of a symmetric matrix: the
    upper mirror of a shard's strict lower triangle, each stored value
    applied a second time with row and column swapped (ref
    ``local_contrib``'s symmetric parts): the transposed paged delta stream
    ``dpagesT`` (its "columns" are the shard's global rows, so it reads x
    through the shared page grid ``x2``), through its scatter route
    ``dscatterT`` with the route's residual adds (kernels.py:423-441) or
    the kernel's scatter epilogue into z, whose padding slots carry the
    sentinel row ``nrows_glob``; the DIA tables' transposed windows, each
    diagonal's products with ``x_own`` added into a static slice of z
    (:144-153, :168-177); the transposed leftovers ``delta_t``, whose
    ``cols`` are rows of z (:460-469), or the plain delta itself where the
    shard has no paged stream; each run and block table's transposed
    products, gathered at the unit's rows and added at its columns
    (:589-598, :666-682).  Destinations outside [0, nrows_glob) are
    dropped, as ``mode="drop"`` drops them.  ``z_off`` is added to every
    destination derived from a table column (the DIA windows, the plain
    delta, the unit tables); the paged stream and ``delta_t`` were planned
    with global destinations (``symmetric.shard_plan``)."""
    extras = {e[0]: e[1:] for e in meta[5:] if e}
    dev = x.device
    x_own = own_rows(x, row_start, nrows_part)
    dpt, dst = extras.get("dpagesT"), extras.get("dscatterT")
    if dst is not None:
        z = _routed_add(None, dst[0], arrs["delta_scatter_t"],
                        delta_pages_products(dpt, arrs["delta_pages_t"], x,
                                             nrows_glob, x2=x2),
                        dst[1], nrows_glob)
    else:
        z = torch.zeros(nrows_glob, dtype=x.dtype, device=dev)
        if dpt is not None:
            delta_pages_spmv(dpt, arrs["delta_pages_t"], x, nrows_glob,
                             nrows_glob, z, x2=x2)
    for (anti, offsets, _nd), t in zip(meta[4], arrs.get("dias", ())):
        for k, o in enumerate(offsets):
            lo = (o - nrows_part + 1 if anti else o) + z_off
            z0, z1 = max(0, lo), min(nrows_glob, lo + nrows_part)
            if z1 <= z0:
                continue
            if anti:     # z[o - r] += dv[r] * x_own[r]: a reversed window
                prod = torch.flip(t["vals"][k] * x_own, (0,))
                z[z0:z1] += prod[z0 - lo:z1 - lo]
            else:        # z[r + o] += dv[r] * x_own[r], one pass a diagonal
                z[z0:z1].addcmul_(t["vals"][k][z0 - lo:z1 - lo],
                                  x_own[z0 - lo:z1 - lo])
    dt, off = arrs.get("delta_t"), 0
    if dt is None:   # no paged stream: the plain delta, columns rebased
        dt, off = arrs.get("delta"), z_off
    if dt is not None and dt["cols"].shape[0]:
        add_products(z, dt["vals"], dt["row_ids"] + row_start,
                     dt["cols"] + off if off else dt["cols"], x, ncols)
    for kind, metas in (("runs", meta[2]), ("blocks", meta[3])):
        for entry, t in zip(metas, arrs[kind]):
            steps, _each, offs = _unit_layout(kind, entry, dev)
            if offs is None:
                offs = _steps(1, 0, str(dev))
            xr = x[(t["rows"][:, None] + offs + row_start).clamp(0,
                                                                 ncols - 1)]
            if kind == "blocks":   # (U, br, bc) values, (U, br) x values
                prods = (t["vals"] * xr[:, :, None]).sum(1)
            else:                  # (U, W) values, one x value per element
                prods = t["vals"] * xr
            dest = (t["cols"][:, None] + steps + z_off).clamp(
                0, nrows_glob - 1)
            z.index_add_(0, dest.reshape(-1), prods.reshape(-1))
    return z


__all__ = ["check_slice", "dia_contrib", "dia_tables", "fused_mm_contrib",
           "fused_mm_ok", "local_contrib", "merged_source", "own_rows",
           "paged_grid", "shared_page_grid", "static_meta",
           "tables_to_arrays", "transposed_contrib", "unit_dest",
           "unit_table_partials"]
