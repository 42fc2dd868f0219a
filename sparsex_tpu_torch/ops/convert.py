"""Upload of the host planners' NumPy plan as device tensors ("weights
carried across").

``plan_to_torch`` takes the paged meta and arrays that
``ops.exec.HostPlan._maybe_build_pages`` builds (the reference executor's
planning, copied; or the plain-table meta and arrays when it built none),
and returns the tensors the executor reads, placed on ``device`` once.
Values take the plan's value dtype; int8 wires, the packed K1 metadata and
the page plans' ``plo`` / ``sl`` streams stay as they are (the delta
stream's ``sl`` int16, the unit plans' int32); index streams of the torch
gathers, scatter-adds and residual adds become int64.
One array changes form on the way: for unmasked (``um & 1``) route
instances the planner bakes K2's batched-transpose lane offset into
``g2b`` (``fused._g2b_lane_offset``), which the CUDA K2 does not use, so
the offset is taken off again, in the delta pipeline's, each fused run
table's, the merged plan's and each partial-segment route's (``fscatter``)
instances and each fblk block-row segment's (``fb_{r}``).  The planner
keeps raw um2 targets below ``ceil8(A2R)`` (``route.py:274-281``), so
``raw = g2b - (c % _k2_gba(A2R)) * ceil8(A2R)`` is exact.  A legacy scatter
plan (``route.build_scatter_plan``: the paged delta's ``delta_scatter`` and
a routed table's ``scatter``) keeps its raw wires, each array shaped (K, R,
128) as the lane gather takes it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sparsex_tpu_torch.ops.fused import L, _k2_gba, k1_style, k1_window
from sparsex_tpu_torch.timing import count, span

# index streams of the torch gathers and index_add_ residual adds
_INDEX_KEYS = frozenset((
    "res_cols", "res_dest", "left_rows", "left_cols",    # dfused / frun
    "res_cols_u", "tail_rows", "tail_cols",              # frun
    "rows", "cols", "row_ids",                           # plain tables
    "dres_cols", "dres_dest",                            # fall
    "res_pos"))                                   # fs / fb_{r} residuals


def _is_index(key: str) -> bool:
    return key in _INDEX_KEYS or (
        key.startswith("rres_") and key.endswith(("_cols", "_dest"))) or (
        key.startswith("bres_") and key.endswith(("_pos", "_dest")))


def g2b_raw(g2b: np.ndarray, A2R: int) -> np.ndarray:
    """Inverse of ``fused._g2b_lane_offset`` for one (128, W2, 128) wire
    array of an unmasked instance."""
    GBa = _k2_gba(A2R)
    if GBa == 1:
        return g2b
    A2R8 = -(-A2R // 8) * 8
    off = ((np.arange(L) % GBa) * A2R8).astype(np.int16)
    raw = g2b.astype(np.int16) - off[:, None, None]
    if raw.min(initial=0) < 0 or raw.max(initial=0) >= A2R8:
        raise ValueError("g2b wires do not carry the um2 lane offset")
    return raw.astype(np.int8)


def _upload(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _upload_tree(src, device, dtype, inst=()) -> Dict[str, object]:
    """Upload one plan dict: values in ``dtype``, index streams int64, wires
    and packed K1 metadata as they are; ``g2b_{i}`` of an unmasked instance
    ``inst[i]`` loses its lane offset.  Host-only stashes (``_*``) stay."""
    out: Dict[str, object] = {}
    for key, a in src.items():
        if key.startswith("_"):
            continue
        if isinstance(a, dict):
            out[key] = _upload_tree(a, device, dtype)
            continue
        a = np.asarray(a)
        if key.startswith("g2b_") and inst:
            meta_i = inst[int(key[4:])]
            if meta_i[9] & 1:
                a = g2b_raw(a, meta_i[2])
        if a.dtype.kind == "f":
            out[key] = _upload(a, device, dtype)
        elif _is_index(key):
            out[key] = _upload(a, device, torch.int64)
        else:
            out[key] = _upload(a, device)
    return out


def _k1_parts(pages_meta, pages_arrays):
    """(name, plo, q, npages, style) of every K1 part of the plan: the
    delta bulk and tail, and each fused run table."""
    extras = {e[0]: e[1:] for e in pages_meta[5:] if e}
    parts = []
    if "dfused" in extras:
        fmeta, src = extras["dfused"][0], pages_arrays["fused"]
        parts.append(("fused plo", src["plo"], fmeta[1], fmeta[2],
                      fmeta[6] if len(fmeta) > 6 else "sl"))
        if len(fmeta) > 7 and fmeta[7] is not None:
            (_T2, q2, npages2, style2), _inter = fmeta[7]
            parts.append(("fused plo2", src["plo2"], q2, npages2, style2))
    for ri, (entry, t) in enumerate(zip(pages_meta[2],
                                        pages_arrays.get("runs", ()))):
        if len(entry) > 5 and entry[5] and entry[5][0] == "frun":
            fmeta_r = entry[5][1]
            parts.append((f"run {ri} plo", t["frun"]["plo"], fmeta_r[1],
                          fmeta_r[2], fmeta_r[5]))
    return parts


def _check_windows(pages_meta, pages_arrays) -> None:
    """Every K1 tile's window must lie inside the page grid that
    ``fused._k1_x2`` builds for its part, since the CUDA K1 reads it
    unchecked: a lane-placed part's window ``plo`` counts q8-page blocks
    (pages ``plo*q8`` to ``plo*q8 + q8 - 1``), a dense-tile part's counts
    pages (``plo`` to ``plo + q - 1``, and q <= 16, the pages its 14-bit
    offsets reach)."""
    for name, plo, q, npages, style in _k1_parts(pages_meta, pages_arrays):
        align, npages_pad = k1_window(q, npages, style)
        dense = k1_style(style)[0]
        if dense and not 1 <= q <= 16:
            raise ValueError(f"{name}: a dense K1 window of {q} pages "
                             "(1..16)")
        last = q if dense else align       # pages a window reaches past plo
        plo = np.asarray(plo, dtype=np.int64)
        if plo.size and (plo.min() < 0 or int(plo.max()) * align + last
                         > npages_pad):
            raise ValueError(f"{name}: K1 windows outside the "
                             f"{npages_pad}-page grid")


# the paged delta streams of a plan: its direct one and, on a symmetric
# shard, the transposed one (meta key, arrays key, scatter route's meta
# key, arrays key)
_DELTA_STREAMS = (("dpages", "delta_pages", "dscatter", "delta_scatter"),
                  ("dpagesT", "delta_pages_t", "dscatterT",
                   "delta_scatter_t"))


def _delta_rows(pages_meta, key: str) -> int:
    """The rows a paged delta stream scatters into: the partition's for the
    direct stream, every row of the (square) matrix for a symmetric
    shard's transposed one; its padding slots carry that count as their
    sentinel row."""
    return pages_meta[1] if key == "dpagesT" else pages_meta[0]


def _page_windows(pages_meta, pages_arrays):
    """(name, plo, q, npages) of every legacy paged part of the plan: the
    ``dpages`` delta stream (and a symmetric shard's ``dpagesT``) and each
    paged run or block table's unit plan."""
    extras = {e[0]: e[1:] for e in pages_meta[5:] if e}
    parts = []
    for key, arr_key, _s, _a in _DELTA_STREAMS:
        if key in extras:
            _T, q, npages = extras[key]
            parts.append((f"{arr_key} plo", pages_arrays[arr_key]["plo"], q,
                          npages))
    for kind, metas, key in (("run", pages_meta[2], "runs"),
                             ("block", pages_meta[3], "blocks")):
        for i, (entry, t) in enumerate(zip(metas, pages_arrays.get(key,
                                                                   ()))):
            if len(entry) > 3 and entry[3] and "plan" in t:
                _T, q, _g, npages = entry[3]
                parts.append((f"{kind} {i} plan plo", t["plan"]["plo"], q,
                              npages))
    return parts


def _check_pages(pages_meta, pages_arrays) -> None:
    """The CUDA paged gathers read ``x2`` unchecked: every tile's q-page
    window must lie inside the ``max(npages, q)``-page grid that
    ``pad_x_pages`` gives its part, and every row of a paged delta stream
    inside [0, n], n its rows (:func:`_delta_rows`; n itself is the
    padding slots' sentinel, which the scatter epilogue drops)."""
    for name, plo, q, npages in _page_windows(pages_meta, pages_arrays):
        plo = np.asarray(plo)
        if plo.size and (plo.min() < 0 or int(plo.max()) + q
                         > max(npages, q)):
            raise ValueError(f"{name}: windows outside the "
                             f"{max(npages, q)}-page grid")
    for key, arr_key, _s, _a in _DELTA_STREAMS:
        rep = pages_arrays.get(arr_key)
        if rep is not None and "rows" in rep:
            n = _delta_rows(pages_meta, key)
            rows = np.asarray(rep["rows"])
            if rows.size and (rows.min() < 0 or rows.max() > n):
                raise ValueError(f"{arr_key} rows outside [0, {n}]")


def _scatter_plans(pages_meta, pages_arrays):
    """(name, metas, arrays, source length, destination rows) of every
    legacy scatter plan (``route.build_scatter_plan``) of the plan: the
    ``dscatter`` route of the paged delta stream's products (and a
    symmetric shard's ``dscatterT``, into every row of the matrix) and each
    routed run or block table's (its partials, padded to M_pad)."""
    extras = {e[0]: e[1:] for e in pages_meta[5:] if e}
    plans = []
    for key, _arr_key, skey, sarr_key in _DELTA_STREAMS:
        if skey in extras:
            plans.append((sarr_key, extras[skey][0], pages_arrays[sarr_key],
                          extras[key][0] * 1024,
                          _delta_rows(pages_meta, key)))
    for kind, metas, key in (("run", pages_meta[2], "runs"),
                             ("block", pages_meta[3], "blocks")):
        for i, (entry, t) in enumerate(zip(metas, pages_arrays.get(key,
                                                                   ()))):
            if len(entry) > 4 and entry[4] and "scatter" in t:
                plans.append((f"{kind} {i} scatter", entry[4][0],
                               t["scatter"], entry[4][2], pages_meta[0]))
    return plans


def _check_scatter_plans(pages_meta, pages_arrays) -> None:
    """The lane gathers of a legacy scatter plan read whole rows of the
    shapes the route metas give, and the residual adds index the source
    stream: every instance's wires must have those shapes and take source
    rows inside the stream, every residual position must lie in the stream
    and every residual row among the plan's destination rows."""
    for name, metas, plan, n_src, nrows in _scatter_plans(pages_meta,
                                                           pages_arrays):
        for i, (m, arrs) in enumerate(zip(metas, plan["chunks"])):
            S1c, S1p, A2R, D2R, Dp, K, W2, a0, a1 = m[:9]
            want = {"g1": (S1p, L), "g2a": (L * A2R, L),
                    "g2b": (L * W2, L), "g2c": (L * D2R, L),
                    "g3": (K, Dp, L)}
            got = {k: tuple(np.shape(arrs[k])) for k in want}
            if got != want or a1 - a0 != S1c or a1 * L > n_src:
                raise ValueError(f"{name} instance {i}: wires {got}, rows "
                                 f"{a0}:{a1} of {n_src // L}, expected "
                                 f"{want}")
        if len(plan["chunks"]) != len(metas):
            raise ValueError(f"{name}: {len(plan['chunks'])} wire sets for "
                             f"{len(metas)} route instances")
        pos = np.asarray(plan["res_pos"], dtype=np.int64)
        dest = np.asarray(plan["res_dest"], dtype=np.int64)
        if pos.shape != dest.shape or (pos.size and (
                pos.min() < 0 or pos.max() >= n_src or dest.min() < 0
                or dest.max() >= nrows)):
            raise ValueError(f"{name}: residuals outside the {n_src}-value "
                             f"stream or the rows [0, {nrows})")


def _upload_scatter(plan, device) -> Dict[str, object]:
    """A legacy scatter plan: each instance's wires as the lane gather
    takes them, (K, R, 128) int8 (K = 1 but for g3), the residuals int64."""
    return {"chunks": [{k: _upload(np.asarray(a).reshape(
                            (-1,) + np.shape(a)[-2:]), device)
                        for k, a in arrs.items()}
                       for arrs in plan["chunks"]],
            "res_pos": _upload(np.asarray(plan["res_pos"]), device,
                               torch.int64),
            "res_dest": _upload(np.asarray(plan["res_dest"]), device,
                                torch.int64)}


def _upload_table(entry, t, device, dtype) -> Dict[str, object]:
    """One run or block table's arrays; the instances of a fused run table
    (``frun``), of a partial-segment route (``fscatter``) and of an fblk
    table's block-row segments (``fb_{r}``) take their raw g2b wires, a
    legacy scatter plan (``scatter``) the lane gather's wire form."""
    special = ("frun", "fscatter", "scatter")
    up = _upload_tree({k: v for k, v in t.items()
                       if k not in special and not k.startswith("fb_")},
                      device, dtype)
    if "frun" in t:
        up["frun"] = _upload_tree(t["frun"], device, dtype, entry[5][1][3])
    if "fscatter" in t:
        up["fscatter"] = _upload_tree(t["fscatter"], device, dtype,
                                      entry[4][1])
    if "scatter" in t:
        up["scatter"] = _upload_scatter(t["scatter"], device)
    if len(entry) > 5 and entry[5] and entry[5][0] == "fblk":
        for r, (inst, _res, _m_pad) in enumerate(entry[5][1]):
            if f"fb_{r}" in t:     # not merged into the fall plan
                up[f"fb_{r}"] = _upload_tree(t[f"fb_{r}"], device, dtype,
                                             inst)
    return up


def plan_to_torch(pages_meta, pages_arrays, device,
                  dtype: torch.dtype) -> Dict[str, object]:
    """Device tensors of the plan, paged (``_pages_meta``) or plain-table
    (``meta``), with the reference's keys: ``fused`` (the delta pipeline),
    ``runs`` and ``blocks`` (one dict per table: ``{"frun": {...}}`` for a
    fused run table, the table itself for a plain one, with its unit-page
    ``plan`` when paged, ``{}`` for a ``cvt`` one), ``fall`` (the merged
    plan), ``delta`` (plain delta singles, or None), ``delta_pages`` (the
    paged delta stream: ``sl`` kept int16, ``rows`` int32 as the kernel's
    scatter epilogue reads them), ``delta_scatter`` (its scatter route), the
    standalone ``dias`` and the K3 DIA grids; a symmetric shard's plan
    (``symmetric.shard_plan``) adds the transposed stream
    (``delta_pages_t``, ``delta_scatter_t``), its leftovers ``delta_t``
    (their ``cols`` global rows of the result) and the diagonal's values
    ``dvals``.  ``g2b_{i}`` holds raw wires.

    Runs in the span ``spx.tune.upload``, which ends when the copies are
    complete, and adds the bytes of the uploaded tensors to the counters
    ``plan.bytes.<class>`` (``PLAN_CLASSES``) and ``plan.bytes``."""
    with span("spx.tune.upload"):
        out = _plan_to_torch(pages_meta, pages_arrays, device, dtype)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    total = 0
    for key, tree in out.items():
        n = _tree_bytes(tree)
        if n:
            count(f"plan.bytes.{PLAN_CLASSES.get(key, key)}", n)
            total += n
    count("plan.bytes", total)
    return out


# the plan class each of plan_to_torch's keys holds (plan.bytes.<class>)
PLAN_CLASSES = {"delta_pages": "dpages", "delta_pages_t": "dpagesT",
                "delta_scatter": "dscatter", "delta_scatter_t": "dscatterT",
                "delta_t": "deltaT", "dias_fused_dv": "dia",
                "dias_fused_adv": "dia", "dias": "dia"}


def _tree_bytes(tree) -> int:
    """Bytes of the tensors in a nest of dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0


def _plan_to_torch(pages_meta, pages_arrays, device,
                   dtype: torch.dtype) -> Dict[str, object]:
    extras = {e[0]: e[1:] for e in pages_meta[5:] if e}
    _check_windows(pages_meta, pages_arrays)
    _check_pages(pages_meta, pages_arrays)
    _check_scatter_plans(pages_meta, pages_arrays)
    out: Dict[str, object] = {}
    if "dfused" in extras:
        out["fused"] = _upload_tree(pages_arrays["fused"], device, dtype,
                                    extras["dfused"][0][3])
    for key, col in (("runs", 2), ("blocks", 3)):
        out[key] = [_upload_table(entry, t, device, dtype) for entry, t in
                    zip(pages_meta[col], pages_arrays.get(key, ()))]
    if "fall" in extras:
        out["fall"] = _upload_tree(pages_arrays["fall"], device, dtype,
                                   extras["fall"][1])
    for key, arr_key, skey, sarr_key in _DELTA_STREAMS:
        if key in extras:
            rep = pages_arrays[arr_key]
            out[arr_key] = _upload_tree(
                {k: v for k, v in rep.items() if k != "rows"}, device, dtype)
            if "rows" in rep:      # read by the scatter epilogue alone
                out[arr_key]["rows"] = _upload(np.asarray(rep["rows"]),
                                               device, torch.int32)
        if skey in extras:
            out[sarr_key] = _upload_scatter(pages_arrays[sarr_key], device)
    delta = pages_arrays.get("delta")
    out["delta"] = (None if delta is None
                    else _upload_tree(delta, device, dtype))
    if pages_arrays.get("delta_t") is not None:
        out["delta_t"] = _upload_tree(pages_arrays["delta_t"], device, dtype)
    if pages_meta[4] and "k3dias" not in extras:   # standalone DIA tables
        out["dias"] = [{"vals": _upload(np.asarray(t["vals"]), device,
                                        dtype)}
                       for t in pages_arrays["dias"]]
    for key in ("dias_fused_dv", "dias_fused_adv", "dvals"):
        if pages_arrays.get(key) is not None:
            out[key] = _upload(np.asarray(pages_arrays[key]), device, dtype)
    return out
