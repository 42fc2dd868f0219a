"""One partition's SpMV contribution on PyTorch.

Counterpart of ``local_contrib`` (``sparsex_tpu/ops/kernels.py:259-736``),
ported for the 1-D, non-symmetric paths that the fused and blocky slices
run, with the reference's own queue (``k3_pending``, ``k3_post``,
``fall_pieces``) and one shared K3 at the end:

- the shared ``x2f`` page grid of every lane-placed K1 (:320-331,
  ``shared_page_grid``);
- ``dfused``, the fused delta pipeline (:332-350);
- the plain delta singles (gather + segment sum, :454-459);
- ``frun`` fused run tables (:541-569) and the plain, non-paged,
  non-routed run tables (:570-588); ``cvt`` tables are skipped (:536-540,
  :603-606);
- the ``fall`` merged plan over the trimmed, concatenated K1 outputs of
  its segments (``merged_source``) with its ``dres`` / ``rres`` residuals
  (:684-716);
- the shared K3 with the ``k3dias`` DIA tables, then the ``k3_post`` adds
  (:718-734).

Every other table class or extra raises ``NotImplementedError`` naming the
ROADMAP.md queue item that ports it; nothing runs silently by another
route.
"""

from __future__ import annotations

import functools

import torch

from sparsex_tpu.preprocess.encodings import EncType
from sparsex_tpu.preprocess.xform import run_step
from sparsex_tpu_torch.ops.fused import (add_products, add_totals,
                                         fused_delta_a1, fused_delta_e1s,
                                         fused_run_a1, fused_run_e1s,
                                         k1_style, k3_combine, merged_e1s,
                                         page_grid)

# table classes, extras and merged-plan parts of the reference executor ->
# where their port is queued in ROADMAP.md
_QUEUED = {
    "fs": "Queue 1 item 7 (partial segments)",
    "fblk": "Queue 1 item 10 (the fblk chain)",
    "blk": "Queue 1 item 10 (the fblk chain)",
    "bres": "Queue 1 item 7 (bres residuals)",
    "dpages": "Queue 1 item 10 (legacy paged delta)",
    "dpagesT": "Queue 1 item 8 (symmetric per-shard delta)",
    "dscatter": "Queue 1 item 10 (dscatter)",
    "dscatterT": "Queue 1 item 8 (symmetric per-shard scatter)",
    "dsfused": "Queue 1 item 13 (stacked sharded fused delta)",
}


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported to sparsex_tpu_torch yet; see ROADMAP.md "
        f"{item}")


def _kind(entry):
    """The execution class tag of a run/block entry (``cvt``, ``frun``,
    ``fblk``) or None for a plain table."""
    return entry[5][0] if len(entry) > 5 and entry[5] else None


def check_slice(meta) -> None:
    """Raise ``NotImplementedError`` unless the paged ``meta`` holds only
    what the port runs: fused delta and run segments with lane-placed K1
    styles, their merged plan, DIA tables riding K3, plain delta singles
    and plain (non-paged, non-routed) run tables."""
    if meta is None:
        _refuse("a matrix without a fused plan (plain-table DIA / delta / "
                "run / block kernels)", "Queue 1 item 3 (XLA-era classes)")
    _nr, _nc, run_meta, block_meta, dia_meta = meta[:5]
    extras = {e[0]: e[1:] for e in meta[5:] if e}
    for key in extras:
        if key not in ("dfused", "k3dias", "fall"):
            _refuse(f"the {key!r} execution class",
                    _QUEUED.get(key, "Queue 1"))
    if "dfused" in extras:
        fmeta = extras["dfused"][0]
        k1_style(fmeta[6] if len(fmeta) > 6 else "sl")
        if len(fmeta) > 7 and fmeta[7] is not None:
            k1_style(fmeta[7][0][3])
    n_frun = 0
    for e in run_meta:
        kind = _kind(e)
        if kind == "cvt":
            continue
        if kind == "frun":
            k1_style(e[5][1][5])
            n_frun += 1
            continue
        if kind is not None:
            _refuse(f"run table class {kind!r}", _QUEUED.get(kind, "Queue 1"))
        if len(e) > 3 and e[3]:
            _refuse("a paged run table (unit-page gather)",
                    "Queue 1 item 10 (paged_gather)")
        if len(e) > 4 and e[4]:
            scat = e[4][0] if isinstance(e[4][0], str) else "scatter"
            _refuse(f"a routed run table ({scat!r})",
                    _QUEUED.get(scat, "Queue 1 item 10 (apply_scatter_plan)"))
    for e in block_meta:
        kind = _kind(e)
        if kind == "cvt":
            continue
        if kind is not None:
            _refuse(f"block table class {kind!r}",
                    _QUEUED.get(kind, "Queue 1"))
        _refuse("a plain block table", "Queue 1 item 3 (block gathers)")
    if "dfused" not in extras and not n_frun:
        _refuse("a paged plan without a fused segment", "Queue 1 item 3")
    if "fall" in extras:
        segs, _inst, _bounds, res_desc = extras["fall"]
        for seg in segs:
            if seg[0] not in ("delta", "run"):
                _refuse(f"merged-plan segment {seg[0]!r}", _QUEUED[seg[0]])
        for rd in res_desc:
            if rd[0] not in ("dres", "rres"):
                _refuse(f"merged-plan residual {rd[0]!r}", _QUEUED[rd[0]])
    if dia_meta and "k3dias" not in extras:
        _refuse("plain-table DIA", "Queue 1 item 3 (dia_contrib)")


@functools.lru_cache(maxsize=64)
def _steps(width: int, step: int, device: str):
    """Column (or row) offsets ``step * [0, width)`` of a run's elements."""
    return torch.arange(width, device=device) * step


def _unit_totals(vals2d, cols_u, steps, x, ncols: int):
    """Per-unit run totals ``sum_j vals2d[u, j] * x[cols_u[u] + steps[j]]``,
    columns clamped to [0, ncols)."""
    return (vals2d * x[(cols_u[:, None] + steps).clamp(0, ncols - 1)]).sum(1)


def _run_steps(entry, device):
    """(row step, column offsets of a unit's elements) of a run table."""
    enc_i, delta, width = entry[:3]
    sr, sc = run_step(EncType(enc_i))
    return sr * delta, _steps(width, sc * delta, str(device))


def shared_page_grid(meta, x, ncols: int):
    """ONE padded page grid of x shared by every lane-placed K1 call,
    rounded to 8 pages so every window's q8 rounding divides it
    (kernels.py:320-331); None when the plan has no fused segment."""
    extras = {e[0] for e in meta[5:] if e}
    if "dfused" not in extras and not any(_kind(e) == "frun"
                                          for e in meta[2]):
        return None
    npages = -(-ncols // 1024)
    return page_grid(x, ncols, max(8, -(-npages // 8) * 8))


def merged_source(meta, arrs, x, ncols: int, x2f):
    """The merged (``fall``) plan's source grid (S, L): each segment's raw
    K1 output (the delta bulk and tail, or a fused run table), trimmed to
    its bound width (K1 outputs are padded to whole tile groups; the plan's
    bounds use the unpadded grids), concatenated in the plan's segment
    order (kernels.py:684-691)."""
    extras = {e[0]: e[1:] for e in meta[5:] if e}
    segs, _inst, bounds, _res = extras["fall"]
    fall_pieces = []
    for i, seg in enumerate(segs):
        if seg[0] == "delta":
            a1 = fused_delta_a1(extras["dfused"][0], arrs["fused"], x, ncols,
                                x2=x2f)
        else:
            a1 = fused_run_a1(meta[2][seg[1]][5][1],
                              arrs["runs"][seg[1]]["frun"], x, ncols, x2=x2f)
        fall_pieces.append(a1[: bounds[i + 1] - bounds[i]])
    return torch.cat(fall_pieces) if len(fall_pieces) > 1 else fall_pieces[0]


def local_contrib(meta, arrs, x, *, nrows_part: int, ncols: int):
    """The dense (nrows_part,) contribution of one partition: every fused
    segment's K1 (the delta bulk and tail, each fused run table), then
    either their per-segment T1 + K2 route instances or the merged plan's
    (per-instance G1 lane gather + T1 + K2), one K3 with every DIA table,
    the plain tables' adds and the residual and spill adds."""
    if x.dim() != 1:
        _refuse("this call (only the 1-D SpMV is ported)",
                "Queue 1 item 9 (SpMM)" if x.dim() == 2 else "Queue 1")
    run_meta = meta[2]
    extras = {e[0]: e[1:] for e in meta[5:] if e}
    dfused = extras.get("dfused")
    k3dias = extras.get("k3dias")
    fall = extras.get("fall")
    k3_pending = []       # (e1, g3, K, um3) instances for the shared K3
    k3_post = []          # residual adds after it
    acc = None            # the plain tables' adds, made before K3

    x2f = shared_page_grid(meta, x, ncols)
    if fall is not None:  # every fused segment's K1 feeds the merged plan
        k3_pending += merged_e1s(fall[1], arrs["fall"],
                                 merged_source(meta, arrs, x, ncols, x2f),
                                 nrows_part)
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

    d = arrs.get("delta")
    if d is not None and d["cols"].shape[0]:
        acc = add_products(torch.zeros(nrows_part, dtype=x.dtype,
                                       device=x.device),
                           d["vals"], d["cols"], d["row_ids"], x, ncols)

    for ri, (entry, t) in enumerate(zip(run_meta, arrs["runs"])):
        kind = _kind(entry)
        if kind == "cvt":  # demoted into the delta pipeline by the planner
            continue
        rstep, steps = _run_steps(entry, x.device)
        if kind == "frun":
            _, fmeta_r, n_tail = entry[5]
            fr = t["frun"]
            if fall is None:
                k3_pending += fused_run_e1s(fmeta_r, fr, x, ncols,
                                            nrows_part, x2=x2f)
                if fmeta_r[4]:   # over-capacity residual unit totals
                    k3_post.append(("acc", _unit_totals(
                        fr["res_vals2d"], fr["res_cols_u"], steps, x, ncols),
                        fr["res_dest"], None))
            if n_tail:           # unpageable tail units, in both modes
                k3_post.append(("acc", _unit_totals(
                    t["tail_vals"], t["tail_cols"], steps, x, ncols),
                    t["tail_rows"], None))
            continue
        # a plain run table: gather, multiply, scatter-add
        if acc is None:
            acc = torch.zeros(nrows_part, dtype=x.dtype, device=x.device)
        contrib = t["vals"] * x[(t["cols"][:, None] + steps).clamp(
            0, ncols - 1)]
        if rstep == 0:     # horizontal: one partial per unit
            add_totals(acc, contrib.sum(1), t["rows"])
        else:              # one destination row per element
            ridx = (t["rows"][:, None] + _steps(entry[2], rstep, str(
                x.device))).clamp(0, nrows_part - 1)
            add_totals(acc, contrib.reshape(-1), ridx.reshape(-1))

    if fall is not None:  # the merged plan's residuals (its e1s are queued)
        fa = arrs["fall"]
        for rd in fall[3]:
            if rd[0] == "dres":
                k3_post.append(("prod", fa["dres_vals"], fa["dres_cols"],
                                fa["dres_dest"]))
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
        acc = torch.zeros(nrows_part, dtype=x.dtype, device=x.device)
    for kind, a, b, c in k3_post:
        if kind == "prod":
            add_products(acc, a, b, c, x, ncols)
        else:
            add_totals(acc, a, b)
    return acc


__all__ = ["check_slice", "local_contrib", "merged_source",
           "shared_page_grid"]
