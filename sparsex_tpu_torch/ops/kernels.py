"""One partition's SpMV contribution on PyTorch.

Counterpart of ``local_contrib`` (``sparsex_tpu/ops/kernels.py:259-736``),
ported for the fused slice only: the ``dfused`` branch (:332-351) with the
shared ``x2f`` page grid (:320-331), the shared K3 carrying the ``k3dias``
DIA tables (:718-726) and the residual ``k3_post`` adds (:727-734).  Every
other table class or extra raises ``NotImplementedError`` naming the
ROADMAP.md queue item that ports it; nothing runs silently by another
route.
"""

from __future__ import annotations

from sparsex_tpu_torch.ops.fused import (fused_delta_dia_apply, lp_only,
                                         page_grid)

# extras / table classes of the reference executor -> where their port is
# queued in ROADMAP.md
_QUEUED = {
    "fall": "Queue 1 items 3 and 7 (merged plan, blocky slice)",
    "frun": "Queue 1 items 3 and 7 (fused runs, blocky slice)",
    "fs": "Queue 1 items 3 and 7 (partial segments, blocky slice)",
    "fblk": "Queue 1 item 10 (the fblk chain)",
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


def check_slice(meta, arrays) -> None:
    """Raise ``NotImplementedError`` unless the paged ``meta`` holds only
    what the fused slice runs: a ``dfused`` delta pipeline (lane-placed K1)
    and DIA tables riding its K3."""
    if meta is None:
        _refuse("a matrix without a fused plan (plain-table DIA / delta / "
                "run / block kernels)", "Queue 1 item 3 (XLA-era classes)")
    _nr, _nc, run_meta, block_meta, dia_meta = meta[:5]
    extras = {e[0]: e[1:] for e in meta[5:] if e}
    for key in extras:
        if key not in ("dfused", "k3dias"):
            _refuse(f"the {key!r} execution class",
                    _QUEUED.get(key, "Queue 1"))
    if "dfused" not in extras:
        _refuse("a paged plan without the fused delta pipeline",
                "Queue 1 item 3")
    fmeta = extras["dfused"][0]
    lp_only(fmeta[6] if len(fmeta) > 6 else "sl")
    if len(fmeta) > 7 and fmeta[7] is not None:
        lp_only(fmeta[7][0][3])
    for e in run_meta:
        if not (len(e) > 5 and e[5] and e[5][0] == "cvt"):
            kind = e[5][0] if len(e) > 5 and e[5] else "plain run"
            _refuse(f"run table class {kind!r}",
                    _QUEUED.get(kind, "Queue 1 item 3 (run gathers)"))
    for e in block_meta:
        if not (len(e) > 5 and e[5] and e[5][0] == "cvt"):
            kind = e[5][0] if len(e) > 5 and e[5] else "plain block"
            _refuse(f"block table class {kind!r}",
                    _QUEUED.get(kind, "Queue 1 item 3 (block gathers)"))
    if dia_meta and "k3dias" not in extras:
        _refuse("plain-table DIA", "Queue 1 item 3 (dia_contrib)")
    if arrays.get("delta") is not None:
        _refuse("the plain delta table", "Queue 1 item 3 (segment_sum)")


def local_contrib(meta, arrs, x, *, nrows_part: int, ncols: int):
    """The dense (nrows_part,) contribution of one partition: K1 (bulk and
    tail) + T1 + K2 per route instance, one K3 with every DIA table, then
    the residual and spill adds, in place on K3's fresh output
    (:func:`~sparsex_tpu_torch.ops.fused.fused_delta_dia_apply` over one
    page grid of x shared by both K1 parts)."""
    extras = {e[0]: e[1:] for e in meta[5:] if e}
    dfused = extras.get("dfused")
    k3dias = extras.get("k3dias")
    if dfused is None or x.dim() != 1:
        _refuse("this call (only the 1-D fused SpMV is ported)",
                "Queue 1 item 9 (SpMM)" if x.dim() == 2 else "Queue 1")
    # ONE padded page grid of x shared by both K1 calls, rounded to 8
    # pages so every window's q8 rounding divides it (kernels.py:320-331)
    npages = -(-ncols // 1024)
    x2f = page_grid(x, ncols, max(8, -(-npages // 8) * 8))
    dia_offs, anti_offs = k3dias if k3dias is not None else ((), ())
    pack = (dia_offs, arrs.get("dias_fused_dv"), anti_offs,
            arrs.get("dias_fused_adv"))
    return fused_delta_dia_apply(dfused[0], arrs["fused"], pack, x,
                                 nrows_part, ncols, x2=x2f)


__all__ = ["check_slice", "local_contrib"]
