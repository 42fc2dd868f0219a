"""Upload of a shared planner's NumPy plan as device tensors ("weights
carried across").

``plan_to_torch`` takes the paged meta and arrays that
``sparsex_tpu.ops.exec.CsxExecutor._maybe_build_pages`` builds and returns
the tensors the executor reads, placed on ``device`` once.  Values take
the plan's value dtype; int8 wires and the packed K1 metadata stay as they
are; index streams of the torch gathers and residual adds become int64.
One array changes form on the way: for unmasked (``um & 1``) route
instances the planner bakes K2's batched-transpose lane offset into
``g2b`` (``fused._g2b_lane_offset``), which the CUDA K2 does not use, so
the offset is taken off again, in the delta pipeline's, each fused run
table's and the merged plan's instances.  The planner keeps raw um2 targets
below ``ceil8(A2R)`` (``route.py:274-281``), so
``raw = g2b - (c % _k2_gba(A2R)) * ceil8(A2R)`` is exact.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sparsex_tpu.ops.fused import L, _k2_gba
from sparsex_tpu_torch.ops.fused import lp_window

# index streams of the torch gathers and index_add_ residual adds
_INDEX_KEYS = frozenset((
    "res_cols", "res_dest", "left_rows", "left_cols",    # dfused / frun
    "res_cols_u", "tail_rows", "tail_cols",              # frun
    "rows", "cols", "row_ids",                           # plain tables
    "dres_cols", "dres_dest"))                           # fall


def _is_index(key: str) -> bool:
    return key in _INDEX_KEYS or (key.startswith("rres_")
                                  and key.endswith(("_cols", "_dest")))


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
    """(name, plo, q, npages) of every lane-placed K1 part of the plan: the
    delta bulk and tail, and each fused run table."""
    extras = {e[0]: e[1:] for e in pages_meta[5:] if e}
    parts = []
    if "dfused" in extras:
        fmeta, src = extras["dfused"][0], pages_arrays["fused"]
        parts.append(("fused plo", src["plo"], fmeta[1], fmeta[2]))
        if len(fmeta) > 7 and fmeta[7] is not None:
            (_T2, q2, npages2, _style2), _inter = fmeta[7]
            parts.append(("fused plo2", src["plo2"], q2, npages2))
    for ri, (entry, t) in enumerate(zip(pages_meta[2],
                                        pages_arrays.get("runs", ()))):
        if len(entry) > 5 and entry[5] and entry[5][0] == "frun":
            fmeta_r = entry[5][1]
            parts.append((f"run {ri} plo", t["frun"]["plo"], fmeta_r[1],
                          fmeta_r[2]))
    return parts


def _check_windows(pages_meta, pages_arrays) -> None:
    """Every K1 tile's window must lie inside the page grid that
    ``fused._k1_x2`` builds for its part, since the CUDA K1 reads it
    unchecked.  Every part is lane-placed (``lp`` or ``rlp{W}``):
    ``kernels.check_slice`` has refused any other style."""
    for name, plo, q, npages in _k1_parts(pages_meta, pages_arrays):
        q8, npages_pad = lp_window(q, npages)
        plo = np.asarray(plo)
        if plo.size and (plo.min() < 0 or (int(plo.max()) + 1) * q8
                         > npages_pad):
            raise ValueError(f"{name}: K1 windows outside the "
                             f"{npages_pad}-page grid")


def plan_to_torch(pages_meta, pages_arrays, device,
                  dtype: torch.dtype) -> Dict[str, object]:
    """Device tensors of the plan, with the reference's keys: ``fused``
    (the delta pipeline), ``runs`` (one dict per run table: ``{"frun":
    {...}}`` for a fused run table, the table itself for a plain one, ``{}``
    for a ``cvt`` one), ``fall`` (the merged plan), ``delta`` (plain delta
    singles, or None) and the K3 DIA grids.  ``g2b_{i}`` holds raw wires."""
    extras = {e[0]: e[1:] for e in pages_meta[5:] if e}
    _check_windows(pages_meta, pages_arrays)
    out: Dict[str, object] = {}
    if "dfused" in extras:
        out["fused"] = _upload_tree(pages_arrays["fused"], device, dtype,
                                    extras["dfused"][0][3])
    runs = []
    for entry, t in zip(pages_meta[2], pages_arrays.get("runs", ())):
        up = _upload_tree({k: v for k, v in t.items() if k != "frun"},
                          device, dtype)
        if "frun" in t:
            up["frun"] = _upload_tree(t["frun"], device, dtype,
                                      entry[5][1][3])
        runs.append(up)
    out["runs"] = runs
    if "fall" in extras:
        out["fall"] = _upload_tree(pages_arrays["fall"], device, dtype,
                                   extras["fall"][1])
    delta = pages_arrays.get("delta")
    out["delta"] = (None if delta is None
                    else _upload_tree(delta, device, dtype))
    for key in ("dias_fused_dv", "dias_fused_adv"):
        if pages_arrays.get(key) is not None:
            out[key] = _upload(np.asarray(pages_arrays[key]), device, dtype)
    return out
