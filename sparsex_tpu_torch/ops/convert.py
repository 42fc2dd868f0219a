"""Upload of a shared planner's NumPy plan as device tensors ("weights
carried across").

``plan_to_torch`` takes the paged meta and arrays that
``sparsex_tpu.ops.exec.CsxExecutor._maybe_build_pages`` builds and returns
the tensors the fused slice reads, placed on ``device`` once.  Values take
the plan's value dtype; int8 wires stay int8; index streams of the residual
adds become int64.  One array changes form on the way: for unmasked
(``um & 1``) route instances the planner bakes K2's batched-transpose lane
offset into ``g2b`` (``fused._g2b_lane_offset``), which the CUDA K2 does not
use, so the offset is taken off again.  The planner keeps raw um2 targets
below ``ceil8(A2R)`` (``route.py:274-281``), so
``raw = g2b - (c % _k2_gba(A2R)) * ceil8(A2R)`` is exact.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sparsex_tpu.ops.fused import L, _k2_gba
from sparsex_tpu_torch.ops.fused import lp_window

_INDEX_KEYS = ("res_cols", "res_dest", "left_rows", "left_cols")


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


def _check_windows(fmeta, src) -> None:
    """Every K1 tile's window must lie inside the page grid that
    ``fused._k1_x2`` builds for its part, since the CUDA K1 reads it
    unchecked.  Both parts are ``lp``: ``kernels.check_slice`` has refused
    any other style."""
    parts = [("plo", fmeta[1], fmeta[2])]
    if len(fmeta) > 7 and fmeta[7] is not None:
        (_T2, q2, npages2, _style2), _inter = fmeta[7]
        parts.append(("plo2", q2, npages2))
    for key, q, npages in parts:
        q8, npages_pad = lp_window(q, npages)
        plo = np.asarray(src[key])
        if plo.size and (plo.min() < 0 or (int(plo.max()) + 1) * q8
                         > npages_pad):
            raise ValueError(f"{key}: K1 windows outside the "
                             f"{npages_pad}-page grid")


def plan_to_torch(pages_meta, pages_arrays, device,
                  dtype: torch.dtype) -> Dict[str, object]:
    """Device tensors of the fused slice's plan: ``{"fused": {...},
    "dias_fused_dv": ..., "dias_fused_adv": ...}`` with the reference's
    keys (``g2b_{i}`` holds raw wires)."""
    extras = {e[0]: e[1:] for e in pages_meta[5:] if e}
    out: Dict[str, object] = {}
    if "dfused" in extras:
        fmeta = extras["dfused"][0]
        src = pages_arrays["fused"]
        fused: Dict[str, torch.Tensor] = {}
        for key, a in src.items():
            if key.startswith("_"):
                continue                  # host-only planner stashes
            a = np.asarray(a)
            if key.startswith("g2b_"):
                um = fmeta[3][int(key[4:])][9]
                if um & 1:
                    a = g2b_raw(a, fmeta[3][int(key[4:])][2])
            if a.dtype.kind == "f":
                fused[key] = _upload(a, device, dtype)
            elif key in _INDEX_KEYS:
                fused[key] = _upload(a, device, torch.int64)
            else:
                fused[key] = _upload(a, device)
        out["fused"] = fused
        _check_windows(fmeta, src)
    for key in ("dias_fused_dv", "dias_fused_adv"):
        if pages_arrays.get(key) is not None:
            out[key] = _upload(np.asarray(pages_arrays[key]), device, dtype)
    return out
