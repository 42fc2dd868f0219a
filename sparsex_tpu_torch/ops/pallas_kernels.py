"""The standalone DIA kernel and the legacy paged gathers on PyTorch.

Counterpart of ``sparsex_tpu/ops/pallas_kernels.py``: its three Pallas
kernels are the CUDA kernels of ``csrc/dia.cu`` (``_build_dia_kernel``) and
``csrc/pages.cu`` (``_build_delta_kernel``, ``_build_gather_kernel``).  The
host planners (``build_delta_pages``, ``build_unit_pages``) are the
reference's own; only the device half is ported:

- three kernel wrappers, ``dia``, ``delta_pages`` and ``gather``, each
  launching its CUDA kernel on a CUDA tensor and running its plain PyTorch
  version (``dia_plain``, ``delta_pages_plain``, ``gather_plain``) only on
  a CPU tensor; each launch adds one to ``ops.fused.launches`` under
  ``dia``, ``delta_pages`` and ``paged_gather``;
- the host-side functions with the reference's names: ``pad_x_pages``,
  ``dia_spmv`` (``dia_spmv_pallas``'s ``pad_lo`` / ``xp_len`` framing, in
  ``dia_frame``), ``delta_pages_products``, ``delta_pages_spmv``,
  ``paged_gather`` and ``paged_gather_grid``.

The reference runs these kernels in float32 only (``pallas_dtype_ok``:
Mosaic tiles are f32) and hands more than ``MAX_DIAGS_PALLAS`` = 64
diagonals to an XLA window sum; the port runs them in float32 and float64
and the DIA kernel takes any number of diagonals.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from sparsex_tpu.ops.pallas_kernels import DELTA_TILE, PAGE, TILE, _ceil_to
from sparsex_tpu_torch.ops.fused import (L, _check, _launch, _offsets_tensor,
                                         _route, _stream, _value_dtype,
                                         page_grid)


# ---------------------------------------------------------------------------
# the standalone DIA kernel
# ---------------------------------------------------------------------------

def dia_plain(dv, xp, offsets, pad_lo: int):
    """``y[r] = sum_k dv[k, r] * xp[r + offsets[k] + pad_lo]`` for r in
    [0, dv.shape[1]), summed from 0 in k order, multiply then add
    (``pallas_kernels.py:_build_dia_kernel``)."""
    n = dv.shape[1]
    y = torch.zeros(n, dtype=dv.dtype, device=dv.device)
    for k, o in enumerate(offsets):
        s = int(o) + pad_lo
        y = y + dv[k] * xp[s: s + n]
    return y


def dia(dv, xp, offsets: Sequence[int], pad_lo: int):
    """The DIA kernel over ``dv`` (D, nrows) and the padded x frame ``xp``;
    returns (nrows,).  Every window ``xp[o + pad_lo:][:nrows]`` must lie
    inside ``xp``."""
    _value_dtype("dv", dv)
    if dv.dim() != 2 or dv.shape[0] != len(offsets):
        raise ValueError(f"dv: shape {tuple(dv.shape)}, expected "
                         f"({len(offsets)}, nrows)")
    dev = dv.device
    _check("dv", dv)
    _check("xp", xp, dv.dtype, None, dev)
    D, n = dv.shape
    starts = tuple(int(o) + pad_lo for o in offsets)
    if xp.dim() != 1 or (D and n and (min(starts) < 0 or max(starts) + n
                                      > xp.shape[0])):
        raise ValueError(f"xp: shape {tuple(xp.shape)} does not hold every "
                         f"window of {n} rows at {starts}")
    if _route(dev) == "cpu":
        return dia_plain(dv, xp, offsets, pad_lo)
    y = torch.empty(n, dtype=dv.dtype, device=dev)
    off = _offsets_tensor(starts, str(dev)) if D else None
    _launch("dia", dv.dtype, dv.data_ptr(), xp.data_ptr(),
            None if off is None else off.data_ptr(), D, n, y.data_ptr(),
            _stream(dev))
    return y


def dia_frame(offsets: Sequence[int], x, nrows_part: int, ncols: int):
    """``(xp, pad_lo)``: x in ``dia_spmv_pallas``'s zero-padded frame
    (pallas_kernels.py:494-503): ``pad_lo`` zeros in front, whole
    32,768-row tiles, ``xp_len`` long, so x outside [0, ncols) reads 0."""
    nrows_pad = _ceil_to(max(nrows_part, 1), TILE)
    pad_lo = _ceil_to(max(0, -min(offsets)), TILE)
    q_max = max((int(o) + pad_lo) // TILE for o in offsets)
    xp_len = max(_ceil_to(ncols + pad_lo, TILE),
                 (nrows_pad // TILE + q_max + 2) * TILE)
    return F.pad(x[:ncols], (pad_lo, xp_len - pad_lo - ncols)), pad_lo


def dia_spmv(offsets: Sequence[int], dv, x, nrows_part: int, ncols: int):
    """Fused multi-diagonal SpMV partial ``y[r] = sum_k dv[k, r] * x[r +
    o_k]`` (``dia_spmv_pallas``, pallas_kernels.py:484-510) over
    :func:`dia_frame`.  The kernel computes the ``nrows_part`` rows
    directly, where the Pallas kernel pads dv to whole tiles and trims
    y."""
    offsets = tuple(int(o) for o in offsets)
    xp, pad_lo = dia_frame(offsets, x, nrows_part, ncols)
    return dia(dv, xp, offsets, pad_lo)


# ---------------------------------------------------------------------------
# the page-bucketed delta product and the unit-page gather
# ---------------------------------------------------------------------------

def _window_x(plo, sl, x2, q: int):
    """``x2flat[plo[t] * 1024 + sl[t, s, l]]``, 0 where ``sl`` is outside
    [0, q * 1024) (the Pallas kernels' selects match no page there)."""
    s = sl.to(torch.int64)
    ok = (s >= 0) & (s < q * PAGE)
    idx = plo.to(torch.int64).view(-1, 1, 1) * PAGE + torch.where(ok, s, 0)
    zero = torch.zeros((), dtype=x2.dtype, device=x2.device)
    return torch.where(ok, x2.reshape(-1)[idx], zero)


def delta_pages_plain(plo, sl, vals, x2, q: int):
    """``out[t,s,l] = x2flat[plo[t]*1024 + sl[t,s,l]] * vals[t,s,l]``
    (``pallas_kernels.py:_build_delta_kernel``)."""
    return _window_x(plo, sl, x2, q) * vals


def gather_plain(plo, sl, x2, q: int):
    """``out[t,s,l] = x2flat[plo[t]*1024 + sl[t,s,l]]``
    (``pallas_kernels.py:_build_gather_kernel``)."""
    return _window_x(plo, sl, x2, q)


def _check_pages(plo, sl, x2, q: int, sl_dtypes, dev) -> int:
    """Check a paged kernel's window arguments; returns the tile count."""
    if plo.dim() != 1:
        raise ValueError(f"plo: shape {tuple(plo.shape)}, expected (T,)")
    T = plo.shape[0]
    _check("plo", plo, torch.int32, None, dev)
    if sl.dtype not in sl_dtypes:
        raise TypeError(f"sl: dtype {sl.dtype}, expected one of "
                        f"{sorted(map(str, sl_dtypes))}")
    _check("sl", sl, None, (T, 8, L), dev)
    _check("x2", x2, None, None, dev)
    if x2.dim() != 3 or tuple(x2.shape[1:]) != (8, L) or x2.shape[0] < q:
        raise ValueError(f"x2: shape {tuple(x2.shape)} is not a page grid "
                         f"of at least q={q} pages")
    return T


def delta_pages(plo, sl, vals, x2, q: int):
    """The delta-pages product over a (T, 8, 128) tile stream: ``plo`` (T,)
    int32 window starts, ``sl`` int16 window offsets, ``x2`` the padded
    page grid (``pad_x_pages``).  The windows must lie inside ``x2``
    (``ops/convert.py`` checks the plan's)."""
    _value_dtype("vals", vals)
    dev = vals.device
    T = _check_pages(plo, sl, x2, q, (torch.int16,), dev)
    _check("vals", vals, None, (T, 8, L), dev)
    _check("x2", x2, vals.dtype)
    if _route(dev) == "cpu":
        return delta_pages_plain(plo, sl, vals, x2, q)
    out = torch.empty_like(vals)
    _launch("delta_pages", vals.dtype, plo.data_ptr(), sl.data_ptr(),
            vals.data_ptr(), x2.data_ptr(), out.data_ptr(), T, q,
            _stream(dev))
    return out


def gather(plo, sl, x2, q: int):
    """The unit-page gather over a (T, 8, 128) tile stream, ``sl`` int16 or
    int32; returns (T, 8, 128) x values."""
    _value_dtype("x2", x2)
    dev = x2.device
    T = _check_pages(plo, sl, x2, q, (torch.int16, torch.int32), dev)
    if _route(dev) == "cpu":
        return gather_plain(plo, sl, x2, q)
    out = torch.empty((T, 8, L), dtype=x2.dtype, device=dev)
    _launch("paged_gather", x2.dtype, plo.data_ptr(), sl.data_ptr(),
            x2.data_ptr(), out.data_ptr(), T, q, sl.element_size(),
            _stream(dev))
    return out


def pad_x_pages(x, ncols: int, q: int, npages: int):
    """x zero-padded to (max(npages, q), 8, 128) page form; callers with
    several paged tables build it once with the max q / npages of their
    plans (pallas_kernels.py:290)."""
    return page_grid(x, ncols, max(npages, q))


def delta_pages_products(rep_meta, rep, x, ncols: int, x2=None):
    """(T*1024,) products (value * gathered x) in tile order."""
    _T, q, npages = rep_meta
    if x2 is None:
        x2 = pad_x_pages(x, ncols, q, npages)
    return delta_pages(rep["plo"], rep["sl"], rep["vals"], x2, q).reshape(-1)


def delta_pages_spmv(rep_meta, rep, x, nrows_part: int, ncols: int, acc,
                     x2=None):
    """``acc[rows] += products`` for the page-bucketed delta elements, in
    place.  Padding slots carry ``vals = 0``, ``sl = 0`` and the sentinel
    row ``nrows_part``, which the reference drops (``mode="drop"``): here
    ``acc`` holds ``nrows_part + 1`` values and its last one takes them, so
    no index is clamped and no product masked."""
    if acc.shape[0] != nrows_part + 1:
        raise ValueError(f"acc: {acc.shape[0]} values, expected nrows_part "
                         f"+ 1 = {nrows_part + 1}")
    prods = delta_pages_products(rep_meta, rep, x, ncols, x2=x2)
    return acc.index_add_(0, rep["rows"], prods)


def paged_gather(plan_meta, plan, x, ncols: int, W: int, x2=None):
    """Gathered x for the pageable prefix: (T*g, W) (pallas_kernels.py:446);
    each tile's first g*W values are its g units."""
    T, q, g, _npages = plan_meta
    out = paged_gather_grid(plan_meta, plan, x, ncols, x2=x2)
    return out.reshape(T, DELTA_TILE)[:, : g * W].reshape(T * g, W)


def paged_gather_grid(plan_meta, plan, x, ncols: int, x2=None):
    """Gathered x in raw (T, 8, 128) grid form (element / tile order)."""
    _T, q, _g, npages = plan_meta
    if x2 is None:
        x2 = pad_x_pages(x, ncols, q, npages)
    return gather(plan["plo"], plan["sl"], x2, q)


__all__ = [
    "dia", "dia_plain", "dia_frame", "dia_spmv", "delta_pages",
    "delta_pages_plain",
    "gather", "gather_plain", "pad_x_pages", "delta_pages_products",
    "delta_pages_spmv", "paged_gather", "paged_gather_grid",
]
