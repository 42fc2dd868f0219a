"""The standalone DIA kernel and the legacy paged gathers on PyTorch.

Counterpart of ``sparsex_tpu/ops/pallas_kernels.py``: its three Pallas
kernels are the CUDA kernels of ``csrc/dia.cu`` (``_build_dia_kernel``) and
``csrc/pages.cu`` (``_build_delta_kernel``, ``_build_gather_kernel``), and
its host planners are the port's own copies (``build_delta_pages``,
``build_unit_pages``, unchanged NumPy):

- five kernel wrappers, ``dia``, ``delta_pages``, ``delta_pages_acc``,
  ``gather`` and ``paged_units``, each launching its CUDA kernel on a CUDA
  tensor and running its plain PyTorch version (``dia_plain``,
  ``delta_pages_plain``, ``delta_pages_acc_plain``, ``gather_plain``,
  ``paged_units_plain``) only on a CPU tensor; each launch adds one to
  ``ops.fused.launches`` under ``dia``, ``delta_pages``,
  ``delta_pages_acc``, ``paged_gather`` and ``paged_units``.
  ``delta_pages_acc`` is the delta-pages product with the scatter-add
  that the reference runs in XLA after it (``delta_pages_spmv``)
  folded into the kernel, and ``paged_units`` the unit-page gather fused
  with the multiply and the per-unit sums that the reference's executor
  runs in XLA around it (kernels.py:471-491, :570-588, :647-665);
- the host-side functions with the reference's names: ``pad_x_pages``
  (over ``page_grid``), ``dia_spmv`` (``dia_spmv_pallas``'s ``pad_lo`` /
  ``xp_len`` framing, in ``dia_frame``), ``delta_pages_products``,
  ``delta_pages_spmv`` and ``paged_gather_grid``.

The reference runs these kernels in float32 only (``pallas_dtype_ok``:
Mosaic tiles are f32) and hands more than 64 diagonals to an XLA window
sum; the port runs them in float32 and float64 and the DIA kernel takes any
number of diagonals.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sparsex_tpu_torch.ops._launch import (L, _check, _launch,
                                           _offsets_tensor, _route, _stream,
                                           _value_dtype)
from sparsex_tpu_torch.timing import planner

TILE = 32 * 1024  # rows per DIA tile of the reference (its x frame's unit)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# host planners (copied from sparsex_tpu/ops/pallas_kernels.py:115-231,
# :329-385): the page-bucketed delta layout and the unit-page gather plan
# ---------------------------------------------------------------------------

PAGE = 1024           # x elements per page = one f32 VREG tile
DELTA_TILE = 1024     # elements per kernel tile = (8, 128)
MAX_Q = 8             # max contiguous pages one tile may span
MIN_PAGE_NNZ = 1 << 14  # below this the XLA gather is cheaper than a plan


@planner(lambda out: out[0] is None)
def build_delta_pages(cols: np.ndarray, rows: np.ndarray, vals: np.ndarray,
                      ncols: int, nrows_part: int, q_force: int = 0,
                      t_force: int = 0, sort_key=None, group_ids=None):
    """Host-side layout for the page-bucketed delta kernel.

    Returns (pages_rep, leftover_idx) where ``pages_rep`` is None when the
    layout isn't applicable; ``leftover_idx`` indexes elements whose tile
    would span more than MAX_Q pages (they stay on the XLA path).

    ``q_force``/``t_force`` pad the window width / tile count up to a given
    value (>= the computed ones) — the sharded executor uses this to give
    every shard the same static kernel signature.  ``sort_key`` overrides
    the element ordering (default: by column); pass
    ``route.fold_sort_key`` so the scatter-route planner can size its
    instances per capacity fold.
    """
    m = cols.size
    if m < MIN_PAGE_NNZ:
        return None, None
    order = np.argsort(cols if sort_key is None else sort_key,
                       kind="stable")
    npages = -(-ncols // PAGE)

    # Vectorized tiling (the old per-tile Python loop dominated pt on
    # large matrices): optional group labels partition the sorted stream
    # into tile-aligned segments (the fused route pipeline aligns chunk
    # folds to product tiles this way); each group's elements fill
    # DELTA_TILE-sized tiles, ragged tails padded.
    if group_ids is None:
        el_tile = np.arange(m, dtype=np.int64) // DELTA_TILE
        lane = np.arange(m, dtype=np.int64) % DELTA_TILE
    else:
        g = np.asarray(group_ids)[order]
        # group start positions in the sorted stream (caller's sort_key
        # must make groups contiguous)
        new_grp = np.empty(m, dtype=bool)
        new_grp[0] = True
        np.not_equal(g[1:], g[:-1], out=new_grp[1:])
        starts = np.flatnonzero(new_grp)
        gi = np.cumsum(new_grp) - 1                    # dense group index
        pos_in_grp = np.arange(m, dtype=np.int64) - starts[gi]
        sizes = np.diff(np.append(starts, m))
        tiles_per_grp = -(-sizes // DELTA_TILE)
        tile_base = np.concatenate(
            [[0], np.cumsum(tiles_per_grp)[:-1]])
        el_tile = tile_base[gi] + pos_in_grp // DELTA_TILE
        lane = pos_in_grp % DELTA_TILE

    csort = cols[order].astype(np.int64)
    pages = csort // PAGE
    # per-tile page span via reduceat (el_tile is nondecreasing; every
    # tile index in [0, T_all) is hit because groups fill tiles densely)
    tile_starts = np.flatnonzero(
        np.concatenate([[True], el_tile[1:] != el_tile[:-1]]))
    T_all = int(el_tile[-1]) + 1
    pmin = np.minimum.reduceat(pages, tile_starts)
    pmax = np.maximum.reduceat(pages, tile_starts)
    span = pmax - pmin + 1
    keepm = span <= MAX_Q

    keep_el = keepm[el_tile]
    kept_pos = np.flatnonzero(keep_el)
    if kept_pos.size < max(m // 2, 1):
        return None, None
    leftover_idx = order[~keep_el]

    kt = np.flatnonzero(keepm)
    T = kt.size
    q = int(span[kt].max())
    q = max(q, q_force)
    # clamp p_lo so the Q-page window stays inside x2; t_force pads with
    # all-zero dummy tiles (vals 0, rows = sentinel -> dropped)
    newt_of_tile = np.cumsum(keepm) - 1                # tile -> kept index
    plo_kept = np.minimum(pmin[kt],
                          max(0, npages - q)).astype(np.int32)
    T_out = max(T, t_force)
    plo_arr = np.zeros(T_out, dtype=np.int32)
    plo_arr[:T] = plo_kept
    # combined window offset sl = sub*128 + lane (< q*1024 <= 8192): ONE
    # int16 stream instead of separate sub/lane arrays — the delta path is
    # bandwidth-bound metadata (the reference picks 8/16/32-bit deltas for
    # the same reason, GetDeltaSize CsxManager.hpp:635-682).  q <= 8 so
    # the offset always fits int16; kernels upcast at load.
    sl = np.zeros((T_out, DELTA_TILE), dtype=np.int16)
    v = np.zeros((T_out, DELTA_TILE), dtype=vals.dtype)
    r = np.full((T_out, DELTA_TILE), nrows_part, dtype=np.int32)
    sel = order[kept_pos]
    ti = newt_of_tile[el_tile[kept_pos]]
    la = lane[kept_pos]
    sl[ti, la] = (csort[kept_pos]
                  - plo_arr[ti].astype(np.int64) * PAGE).astype(np.int16)
    v[ti, la] = vals[sel]
    r[ti, la] = rows[sel]
    rep = {
        "plo": plo_arr,
        "sl": sl.reshape(T_out, 8, 128),
        "vals": v.reshape(T_out, 8, 128),
        "rows": r.reshape(T_out * DELTA_TILE),
        "q": int(q),
        "npages": int(npages),
    }
    if group_ids is not None:
        # per kept tile: its group label (t_force dummy tiles get -1);
        # the fused route planner cuts chunks at group boundaries
        tg = np.full(T_out, -1, dtype=np.int64)
        tg[:T] = np.asarray(group_ids)[order[tile_starts[kt]]]
        rep["tile_group"] = tg
    return rep, leftover_idx


@planner(lambda out: out[2] is None)
def build_unit_pages(flat_cols: np.ndarray, W: int, ncols: int,
                     q_force: int = 0, min_elems: int = 1 << 13):
    """Plan a paged gather for a (U, W) column-index table.

    ``flat_cols``: (U*W,) the x indices unit-major (already clipped to
    [0, ncols)).  Returns (unit_order, n_pageable_units, plan) where
    ``plan`` is None if not applicable; units [0, n_pageable) of the
    reordered table are gathered by the kernel, the rest via a clipped gather.
    ``q_force`` pads the page-window width (the sharded executor unifies
    signatures across shards with it).
    """
    M = flat_cols.size
    U = M // W
    if U * W != M or M < min_elems or W > DELTA_TILE:
        return None, 0, None
    g = max(1, DELTA_TILE // W)  # units per tile
    cu = flat_cols.reshape(U, W)
    # order units by their min column so tiles cluster into few pages
    umin = cu.min(axis=1)
    umax = cu.max(axis=1)
    order = np.argsort(umin, kind="stable")
    npages = -(-ncols // PAGE)

    pageable, spilled = [], []
    for t0 in range(0, U, g):
        t1 = min(U, t0 + g)
        sel = order[t0:t1]
        p_lo = int(umin[sel].min() // PAGE)
        p_hi = int(umax[sel].max() // PAGE)
        if p_hi - p_lo + 1 <= MAX_Q and t1 - t0 == g:
            pageable.append((sel, p_lo))
        else:
            spilled.append(sel)
    if not pageable or len(pageable) * g < U // 2:
        return None, 0, None

    T = len(pageable)
    q = max(int(umax[sel].max() // PAGE) - plo + 1
            for sel, plo in pageable)
    q = max(q, q_force)
    sl = np.zeros((T, DELTA_TILE), dtype=np.int32)
    plo_arr = np.zeros(T, dtype=np.int32)
    unit_order = np.concatenate(
        [np.concatenate([sel for sel, _ in pageable])]
        + ([np.concatenate(spilled)] if spilled else []))
    for ti, (sel, plo) in enumerate(pageable):
        plo = min(plo, max(0, npages - q))
        plo_arr[ti] = plo
        off = (cu[sel].reshape(-1) - plo * PAGE).astype(np.int64)
        n = off.size  # g * W
        sl[ti, :n] = off.astype(np.int32)
    plan = {
        "plo": plo_arr,
        "sl": sl.reshape(T, 8, 128),
        "T": T, "q": int(q), "g": int(g), "npages": int(npages),
    }
    return unit_order, T * g, plan




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

def window_index(plo, sl, q: int):
    """``(idx, ok)``: the flat page-grid index ``plo[t] * 1024 + sl[t, s,
    l]`` each slot reads, and whether ``sl`` lies in [0, q * 1024) (the
    Pallas kernels' selects match no page outside); ``idx`` is clamped to
    the window's start where ``ok`` is False."""
    s = sl.to(torch.int64)
    ok = (s >= 0) & (s < q * PAGE)
    idx = plo.to(torch.int64).view(-1, 1, 1) * PAGE + torch.where(ok, s, 0)
    return idx, ok


def _window_x(plo, sl, x2, q: int):
    """``x2flat[plo[t] * 1024 + sl[t, s, l]]``, 0 outside the window."""
    idx, ok = window_index(plo, sl, q)
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


def _check_delta(plo, sl, vals, x2, q: int) -> int:
    """Check the delta kernels' common arguments; returns the tile count."""
    _value_dtype("vals", vals)
    dev = vals.device
    T = _check_pages(plo, sl, x2, q, (torch.int16,), dev)
    _check("vals", vals, None, (T, 8, L), dev)
    _check("x2", x2, vals.dtype)
    return T


def delta_pages(plo, sl, vals, x2, q: int):
    """The delta-pages product over a (T, 8, 128) tile stream: ``plo`` (T,)
    int32 window starts, ``sl`` int16 window offsets, ``x2`` the padded
    page grid (``pad_x_pages``).  The windows must lie inside ``x2``
    (``ops/convert.py`` checks the plan's).  The kernel reads a thread's
    offsets (4 in f32, 2 in f64) as one vector and its values as 16 bytes
    and writes its products with one 16-byte store: on the card an ``sl``
    off that vector's boundary, ``vals`` off 16 bytes, or q outside 1..16
    raises (CUDA error 1)."""
    T = _check_delta(plo, sl, vals, x2, q)
    if _route(vals.device) == "cpu":
        return delta_pages_plain(plo, sl, vals, x2, q)
    out = torch.empty_like(vals)
    _launch("delta_pages", vals.dtype, plo.data_ptr(), sl.data_ptr(),
            vals.data_ptr(), x2.data_ptr(), out.data_ptr(), T, q,
            _stream(vals.device))
    return out


def delta_pages_acc_plain(plo, sl, vals, x2, q: int, acc, rows):
    """``acc[rows] += delta_pages_plain(...)`` in place, rows outside [0,
    len(acc)) dropped (the padding slots' sentinel row); returns ``acc``."""
    return add_totals(acc, delta_pages_plain(plo, sl, vals, x2, q).reshape(-1),
                      rows)


def delta_pages_acc(plo, sl, vals, x2, q: int, acc, rows):
    """The delta-pages product with its scatter epilogue: each product added
    into ``acc[rows[e]]`` (``rows`` int32, one per slot; rows outside [0,
    len(acc)) dropped) by the kernel itself, with atomic adds in no fixed
    order, as CUDA's ``index_add_`` makes them; returns ``acc``.  The
    products never reach memory.  On the card ``rows`` off its vector
    boundary (16 bytes in f32, 8 in f64) raises as :func:`delta_pages`'s
    operands do."""
    T = _check_delta(plo, sl, vals, x2, q)
    dev = vals.device
    _check("acc", acc, vals.dtype, (acc.shape[0],), dev)
    _check("rows", rows, torch.int32, (T * PAGE,), dev)
    if _route(dev) == "cpu":
        return delta_pages_acc_plain(plo, sl, vals, x2, q, acc, rows)
    _launch("delta_pages_acc", vals.dtype, plo.data_ptr(), sl.data_ptr(),
            vals.data_ptr(), x2.data_ptr(), rows.data_ptr(), acc.data_ptr(),
            acc.shape[0], T, q, _stream(dev))
    return acc


def gather(plo, sl, x2, q: int):
    """The unit-page gather over a (T, 8, 128) tile stream, ``sl`` int16 or
    int32, 1 <= q <= 16; returns (T, 8, 128) x values.  The kernel reads a
    thread's offsets (4 in f32, 2 in f64) as one vector and writes its
    values with one 16-byte store: on the card an ``sl`` off that vector's
    boundary, or q outside 1..16, raises (CUDA error 1)."""
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


def _unit_form(vals, each: bool):
    """``(R, C, SU)`` of a unit table's values: each unit's R partials, each
    a sum of C products, over SU window slots: a (Up, W) run table gives
    (1, W, W) or, ``each``, its W products unsummed (W, 1, W); a (Up, br,
    bc) block table (br, bc, bc)."""
    if vals.dim() == 3:
        if each:
            raise ValueError("each: a block table's partials are row sums")
        return vals.shape[1], vals.shape[2], vals.shape[2]
    if vals.dim() != 2:
        raise ValueError(f"vals: shape {tuple(vals.shape)} is neither (U, W) "
                         "nor (U, br, bc)")
    W = vals.shape[1]
    return (W, 1, W) if each else (1, W, W)


def add_totals(acc, totals, dest):
    """``acc[dest] += totals`` in place, destinations outside [0, len(acc))
    dropped — the reference's ``.at[dest].add(..., mode="drop")``.  A
    k-major acc (k, n) takes (k, m) totals along its last axis."""
    n = acc.shape[-1]
    ok = (dest >= 0) & (dest < n)
    totals = torch.where(ok, totals, torch.zeros((), dtype=totals.dtype,
                                                  device=totals.device))
    return acc.index_add_(acc.dim() - 1, dest.clamp(0, n - 1), totals)


def paged_units_plain(plo, sl, vals, x2, q: int, each: bool = False,
                      acc=None, dest=None):
    """The partials of the pageable prefix of a paged run or block table
    (``kernels.py:570-588``, :647-665 over ``paged_gather``): tile t's
    slots ``[u*SU, (u+1)*SU)`` hold unit ``t*g + u``'s window offsets, g =
    1024 // SU, and ``vals`` holds the T*g units in the same order.  A
    (Up, W) run table gives ``sum_j vals[u, j] * x[u, j]`` (Up,), or the
    products (Up, W) when ``each`` (a diagonal or anti-diagonal run writes W
    rows); a (Up, br, bc) block table ``sum_c vals[u, r, c] * x[u, c]``
    (Up, br).  Sums run left to right from 0, as the CUDA kernel's do.
    With ``acc``: ``add_totals(acc, partials, dest)``, ``dest`` the
    partials' destination rows, flat; returns ``acc``."""
    R, C, SU = _unit_form(vals, each)
    T = plo.shape[0]
    g = PAGE // SU
    xs = _window_x(plo, sl, x2, q).reshape(T, PAGE)[:, : g * SU]
    if each:
        out = xs.reshape(T * g, SU) * vals
    else:
        xs = xs.reshape(T * g, 1, C)
        v = vals.reshape(T * g, R, C)
        out = torch.zeros((T * g, R), dtype=vals.dtype, device=vals.device)
        for c in range(C):
            out = out + v[..., c] * xs[..., c]
        out = out.reshape(vals.shape[:-1])
    return out if acc is None else add_totals(acc, out.reshape(-1), dest)


def paged_units(plo, sl, vals, x2, q: int, each: bool = False, acc=None,
                dest=None):
    """The unit-page gather, the multiply by ``vals`` and the per-unit sums
    of :func:`paged_units_plain` in one kernel; ``sl`` int16 or int32,
    ``vals`` the table's first T*g units, contiguous.  With ``acc`` (n,)
    and ``dest`` (int64, one row per partial) the kernel adds each partial
    into ``acc[dest]`` itself (atomic adds, in no fixed order, as CUDA's
    ``index_add_`` makes them; rows outside [0, n) dropped) and returns
    ``acc``.  The windows must lie inside ``x2`` (``ops/convert.py``
    checks the plan's)."""
    _value_dtype("vals", vals)
    dev = vals.device
    T = _check_pages(plo, sl, x2, q, (torch.int16, torch.int32), dev)
    R, C, SU = _unit_form(vals, each)
    g = PAGE // SU
    if not 1 <= SU <= PAGE or vals.shape[0] != T * g:
        raise ValueError(f"vals: {vals.shape[0]} units of {SU} slots, "
                         f"expected T*g = {T}*{g}")
    _check("vals", vals)
    _check("x2", x2, vals.dtype)
    if acc is not None:
        _check("acc", acc, vals.dtype, (acc.shape[0],), dev)
        _check("dest", dest, torch.int64, (T * g * R,), dev)
    if _route(dev) == "cpu":
        return paged_units_plain(plo, sl, vals, x2, q, each, acc, dest)
    out = acc
    if acc is None:
        out = torch.empty(vals.shape if each else vals.shape[:-1],
                          dtype=vals.dtype, device=dev)
    _launch("paged_units", vals.dtype, plo.data_ptr(), sl.data_ptr(),
            vals.data_ptr(), x2.data_ptr(),
            None if acc is not None else out.data_ptr(),
            None if acc is None else acc.data_ptr(),
            None if acc is None else dest.data_ptr(),
            0 if acc is None else acc.shape[0], T, q, sl.element_size(), R,
            C, 1 if each else 0, SU, g, _stream(dev))
    return out


def page_grid(x, ncols: int, npages: int):
    """x as an (npages, 8, L) page grid, zero-padded past ``ncols``; a
    k-major x (k, ncols) gives (k, npages, 8, L)."""
    shape = x.shape[:-1] + (npages, 8, L)
    if npages * PAGE == ncols:
        return x.reshape(shape)
    return F.pad(x[..., :ncols], (0, npages * PAGE - ncols)).reshape(shape)


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
    place, through the kernel's scatter epilogue (:func:`delta_pages_acc`).
    Padding slots carry ``vals = 0``, ``sl = 0`` and the sentinel row
    ``nrows_part`` (``nrows_glob`` on a symmetric shard's transposed
    stream), which the reference drops (``mode="drop"``), as the epilogue
    does."""
    if acc.shape[0] != nrows_part:
        raise ValueError(f"acc: {acc.shape[0]} values, expected nrows_part "
                         f"= {nrows_part}")
    _T, q, npages = rep_meta
    if x2 is None:
        x2 = pad_x_pages(x, ncols, q, npages)
    return delta_pages_acc(rep["plo"], rep["sl"], rep["vals"], x2, q, acc,
                           rep["rows"])


def paged_gather_grid(plan_meta, plan, x, ncols: int, x2=None):
    """Gathered x in raw (T, 8, 128) grid form (element / tile order), as
    the reference's fblk chain reads it (kernels.py:607-646)."""
    _T, q, _g, npages = plan_meta
    if x2 is None:
        x2 = pad_x_pages(x, ncols, q, npages)
    return gather(plan["plo"], plan["sl"], x2, q)


__all__ = [
    "build_delta_pages", "build_unit_pages", "dia", "dia_plain",
    "dia_frame", "dia_spmv", "delta_pages", "delta_pages_acc",
    "delta_pages_acc_plain", "delta_pages_plain", "gather",
    "gather_plain", "page_grid", "pad_x_pages", "delta_pages_products",
    "delta_pages_spmv", "add_totals", "paged_gather_grid", "paged_units",
    "paged_units_plain", "window_index",
]
