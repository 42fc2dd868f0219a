"""The fused pipeline on PyTorch: its planners, K1, T1, K2, K3 and glue.

Counterpart of ``sparsex_tpu/ops/fused.py``, both halves:

- the host planners, the port's own copies of the reference's
  (``build_fused_delta``, ``build_fused_run``, ``merge_segment_plan``,
  ``pad_dias_for_k3``, ``plan_partial_segment``, ``pack_k1_meta`` and the
  lane-placement layouts; unchanged NumPy, reading the port's ``Config``
  and module thresholds), so both packages plan the same arrays, but for
  one repair: both G1 fills go through ``instance_g1``, and
  ``build_fused_run`` gives route instances that overlap in source rows
  identity wires rather than the last fold's.  Their comments cite the
  reference's TPU measurements (the thresholds' origins); none of them is
  a number of the port;
- four kernel wrappers, ``k1`` (the lane-placed styles ``lp`` and
  ``rlp{W}``, the dense-tile styles ``sl`` and ``run{W}``), ``t1``,
  ``k2``, ``k3``, each launching a CUDA kernel of ``csrc/fused.cu`` on a
  CUDA tensor and running its plain PyTorch version (``k1_plain`` ...) only
  on a CPU tensor.  Given k-batched operands (a leading axis of kb <=
  ``MAX_KB`` columns, the reference's ``kb`` > 0 builders) each launches
  its ``_kb`` kernel, which reads the plan's metadata once for the kb
  columns; the plain versions take the same leading axis;
- the glue with the reference's names and static-meta tuples:
  ``_to_blocks``, ``_k1_x2``, ``fused_delta_a1``, ``_e1s_from_a1``,
  ``fused_delta_e1s``, ``fused_run_a1``, ``fused_run_e1s``, ``merged_e1s``
  (each merged instance's G1 is the lane gather of ``ops/route.py``) and
  ``k3_combine``, plus the residual adds ``add_products`` / ``add_totals``;
  each takes x as a vector or k-major (k, ncols), as the reference's does.

Every wrapper adds one to ``launches[name]`` each time it launches its CUDA
kernel, and nowhere else, so a caller can show which kernels a run used.

K2 takes RAW ``g2b`` wires: for unmasked (``um & 1``) plans the lane offset
the Pallas kernel bakes in is removed at upload (``ops/convert.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparsex_tpu_torch.config import Config
from sparsex_tpu_torch.ops import route
from sparsex_tpu_torch.ops._launch import (MAX_KB, _batch, _check, _launch,
                                           _offsets_tensor, _route, _stream,
                                           _value_dtype, launches)
from sparsex_tpu_torch.ops.pallas_kernels import (DELTA_TILE, PAGE,
                                                  add_totals,
                                                  build_delta_pages,
                                                  build_unit_pages,
                                                  page_grid)
from sparsex_tpu_torch.timing import planner

# ---------------------------------------------------------------------------
# the planners (copied from sparsex_tpu/ops/fused.py:44-762, :814-880,
# :916-958, :1113-1139, :1678-1737)
# ---------------------------------------------------------------------------

L = 128
TILE3 = L * L              # y rows per K3 grid step (one 128-page block)
MAX_INSTANCES = 8          # K3 input fan-in cap; beyond -> legacy path
MIN_FUSED_NNZ = 1 << 15    # below this the XLA delta path is cheaper


def min_fused_nnz() -> int:
    """Fused-pipeline size gate (``spx.tpu.min_fused_nnz``, 0 = always
    fuse).  Mid-size matrices below the default gate take the legacy
    paged/routed path — the gate is logged AND overridable, so the drop
    is never silent or forced (VERDICT r3 weak #7)."""
    try:
        v = Config.instance().get("spx.tpu.min_fused_nnz")
        return MIN_FUSED_NNZ if v in (None, "") else int(v)
    except Exception:
        return MIN_FUSED_NNZ


# ---------------------------------------------------------------------------
# Plan construction (host side)
# ---------------------------------------------------------------------------

SB_PAGES = 4   # lane-placed superblock: pages per tile window (default)
TAIL_SBP = 32  # tail part's superblock (big classes absorb lane clumps)


def sb_pages() -> int:
    """Pages per lane-placed tile window (``spx.tpu.sb_pages``).

    The tradeoff this knob sweeps (measure on the real chip): smaller
    windows cut K1's per-tile VPU ops (q8 masked sublane gathers; q8=1
    is ONE native take) and its x-window DMA bytes 4x, but shrink the
    (fold, superblock, lane) classes so partial tiles / pad-to-8 rows
    grow T.  Layouts carry their q, so mixed values stay correct."""
    try:
        return int(Config.instance().get("spx.tpu.sb_pages"))
    except Exception:
        return SB_PAGES


def _lane_place_layout(cols, rows, vals, fold, ncols: int,
                       nrows_part: int, sbp: int = None,
                       n_rounds: int = 1, exact_last: bool = False,
                       fill_gate: float = 2.0):
    """Lane-placed delta layout: each element sits at the LANE equal to
    its column's low 7 bits and every tile's x window is ONE aligned
    SB_PAGES-page block, so K1 does a single page DMA and SB_PAGES
    sublane gathers per tile (vs q page DMAs and 24q lane-shuffle ops).

    Placement (round 5): multi-ROUND capped packing.  The old one-shot
    rule sized every (fold, superblock) group by its WORST lane class
    (``ceil(max/8)`` tiles), so any lane clumping — 8-deep vertical-run
    demotions, Poisson tails on random singles — padded every other
    lane and fill fell under the 50% gate (headline ran at 50%, diagc
    fell all the way to the q=8 lane-shuffle style + 16k serialized
    leftovers, PROFILE_r05).  Now each round caps a group's tile count
    near its MEAN occupancy (``ceil(total/1024)``), elements beyond the
    cap re-enter the next round (whose groups contain only the
    overflow, so its mean IS the clump remnant), and the final round is
    exact, guaranteeing full placement.  Tiles order fold-major (chunk
    cuts need fold contiguity), then round, then superblock (K1's
    slot-stride DMA reuse wants sb runs adjacent).

    Returns (p0, low, vals3, dest, tile_group, q, npages, leftover_sel,
    cols_at_pos) — ``p0`` is the tile's superblock index (block units),
    ``low`` the within-window row (page*8 + source row, < 32).
    """
    m = cols.size
    if sbp is None:
        sbp = sb_pages()
    npages = -(-ncols // PAGE)
    sb_cols = sbp * PAGE
    lane_all = cols & (L - 1)
    sb_all = cols // sb_cols

    N_ROUNDS = n_rounds
    pend = np.arange(m, dtype=np.int64)
    el_tile = np.zeros(m, dtype=np.int64)   # provisional tile id
    el_sub = np.zeros(m, dtype=np.int64)    # (leftovers keep 0: unused)
    tile_fold_l: List[np.ndarray] = []      # per-tile fold, in id order
    tile_sb_l: List[np.ndarray] = []
    tb = 0                                  # running tile base
    for rnd in range(N_ROUNDS):
        if pend.size == 0:
            break
        f = fold[pend]
        b = sb_all[pend]
        lx = lane_all[pend]
        c = cols[pend]
        order = np.lexsort((c, lx, b, f))
        p = pend[order]
        f, b, lx = f[order], b[order], lx[order]
        n = p.size
        new_cls = np.empty(n, dtype=bool)
        new_cls[0] = True
        np.logical_or.reduce(
            [f[1:] != f[:-1], b[1:] != b[:-1], lx[1:] != lx[:-1]],
            out=new_cls[1:])
        starts = np.flatnonzero(new_cls)
        ci = np.cumsum(new_cls) - 1
        pos_in_cls = np.arange(n, dtype=np.int64) - starts[ci]
        new_grp = np.empty(n, dtype=bool)
        new_grp[0] = True
        np.logical_or(f[1:] != f[:-1], b[1:] != b[:-1], out=new_grp[1:])
        gi = np.cumsum(new_grp) - 1
        n_grp = int(gi[-1]) + 1
        grp_count = np.bincount(gi, minlength=n_grp)
        # per-group worst class (exact tile need)
        cls_size = np.diff(np.concatenate([starts, [n]]))
        cls_grp = gi[starts]
        max_cls = np.zeros(n_grp, dtype=np.int64)
        np.maximum.at(max_cls, cls_grp, cls_size)
        exact = -(-max_cls // 8)
        if exact_last and rnd == N_ROUNDS - 1:
            R_g = exact
        else:
            # mean occupancy cap; never below 1 tile, never above exact
            R_g = np.minimum(exact,
                             np.maximum(1, -(-grp_count // DELTA_TILE)))
        cap = R_g[gi] * 8
        ok = pos_in_cls < cap
        lvl = pos_in_cls[ok] // 8
        sub = pos_in_cls[ok] % 8
        grp_base = np.concatenate([[0], np.cumsum(R_g)[:-1]])
        el_tile[p[ok]] = tb + grp_base[gi[ok]] + lvl
        el_sub[p[ok]] = sub
        grp_first = np.flatnonzero(new_grp)
        tile_fold_l.append(np.repeat(f[grp_first], R_g))
        tile_sb_l.append(np.repeat(b[grp_first], R_g))
        tb += int(R_g.sum())
        pend = p[~ok]

    T = tb
    placed_m = m - pend.size
    if T == 0 or T * DELTA_TILE > placed_m * fill_gate:
        return None                          # lane skew beyond the gate
    tile_fold = np.concatenate(tile_fold_l)
    tile_sb = np.concatenate(tile_sb_l)
    # fold-major final order (chunk cuts need fold-contiguous tiles);
    # stable sort keeps (round, sb) order within a fold
    perm = np.argsort(tile_fold, kind="stable")
    remap = np.empty(T, dtype=np.int64)
    remap[perm] = np.arange(T)
    tile_fold = tile_fold[perm]
    tile_sb = tile_sb[perm]
    tile_of = remap[el_tile]                # per-element final tile

    p0 = tile_sb.astype(np.int32)
    tg = tile_fold.astype(np.int64)
    low = np.zeros((T, 8, L), dtype=np.int32)
    vals3 = np.zeros((T, 8, L), dtype=vals.dtype)
    dest = np.full((T, 8, L), nrows_part, dtype=np.int64)
    cols_at_pos = np.zeros((T, 8, L), dtype=np.int64)
    placed = np.ones(m, dtype=bool)
    placed[pend] = False
    sel = np.flatnonzero(placed)
    off = cols - sb_all * sb_cols           # < sbp * 1024
    low[tile_of[sel], el_sub[sel], lane_all[sel]] = (
        off[sel] // L).astype(np.int32)
    vals3[tile_of[sel], el_sub[sel], lane_all[sel]] = vals[sel]
    dest[tile_of[sel], el_sub[sel], lane_all[sel]] = rows[sel]
    cols_at_pos[tile_of[sel], el_sub[sel], lane_all[sel]] = cols[sel]
    return (p0, low, vals3, dest.reshape(-1), tg, sbp, int(npages),
            pend, cols_at_pos.reshape(-1))


def _run_lane_place(cols_u, rows_u, vals2d, W: int, ncols: int,
                    nrows_part: int):
    """Lane-placed layout for width-W step-1 horizontal runs ("rlpW").

    The classic "runW" K1 gathers each element with the 24q-op lane
    shuffle (measured 132us on the blocky run table, compute-bound).
    Lane placement turns that into the delta-lp sublane path: element j
    of a unit sits at lane (col+j) & 127, so the gather is one aligned
    SB_PAGES-page DMA plus SB_PAGES masked sublane ``take_along_axis``
    per tile, and the existing CIRCULAR sliding lane sum still reduces
    each arc in place (wrapping arcs stay W-aligned slots, so they never
    collide).

    Packing: arcs only need to be DISJOINT within a row (the sliding
    window at an arc's end lane covers exactly its own W lanes), so
    this is circular interval packing on 128 lanes.  Per superblock:
    cut the circle at the lane of MINIMUM coverage depth, rotate, then
    color the non-crossing arcs with the mod-chi rule — sorted by
    rotated lane, a conflicting pair implies a consecutive clique, so
    chi = max clique depth rows suffice and ``row = rank mod chi`` is a
    valid OPTIMAL linear-interval coloring; the few arcs crossing the
    cut (min-depth many) pairwise conflict, so each takes one dedicated
    row.  One pass, zero evictions: the only spill is superblock-
    straddling arcs, and spills demote to the delta table (bulk slots)
    rather than serialized tail gathers.

    Returns (T, plo, sl, vals3, dest, punit, q, npages, order, n_page)
    or None (lane-skew fill < 50%, or too small).  ``punit`` maps each
    grid position to its unit's index in ``order`` (-1 elsewhere).
    """
    c = cols_u.astype(np.int64)
    sbp = sb_pages()
    sb_cols = sbp * PAGE
    sb = c // sb_cols
    ok = (c + W - 1) // sb_cols == sb      # arc within one superblock
    idx_ok = np.flatnonzero(ok)
    if idx_ok.size * W < min_fused_nnz():
        return None
    uniq_sb, sb_all = np.unique(sb[idx_ok], return_inverse=True)
    nsb = uniq_sb.size

    # rotate each superblock's lane circle so the cut sits at the lane
    # of MINIMUM coverage depth: wrap conflicts involve only the
    # min-depth-many arcs crossing the cut
    lane_raw = (c[idx_ok] & (L - 1)).astype(np.int64)
    cov = np.zeros((nsb, L), dtype=np.int64)
    for j in range(W):
        np.add.at(cov, (sb_all, (lane_raw + j) & (L - 1)), 1)
    cut = np.argmin(cov, axis=1)
    lane_rot = (lane_raw - cut[sb_all]) & (L - 1)

    rows_used = np.zeros(nsb, dtype=np.int64)
    rows_rel = np.full(idx_ok.size, -1, dtype=np.int64)
    pend = np.arange(idx_ok.size)
    for rnd in range(4):
        if pend.size == 0:
            break
        o = np.lexsort((lane_rot[pend], sb_all[pend]))
        p = pend[o]
        psb = sb_all[p]
        pl = lane_rot[p]
        cnt = np.bincount(psb, minlength=nsb)
        starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        rank = np.arange(p.size) - starts[psb]
        # chi = max consecutive clique (the true minimum rows for FULL
        # placement; key spacing > 256 keeps searchsorted per-sb) caps
        # R; the mean-depth * ~1.15 slack target below it trims the
        # Poisson depth tail into the next round instead of allocating
        # rows for the single worst lane
        key = psb * 256 + pl
        depth = (np.arange(p.size)
                 - np.searchsorted(key, key - (W - 1)) + 1)
        chi = np.zeros(nsb, dtype=np.int64)
        np.maximum.at(chi, psb, depth)
        slack = 111 if rnd == 0 else 64
        R = np.minimum(chi, np.maximum(1, -(-cnt * W // slack)))
        Rr = np.maximum(R[psb], 1)
        row_in = rank % Rr
        okg = np.ones(p.size, dtype=bool)
        gp = np.flatnonzero(rank >= Rr)  # same-row linear predecessor
        okg[gp] = (pl[gp] - pl[gp - Rr[gp]]) >= W
        # circular check: an arc wrapping past the cut overlaps its
        # row's FIRST arc unless first + 128 - s >= W (rotation makes
        # these rare); the first arc itself is never evicted
        wr = np.flatnonzero(pl > L - W)
        firstpos = (starts[psb] + row_in)[wr]
        okg[wr] &= ((pl[firstpos] + L - pl[wr]) >= W) | (firstpos == wr)
        rows_rel[p[okg]] = (rows_used[psb] + row_in)[okg]
        rows_used += R * (cnt > 0)
        pend = p[~okg]
    placed = rows_rel >= 0
    # per-sb row blocks padded to whole 8-row tiles (a tile's window is
    # ONE superblock, so sb row blocks must not straddle tiles)
    rows_pad = -(-rows_used // 8) * 8
    T = int(rows_pad.sum()) // 8
    if T == 0 or T * DELTA_TILE > int(placed.sum()) * W * 2:
        return None                            # fill < 50%: lane skew
    sb_row_base = np.concatenate([[0], np.cumsum(rows_pad)[:-1]])

    keep = np.flatnonzero(placed)
    idx_pl = idx_ok[keep]
    co = c[idx_pl]
    sbo = sb[idx_pl]
    slot = co & (L - 1)
    grow = sb_row_base[sb_all[keep]] + rows_rel[keep]
    tile = grow // 8
    row = grow % 8

    plo = np.repeat(uniq_sb.astype(np.int32), rows_pad // 8)
    sl = np.zeros((T, 8, L), dtype=np.int32)
    vals3 = np.zeros((T, 8, L), dtype=vals2d.dtype)
    dest = np.full((T, 8, L), nrows_part, dtype=np.int64)
    punit = np.full((T, 8, L), -1, dtype=np.int64)
    lanes = (slot[:, None] + np.arange(W)[None, :]) & (L - 1)
    offs = np.clip(co[:, None] + np.arange(W)[None, :]
                   - sbo[:, None] * sb_cols, 0, sb_cols - 1)
    tW = np.broadcast_to(tile[:, None], lanes.shape)
    rW = np.broadcast_to(row[:, None], lanes.shape)
    sl[tW, rW, lanes] = (offs // L).astype(np.int32)
    vals3[tW, rW, lanes] = vals2d[idx_pl]
    lane_end = (slot + W - 1) & (L - 1)
    dest[tile, row, lane_end] = rows_u[idx_pl]
    punit[tile, row, lane_end] = np.arange(idx_pl.size)
    spill = np.concatenate([idx_ok[~placed], np.flatnonzero(~ok)])
    order = np.concatenate([idx_pl, spill])
    npages = -(-(-(-ncols // PAGE)) // sbp) * sbp
    return (T, plo, sl, vals3, dest.reshape(-1), punit.reshape(-1),
            sbp, int(npages), order, int(idx_pl.size))


def _stride_tiles(tile_group: np.ndarray, GT: int = None) -> np.ndarray:
    """Slot-strided physical tile order for K1 DMA reuse.

    K1 processes GT tiles per grid step and slot t's page-window index
    map reads tile i*GT + t; Mosaic skips the block DMA whenever the
    index repeats between consecutive steps.  Column-sorted ADJACENT
    tiles usually share a page window, but in natural order a slot's
    successive tiles are GT apart.  Within each tile_group span (fold
    boundaries must stay contiguous for the merged plan's chunk cuts)
    this permutation hands each slot a CONTIGUOUS run of tiles:
    physical p <- span_base + (p % GT) * (span/GT) + p // GT over the
    GT-aligned interior of the span.  Returns sigma with
    ``stream_physical = stream_logical[sigma]``.
    """
    if GT is None:
        GT = K1_GT
    T = tile_group.size
    sigma = np.arange(T)
    starts = np.concatenate(
        [[0], np.flatnonzero(tile_group[1:] != tile_group[:-1]) + 1, [T]])
    for g0, g1 in zip(starts[:-1], starts[1:]):
        a0 = -(-int(g0) // GT) * GT
        a1 = (int(g1) // GT) * GT
        n = a1 - a0
        if n >= 2 * GT:
            loc = np.arange(n)
            sigma[a0:a1] = a0 + (loc % GT) * (n // GT) + loc // GT
    return sigma


@planner(lambda out: out[0] is None)
def build_fused_delta(cols: np.ndarray, rows: np.ndarray, vals: np.ndarray,
                      ncols: int, nrows_part: int, max_k: int = 8):
    """Plan the fused pipeline for one partition's delta singles.

    Returns ``(meta, arrays)`` or ``(None, None)``.  ``meta`` is the
    static trace signature ``(T, q, npages, inst, n_res, n_left, style)``
    where ``inst`` is a tuple of per-instance ``(S1c, S1p, A2R, D2R, Dp,
    K, W2, a0, a1)`` route metas and ``style`` selects the K1 gather
    ("lp" lane-placed sublane gather, "sl" dense-tile lane shuffle);
    ``arrays`` holds the device streams:

    - ``plo`` (T,) i32, ``mg`` (T,8,128) i32 (packed window offset + G1
      wire, :func:`pack_k1_meta`), ``vals`` (T,8,128) f32 — K1 inputs;
    - per instance ``g2a``/``g2b``/``g2c`` i8 (K2) and ``g3`` i8 in
      dest-page-major (D2R, K, L, L) form (K3);
    - ``res_cols``/``res_dest``/``res_vals`` — over-capacity elements
      (XLA scatter, tiny); ``left_*`` — unpageable spill (XLA delta path).
    """
    m = cols.size
    if m < min_fused_nnz() or nrows_part <= 0:
        return None, None
    Dq = -(-nrows_part // L)
    if -(-Dq // L) > L:          # D2R > 128: beyond one K3 block axis
        return None, None

    cols = np.asarray(cols, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)

    # fold per element (dest-page rank // 128), computed pre-spill; the
    # (fold, col) sort makes folds contiguous AND col-local within a fold
    fold = route._rank_within(rows // L) // L
    parts: List[Dict] = []
    style = None
    leftover = np.zeros(0, dtype=np.int64)
    lp = _lane_place_layout(cols, rows, vals, fold, ncols, nrows_part)
    if lp is not None:
        (plo_arr, low, vals3, dest1, tile_group, q_val, npages_val,
         left1, cols_at_pos) = lp
        style = "lp"
        parts.append(dict(plo=plo_arr, low=low, vals3=vals3, dest=dest1,
                          tg=tile_group, q=q_val, npages=npages_val,
                          cap=cols_at_pos))
        if left1.size:
            # TAIL part (round 5): the mean-cap round's overflow — lane
            # clumps (vertical-run demotions) and Poisson tails — gets
            # its own lane-placed region with a 32-page superblock, so
            # the classes are 8x bigger and the exact cap packs them
            # tightly.  Both K1 outputs re-interleave fold-major via
            # the static slice list in meta[7], so the route planner
            # still sees ONE fold-contiguous grid (no extra instances).
            # Before this, headline carried 376 pad-tiles (fill 50%)
            # and diagc fell to the q=8 lane-shuffle style + 16k
            # serialized leftovers (PROFILE_r05).
            lp2 = _lane_place_layout(
                cols[left1], rows[left1], vals[left1], fold[left1],
                ncols, nrows_part, sbp=TAIL_SBP, n_rounds=2,
                exact_last=True, fill_gate=float("inf"))
            if lp2 is None or lp2[7].size:
                parts, style = [], None   # hybrid failed: whole-stream sl
            else:
                parts.append(dict(plo=lp2[0], low=lp2[1], vals3=lp2[2],
                                  dest=lp2[3], tg=lp2[4], q=lp2[5],
                                  npages=lp2[6], cap=lp2[8]))
    if style is None:
        key = fold * (cols.max() + 2) + cols
        rep, leftover = build_delta_pages(
            cols, rows, vals, ncols, nrows_part, sort_key=key,
            group_ids=fold)
        if rep is None:
            return None, None
        style = "sl"
        T = rep["plo"].size
        plo_arr = rep["plo"]
        low = rep["sl"].reshape(T, 8, L).astype(np.int32)
        vals3 = rep["vals"].reshape(T, 8, L)
        dest1 = np.asarray(rep["rows"], dtype=np.int64)
        tile_group = rep.pop("tile_group")
        q_val, npages_val = int(rep["q"]), int(rep["npages"])
        tile_idx = np.arange(T * DELTA_TILE) // DELTA_TILE
        cols_at_pos = (low.reshape(-1).astype(np.int64)
                       + plo_arr[tile_idx].astype(np.int64) * PAGE)
        parts = [dict(plo=plo_arr, low=low, vals3=vals3, dest=dest1,
                      tg=tile_group, q=q_val, npages=npages_val,
                      cap=cols_at_pos)]

    # slot-strided physical tile order within each fold span (K1 DMA
    # reuse; see _stride_tiles) — permutes every per-tile stream
    # consistently BEFORE route planning, so the plan, G1 wires and
    # residual positions all live in physical order
    for p_ in parts:
        T_p = p_["plo"].size
        sigma = _stride_tiles(p_["tg"])
        if not np.array_equal(sigma, np.arange(T_p)):
            for k_ in ("plo", "low", "vals3", "tg"):
                p_[k_] = p_[k_][sigma]
            p_["dest"] = p_["dest"].reshape(
                T_p, DELTA_TILE)[sigma].reshape(-1)
            p_["cap"] = p_["cap"].reshape(
                T_p, DELTA_TILE)[sigma].reshape(-1)

    # fold-major merge of the parts' tiles at FOLD-SPAN granularity: a
    # part's fold span stays physically contiguous after _stride_tiles
    # (sigma permutes only within spans), so each merged slice is a
    # contiguous part-local tile range [lo, hi)
    t_counts = [p_["plo"].size for p_ in parts]
    spans = []              # (fold, part, lo, hi) part-local ranges
    for i_, p_ in enumerate(parts):
        tg_p = p_["tg"]
        if tg_p.size == 0:
            continue
        b_ = np.concatenate(
            [[0], np.flatnonzero(tg_p[1:] != tg_p[:-1]) + 1,
             [tg_p.size]])
        for lo_, hi_ in zip(b_[:-1], b_[1:]):
            spans.append((int(tg_p[lo_]), i_, int(lo_), int(hi_)))
    spans.sort()
    inter = tuple((pid, lo_, hi_) for _f, pid, lo_, hi_ in spans)
    part_bases = np.cumsum([0] + t_counts)
    morder = np.concatenate(
        [np.arange(lo_, hi_, dtype=np.int64) + part_bases[pid]
         for _f, pid, lo_, hi_ in spans])
    T = int(morder.size)
    fold_cat = np.concatenate([p_["tg"] for p_ in parts])
    part_cat = np.concatenate([np.full(t, i, dtype=np.int64)
                               for i, t in enumerate(t_counts)])
    tile_group = fold_cat[morder]
    part_of = part_cat[morder]
    dest = np.concatenate([p_["dest"].reshape(-1, DELTA_TILE)
                           for p_ in parts])[morder].reshape(-1)
    cols_at_pos = np.concatenate([p_["cap"].reshape(-1, DELTA_TILE)
                                  for p_ in parts])[morder].reshape(-1)
    vals_flat = np.concatenate(
        [p_["vals3"].reshape(-1, DELTA_TILE)
         for p_ in parts])[morder].reshape(-1)

    # tile-aligned chunk ranges: cut where the (pre-spill) fold group of
    # the tile changes, then at CHUNK_SRC_ROWS — every cut is a multiple
    # of 8 grid rows (= whole product tiles), so each K1 tile belongs to
    # exactly one route instance.  Within one group every dest page holds
    # <= 128 elements, so each chunk is a single network instance.
    S1_total = T * DELTA_TILE // L
    cuts = {0, S1_total}
    gstep = np.flatnonzero(tile_group[1:] != tile_group[:-1]) + 1
    cuts.update(int(t) * 8 for t in gstep)
    bounds = sorted(cuts)
    ranges = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        for a0 in range(lo, hi, route.CHUNK_SRC_ROWS):
            ranges.append((a0, min(hi, a0 + route.CHUNK_SRC_ROWS)))

    plan = route.build_scatter_plan(dest, nrows_part, max_k=max_k,
                                    ranges=ranges)
    if plan is None:
        return None, None
    plan = route.demote_small_instances(plan, dest)
    metas, arrs_list, res_pos, res_dest = plan
    if len(metas) > MAX_INSTANCES:
        return None, None

    # K1's G1 wires: one (S1_total*L) grid assembled from the instances'
    # g1 rows (the fold-cut chunks make the instances disjoint)
    g1_all = instance_g1(S1_total, metas, arrs_list)

    D2R = metas[0][3]
    # per-part K1 streams, each padded to a whole number of grouped grid
    # steps (dummy tiles: g1 = -1 masks every lane, vals are zero); the
    # part's G1 rows come from its tiles' MERGED positions
    g1_t = g1_all.reshape(T, 8, L)
    arrays: Dict[str, np.ndarray] = {}
    part_pads = []
    for i_, p_ in enumerate(parts):
        pos_p = np.flatnonzero(part_of == i_)
        mg = pack_k1_meta(p_["low"], g1_t[pos_p])
        T_p = p_["plo"].size
        T_pp = -(-T_p // K1_GT) * K1_GT
        plo_p, mg_p, vals_p = p_["plo"], mg, p_["vals3"]
        if T_pp != T_p:
            plo_p = np.concatenate(
                [plo_p, np.zeros(T_pp - T_p, dtype=np.int32)])
            mg_p = np.concatenate(
                [mg_p, np.zeros((T_pp - T_p, 8, L), dtype=np.int32)])
            vals_p = np.concatenate(
                [vals_p, np.zeros((T_pp - T_p, 8, L),
                                  dtype=vals_p.dtype)])
        sfx = "" if i_ == 0 else "2"
        arrays["plo" + sfx] = plo_p
        arrays["mg" + sfx] = mg_p
        arrays["vals" + sfx] = vals_p
        part_pads.append(T_pp)
    T_pad = part_pads[0]
    q_val, npages_val = parts[0]["q"], parts[0]["npages"]
    inst_meta = []
    for i, (meta_i, arrs_i) in enumerate(zip(metas, arrs_list)):
        S1c, S1p, A2R, D2Ri, Dp, K, W2, a0, a1 = meta_i[:9]
        um = meta_i[9] if len(meta_i) > 9 else 0
        if D2Ri != D2R:
            return None, None
        arrays[f"g2a_{i}"] = arrs_i["g2a"].reshape(L, A2R, L)
        g2b3 = arrs_i["g2b"].reshape(L, W2, L)
        arrays[f"g2b_{i}"] = (_g2b_lane_offset(g2b3, A2R)
                              if um & 1 else g2b3)
        arrays[f"g2c_{i}"] = arrs_i["g2c"].reshape(L, D2R, L)
        g3 = arrs_i["g3"]                      # (K, Dp, L)
        # the D2R*L pad rows keep -1 wires: they map to y rows that are
        # sliced off, but an unmasked gather would still READ them, so
        # only rows < Dq-derived coverage matter; pad rows must stay 0.
        # Unmasked g3 remains safe because pad PAGES have all-zero E2
        # rows (no element routes there), so any lane reads 0.
        g3p = np.full((g3.shape[0], D2R * L, L),
                      0 if (um & 2) else -1, dtype=np.int8)
        g3p[:, : g3.shape[1]] = g3
        # dest-page-major (D2R, K, L, L): one contiguous DMA per K3 step
        arrays[f"g3_{i}"] = np.ascontiguousarray(
            g3p.reshape(g3.shape[0], D2R, L, L).transpose(1, 0, 2, 3))
        inst_meta.append((S1c, S1p, A2R, D2R, Dp, K, W2, a0, a1, um))

    # residual (over-capacity) elements: their products are recomputed in
    # XLA from (col, val) — the fused kernels never materialize products
    if res_pos.size:
        flat_pos = res_pos.astype(np.int64)
        arrays["res_cols"] = np.minimum(cols_at_pos[flat_pos],
                                        ncols - 1).astype(np.int32)
        arrays["res_dest"] = res_dest.astype(np.int32)
        arrays["res_vals"] = vals_flat[flat_pos]
    # unpageable spill -> standard XLA delta path (sorted by row)
    n_left = int(leftover.size)
    if n_left:
        lo = np.sort(leftover)
        arrays["left_rows"] = rows[lo].astype(np.int32)
        arrays["left_cols"] = cols[lo].astype(np.int32)
        arrays["left_vals"] = vals[lo]

    # host-only extras for the executor's merged-plan attempt (popped
    # before device transfer)
    arrays["_dest"] = dest
    arrays["_tile_group"] = tile_group
    arrays["_cols_at_pos"] = cols_at_pos
    arrays["_vals_flat"] = vals_flat
    meta = (T_pad, q_val, npages_val, tuple(inst_meta),
            int(res_pos.size), n_left, style)
    if len(parts) > 1:
        meta = meta + (((part_pads[1], parts[1]["q"],
                         parts[1]["npages"], "lp"), inter),)
    return meta, arrays


def instances_overlap(inst_meta) -> bool:
    """Whether two route instances of one segment (metas holding ``a0``,
    ``a1`` at [7], [8]) share source rows: the multi-fold fallback of
    ``route.build_scatter_plan(..., uniform_chunks=True)`` plans several
    instances over one chunk, one per fold."""
    spans = sorted((int(m[7]), int(m[8])) for m in inst_meta)
    return any(b0 < a1 for (_a0, a1), (b0, _b1) in zip(spans, spans[1:]))


def instance_g1(S1_total: int, metas, arrs_list) -> np.ndarray:
    """K1's one G1 grid (S1_total, L) for a segment: each instance's g1
    rows over its source rows [a0, a1), -1 (masked) elsewhere.  K1 applies
    one wire per source lane, so instances sharing rows would keep only the
    last one's wires and route the other folds through the wrong lanes:
    raises ValueError on them (only the merged plan's per-instance lane
    gathers run such instances)."""
    if instances_overlap(metas):
        raise ValueError("route instances overlap in source rows: K1's one "
                         "G1 grid cannot route them")
    g1_all = np.full((S1_total, L), -1, dtype=np.int8)
    for meta_i, arrs_i in zip(metas, arrs_list):
        S1c, a0, a1 = meta_i[0], meta_i[7], meta_i[8]
        g1_all[a0:a1] = arrs_i["g1"][:S1c]
    return g1_all


@planner(lambda out: out[0] is None)
def build_fused_run(cols_u: np.ndarray, rows_u: np.ndarray,
                    vals2d: np.ndarray, ncols: int, nrows_part: int,
                    W: int, step: int = 1, max_k: int = 8):
    """Plan the fused horizontal-run pipeline: ONE kernel gathers the
    unit x windows, multiplies by the (zero-padded) values, reduces each
    unit with a width-W sliding lane sum and routes the unit totals
    through G1 — the separate paged_gather + XLA FMA + lane-gather chain
    (measured 335us on the blocky run table) collapses into K1-style
    grouped tiles feeding the shared K2/K3.

    ``cols_u``/``rows_u``: (U,) unit heads; ``vals2d``: (U, W) padded
    values; ``step``: column stride between elements (delta).  Returns
    ``(meta, arrays, order, n_page)`` or ``(None,) * 4``; ``meta`` =
    (T_pad, q, npages, inst, n_res, style) where style is "rlpW"
    (lane-placed, step-1 W<=8 runs — see :func:`_run_lane_place`) or the
    dense-tile fallback "runW"; tail units [n_page:] of the reordered
    table stay on the XLA path.
    """
    U = cols_u.size
    if W < 2 or 128 % W or U * W < min_fused_nnz():
        return None, None, None, 0
    Dq = -(-nrows_part // L)
    if -(-Dq // L) > L:
        return None, None, None, 0
    rl = None
    if step == 1 and W <= 8:
        rl = _run_lane_place(cols_u, rows_u, vals2d, W, ncols, nrows_part)
    if rl is not None:
        (T, plo_l, sl_l, vals_l, dest_l, punit_l, q_val, npages_val,
         order, n_page) = rl
        style = f"rlp{W}"
    else:
        lanes = np.arange(W, dtype=np.int64) * step
        flat = np.clip(cols_u[:, None].astype(np.int64) + lanes[None, :],
                       0, ncols - 1).reshape(-1)
        order, n_page, plan = build_unit_pages(flat, W, ncols,
                                               min_elems=min_fused_nnz())
        if plan is None:
            return None, None, None, 0
        T = plan["T"]
        g = plan["g"]
        n_page = T * g
        style = f"run{W}"
        q_val, npages_val = int(plan["q"]), int(plan["npages"])
        plo_l = plan["plo"]
        sl_l = plan["sl"].reshape(T, 8, L).astype(np.int32)
        vals_l = np.zeros((T, DELTA_TILE), dtype=vals2d.dtype)
        vals_l[:, : g * W] = vals2d[order[:n_page]].reshape(T, g * W)
        vals_l = vals_l.reshape(T, 8, L)
        dest_l = np.full(T * DELTA_TILE, nrows_part, dtype=np.int64)
        punit_l = np.full(T * DELTA_TILE, -1, dtype=np.int64)
        ends = np.arange(n_page, dtype=np.int64) * W + (W - 1)
        dest_l[ends] = rows_u[order[:n_page]].astype(np.int64)
        punit_l[ends] = np.arange(n_page)
    ucols = cols_u[order[:n_page]]
    uvals = vals2d[order[:n_page]]
    # ---- slot-strided physical tile order (K1 DMA reuse) -----------------
    # K1 processes GT tiles per grid step; slot t's page-window index map is
    # plo[i*GT + t], and Mosaic's pipeline skips the block DMA whenever the
    # index repeats between consecutive steps.  Column-sorted ADJACENT tiles
    # usually share a page window, but in natural order a slot's successive
    # tiles are GT apart (always a fresh window).  Laying tiles out
    # physical p <- logical (p % GT) * (T_pad/GT) + p // GT hands each slot
    # a CONTIGUOUS run of tiles, so most page fetches collapse into reuse.
    T_pad = -(-T // K1_GT) * K1_GT
    Rs = T_pad // K1_GT
    pidx = np.arange(T_pad)
    sigma = (pidx % K1_GT) * Rs + pidx // K1_GT

    def _tpad(a, fill=0):
        if a.shape[0] == T_pad:
            return a
        pad = np.full((T_pad - a.shape[0],) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, pad])

    plo = _tpad(plo_l)[sigma]
    sl = _tpad(sl_l)[sigma]
    vals3 = _tpad(vals_l)[sigma]
    dest = _tpad(dest_l.reshape(T, DELTA_TILE),
                 fill=nrows_part)[sigma].reshape(-1)
    punit = _tpad(punit_l.reshape(T, DELTA_TILE),
                  fill=-1)[sigma].reshape(-1)
    plan_sc = route.build_scatter_plan(dest, nrows_part, max_k=max_k,
                                       uniform_chunks=True, max_folds=1,
                                       max_res_frac=0.1)
    if plan_sc is None:
        plan_sc = route.build_scatter_plan(dest, nrows_part, max_k=max_k,
                                           uniform_chunks=True)
    if plan_sc is None:
        return None, None, None, 0
    plan_sc = route.demote_small_instances(plan_sc, dest)
    metas, arrs_list, res_pos, res_dest = plan_sc
    if len(metas) > MAX_INSTANCES:
        return None, None, None, 0
    S1_total = T_pad * 8
    if instances_overlap(metas):
        # the fallback's folds share chunks: no one G1 serves them.  K1
        # takes identity wires, the merged plan's form (the merge rewrites
        # mg to them anyway); a table the merged plan does not take is
        # re-planned without its fused run (ops/exec.HostPlan), a port
        # repair that the reference (last fold's wires) lacks
        g1_all = np.broadcast_to(np.arange(L, dtype=np.int8),
                                 (S1_total, L))
    else:
        g1_all = instance_g1(S1_total, metas, arrs_list)

    mg = pack_k1_meta(sl, g1_all.reshape(T_pad, 8, L))
    arrays: Dict[str, np.ndarray] = {
        "plo": plo,
        "mg": mg,
        "vals": vals3,
    }
    D2R = metas[0][3]
    inst_meta = []
    for i, (meta_i, arrs_i) in enumerate(zip(metas, arrs_list)):
        S1c, S1p, A2R, D2Ri, Dp, K, W2, a0, a1 = meta_i[:9]
        um = meta_i[9] if len(meta_i) > 9 else 0
        if D2Ri != D2R:
            return None, None, None, 0
        arrays[f"g2a_{i}"] = arrs_i["g2a"].reshape(L, A2R, L)
        g2b3 = arrs_i["g2b"].reshape(L, W2, L)
        arrays[f"g2b_{i}"] = (_g2b_lane_offset(g2b3, A2R)
                              if um & 1 else g2b3)
        arrays[f"g2c_{i}"] = arrs_i["g2c"].reshape(L, D2R, L)
        g3 = arrs_i["g3"]
        g3p = np.full((g3.shape[0], D2R * L, L),
                      0 if (um & 2) else -1, dtype=np.int8)
        g3p[:, : g3.shape[1]] = g3
        arrays[f"g3_{i}"] = np.ascontiguousarray(
            g3p.reshape(g3.shape[0], D2R, L, L).transpose(1, 0, 2, 3))
        inst_meta.append((S1c, S1p, A2R, D2R, Dp, K, W2, a0, a1, um))
    if res_pos.size:
        # residual partials are unit TOTALS; recompute in XLA from the
        # unit head + values (punit maps grid position -> unit)
        u_res = punit[res_pos.astype(np.int64)]
        arrays["res_cols_u"] = ucols[u_res].astype(np.int32)
        arrays["res_vals2d"] = uvals[u_res]
        arrays["res_dest"] = res_dest.astype(np.int32)
    arrays["_dest"] = dest
    arrays["_punit"] = punit
    arrays["_cols_u_o"] = ucols
    arrays["_vals2d_o"] = uvals
    meta = (T_pad, q_val, npages_val, tuple(inst_meta),
            int(res_pos.size), style)
    return meta, arrays, order, n_page


def merge_segment_plan(dest_list, nrows_part: int, max_k: int = 8,
                       delta_tile_group=None):
    """ONE route plan over the concatenation of every segment's source
    grid.  K2's cost is ~fixed per instance (colors x W2 transposes,
    measured ~60us), so six per-segment instances cost ~6x one merged
    instance; merging is the single biggest blocky lever (r3 trace).

    ``dest_list``: per segment, the (rows*128,) destination array
    (sentinel >= nrows_part for padding).  ``delta_tile_group``: the
    delta segment's per-tile fold labels (segment 0), used to fold-align
    chunk cuts inside it.  Returns (inst_meta, arrays{g1 global +
    per-instance g2*/g3}, seg_row_bounds, has_res) or None.
    """
    rows_per = [d.size // L for d in dest_list]
    bounds = np.concatenate([[0], np.cumsum(rows_per)])
    S1_total = int(bounds[-1])
    dest = np.concatenate(dest_list)

    cuts = {0, S1_total}
    if delta_tile_group is not None and delta_tile_group.size:
        g = delta_tile_group
        step = np.flatnonzero(g[1:] != g[:-1]) + 1
        cuts.update(int(t) * 8 for t in step)
    ranges = []
    bds = sorted(cuts)
    for lo, hi in zip(bds[:-1], bds[1:]):
        for a0 in range(lo, hi, route.CHUNK_SRC_ROWS):
            ranges.append((a0, min(hi, a0 + route.CHUNK_SRC_ROWS)))
    plan = route.build_scatter_plan(dest, nrows_part, max_k=max_k,
                                    ranges=ranges, max_res_frac=0.1)
    if plan is None:
        return None
    plan = route.demote_small_instances(plan, dest)
    metas, arrs_list, res_pos, res_dest = plan
    if len(metas) > MAX_INSTANCES:
        return None
    Dq = -(-nrows_part // L)
    D2R = -(-Dq // L)
    # Fold instances may OVERLAP in source rows (segments are not
    # fold-sorted), and colorings are independent per instance — G1 must
    # be applied PER INSTANCE at runtime, never unioned into one grid.
    arrays: Dict[str, np.ndarray] = {}
    inst_meta = []
    for i, (meta_i, arrs_i) in enumerate(zip(metas, arrs_list)):
        S1c, S1p, A2R, D2Ri, Dp, K, W2, a0, a1 = meta_i[:9]
        um = meta_i[9] if len(meta_i) > 9 else 0
        if D2Ri != D2R:
            return None
        arrays[f"g1_{i}"] = arrs_i["g1"]
        arrays[f"g2a_{i}"] = arrs_i["g2a"].reshape(L, A2R, L)
        g2b3 = arrs_i["g2b"].reshape(L, W2, L)
        arrays[f"g2b_{i}"] = (_g2b_lane_offset(g2b3, A2R)
                              if um & 1 else g2b3)
        arrays[f"g2c_{i}"] = arrs_i["g2c"].reshape(L, D2R, L)
        g3 = arrs_i["g3"]
        g3p = np.full((g3.shape[0], D2R * L, L),
                      0 if (um & 2) else -1, dtype=np.int8)
        g3p[:, : g3.shape[1]] = g3
        arrays[f"g3_{i}"] = np.ascontiguousarray(
            g3p.reshape(g3.shape[0], D2R, L, L).transpose(1, 0, 2, 3))
        inst_meta.append((S1c, S1p, A2R, D2R, Dp, K, W2, a0, a1, um))
    if res_pos.size:
        arrays["res_pos"] = res_pos
        arrays["res_dest"] = res_dest
    return (tuple(inst_meta), arrays,
            tuple(int(b) for b in bounds), bool(res_pos.size))


def pad_dias_for_k3(dias_meta, dias_arrays, nrows_part: int):
    """Pad every DIA table's value grid to D2R*128*128 rows (K3's y grid).

    Returns (static_offsets, stacked_dv, anti_offsets, stacked_adv) with
    dv laid out (D, nb3, 128, 128) for block feeding."""
    Dq = -(-nrows_part // L)
    D2R = -(-Dq // L)
    npad = D2R * TILE3
    offs, dvs, aoffs, advs = [], [], [], []
    for (anti, offsets, _nd), t in zip(dias_meta, dias_arrays):
        dv = np.asarray(t["vals"])
        dvp = np.zeros((dv.shape[0], npad), dtype=dv.dtype)
        dvp[:, : dv.shape[1]] = dv
        if anti:
            aoffs.extend(int(o) for o in offsets)
            advs.append(dvp)
        else:
            offs.extend(int(o) for o in offsets)
            dvs.append(dvp)
    def pack(vs):
        if not vs:
            return None
        # dest-page-major (D2R, D, L, L): one contiguous DMA per K3 step
        v = np.concatenate(vs, axis=0).reshape(-1, D2R, L, L)
        return np.ascontiguousarray(v.transpose(1, 0, 2, 3))
    return tuple(offs), pack(dvs), tuple(aoffs), pack(advs)


def pack_k1_meta(sl: np.ndarray, g1: np.ndarray) -> np.ndarray:
    """One full-tile int32 stream per product tile: low 16 bits = the
    page-window offset (sub*128+lane < 8192), bits 16.. = g1 wire + 1
    (0 = masked).  Sub-tile int16/int8 blocks cost ~4x their traffic in
    DMA overhead per grid step (measured r3); packing restores full-tile
    DMAs and halves the stream count."""
    return (sl.astype(np.int32) & 0x3FFF) | (
        (g1.astype(np.int32) + 1) << 16)


K1_GT = 8  # tiles per K1 grid step (amortizes per-step overhead)


def _k2_gba(A2R: int, GC: int = 8) -> int:
    """Colors per FIRST-stage batched transpose in K2's unmasked path:
    the largest power of two <= min(GC, 128 // ceil8(A2R)).  Shared by
    the kernel and :func:`_g2b_lane_offset` (the wires bake the batch
    lane offset in, so the kernel gathers straight off the batched
    transpose with zero extra ops)."""
    A2R8 = -(-A2R // 8) * 8
    g = min(GC, max(1, L // A2R8))
    return 1 << (g.bit_length() - 1)


def _g2b_lane_offset(g2b3: np.ndarray, A2R: int) -> np.ndarray:
    """Bake the um2 first-transpose batch offset into g2b wires.

    In the unmasked K2, color c's transposed C1 block sits at lanes
    [(c % GBa) * A2R8, ...) of the shared (128, 128) batched transpose,
    so each wire value (an asr < A2R) shifts by that offset.  Only
    applied by planners that set ``um & 1`` — masked (stacked/legacy)
    plans keep raw wires and the per-color padT path."""
    GBa = _k2_gba(A2R)
    if GBa == 1:
        return g2b3
    A2R8 = -(-A2R // 8) * 8
    off = ((np.arange(L) % GBa) * A2R8).astype(np.int16)
    out = g2b3.astype(np.int16) + off[:, None, None]
    assert int(out.max(initial=0)) < L and int(g2b3.min(initial=0)) >= 0
    return out.astype(np.int8)


def plan_partial_segment(dest_flat: np.ndarray, n_dest: int,
                         max_k: int = 8):
    """Route plan (K3 form) for an XLA-produced partial stream.

    ``dest_flat``: (M,) destination row per partial (entries outside
    [0, n_dest) = padding).  Returns ``(inst_meta, arrays, (res_pos,
    res_dest), M_pad)`` or None.  The apply side is
    :func:`partial_segment_e1s` — a standalone G1 lane gather over the
    partials grid, then T1 + K2; the instances feed the shared K3.
    """
    M = dest_flat.size
    M_pad = -(-M // L) * L
    if M_pad != M:
        dest_flat = np.concatenate(
            [dest_flat, np.full(M_pad - M, -1, dtype=np.int64)])
    # Partial streams are NOT fold-sorted (unit order serves the x-page
    # gather), so capacity folds would fragment into many tiny kernel
    # chains (measured: 7 instances on the blocky block table cost more
    # than they saved).  One fold + whole-stream chunks; the small
    # over-capacity tail rides the XLA residual scatter.
    plan = route.build_scatter_plan(dest_flat, n_dest, max_k=max_k,
                                    uniform_chunks=True, max_folds=1,
                                    max_res_frac=0.1)
    if plan is None:
        # heavy multiplicity: accept the fold fragments rather than the
        # serialized XLA scatter for the whole stream
        plan = route.build_scatter_plan(dest_flat, n_dest, max_k=max_k,
                                        uniform_chunks=True)
    if plan is None:
        return None
    plan = route.demote_small_instances(plan, dest_flat)
    metas, arrs_list, res_pos, res_dest = plan
    if len(metas) > MAX_INSTANCES:
        return None
    Dq = -(-n_dest // L)
    D2R = -(-Dq // L)
    arrays: Dict[str, np.ndarray] = {}
    inst_meta = []
    for i, (meta_i, arrs_i) in enumerate(zip(metas, arrs_list)):
        S1c, S1p, A2R, D2Ri, Dp, K, W2, a0, a1 = meta_i[:9]
        um = meta_i[9] if len(meta_i) > 9 else 0
        if D2Ri != D2R:
            return None
        arrays[f"g1_{i}"] = arrs_i["g1"]
        arrays[f"g2a_{i}"] = arrs_i["g2a"].reshape(L, A2R, L)
        g2b3 = arrs_i["g2b"].reshape(L, W2, L)
        arrays[f"g2b_{i}"] = (_g2b_lane_offset(g2b3, A2R)
                              if um & 1 else g2b3)
        arrays[f"g2c_{i}"] = arrs_i["g2c"].reshape(L, D2R, L)
        g3 = arrs_i["g3"]
        g3p = np.full((g3.shape[0], D2R * L, L),
                      0 if (um & 2) else -1, dtype=np.int8)
        g3p[:, : g3.shape[1]] = g3
        arrays[f"g3_{i}"] = np.ascontiguousarray(
            g3p.reshape(g3.shape[0], D2R, L, L).transpose(1, 0, 2, 3))
        inst_meta.append((S1c, S1p, A2R, D2R, Dp, K, W2, a0, a1, um))
    if res_pos.size:
        arrays["res_pos"] = res_pos
        arrays["res_dest"] = res_dest
    return tuple(inst_meta), arrays, bool(res_pos.size), M_pad


# ---------------------------------------------------------------------------
# the device half
# ---------------------------------------------------------------------------

def _q8(q: int) -> int:
    return 1 << max(0, int(q - 1).bit_length())


def _d2r(nrows_part: int) -> int:
    """K3 destination blocks (of 128 pages of 128 rows) for nrows_part."""
    return -(-(-(-nrows_part // L)) // L)


# ---------------------------------------------------------------------------
# K1: the page-window gather product + G1 lane route, four styles
# ---------------------------------------------------------------------------

_RUN_WIDTHS = (2, 4, 8, 16, 32, 64, 128)   # every W >= 2 dividing 128
# launch-count key of each (dense-tile addressing, sliding sum) pair
_K1_KEYS = {(False, False): "k1", (False, True): "k1_rlp",
            (True, False): "k1_sl", (True, True): "k1_run"}


def k1_style(style: str) -> Tuple[bool, int]:
    """``(dense, W)`` of a K1 style (``fused.py:_build_k1``): the
    lane-placed ``lp`` (False, 0) and ``rlp{W}`` (False, W), the dense-tile
    ``sl`` (True, 0) and ``run{W}`` (True, W), for W >= 2 dividing 128.
    Any other name raises ``ValueError``."""
    if style in ("lp", "sl"):
        return style == "sl", 0
    dense = style.startswith("run")
    if ((dense or style.startswith("rlp")) and style[3:].isdigit()
            and int(style[3:]) in _RUN_WIDTHS):
        return dense, int(style[3:])
    raise ValueError(f"{style!r} is not a K1 style (lp, sl, rlp{{W}} or "
                     "run{W} with W >= 2 dividing 128)")


def k1_key(style: str) -> str:
    """The ``launches`` key of the kernel that runs ``style``."""
    dense, W = k1_style(style)
    return _K1_KEYS[(dense, W > 0)]


def k1_x_index(plo, mg, q: int, style: str):
    """``(idx, ok)``: the flat index into the page grid that each K1 slot
    reads, and whether it lies in the slot's window (``low = mg & 0x3FFF``,
    ``fused.py:_build_k1``).  The lane-placed styles read ``x2[plo[t]*q8 +
    (low >> 3), low & 7, l]``, outside the window where the page ``low >>
    3`` is q8 or more (q8 > 1); the dense-tile styles read
    ``x2flat[plo[t]*1024 + low]``, outside where ``low >> 7 >= 8q``.
    ``idx`` is clamped into the window where ``ok`` is False."""
    dense, _W = k1_style(style)
    T = mg.shape[0]
    low = mg & 0x3FFF
    if dense:
        ok = (low >> 7) < 8 * q
        return (plo.to(torch.int64).view(T, 1, 1) * PAGE
                + torch.where(ok, low, 0)), ok
    q8 = _q8(q)
    pg = low >> 3
    ok = pg < q8 if q8 > 1 else torch.ones_like(pg, dtype=torch.bool)
    page = plo.to(torch.int64).view(T, 1, 1) * q8
    if q8 > 1:
        page = page + torch.where(ok, pg, 0).to(torch.int64)
    lane = torch.arange(L, device=mg.device).view(1, 1, L)
    return (page * 8 + (low & 7)) * L + lane, ok


def k1_plain(plo, mg, vals, x2, q: int, style: str = "lp"):
    """``out[t,s,l] = g1 >= 0 ? p[t,s,g1] : 0`` with ``g1 = (mg[t,s,l] >> 16)
    - 1`` and the products ``p = x * vals``, x read as :func:`k1_x_index`
    says (0 outside the window).  The run styles ``rlp{W}`` / ``run{W}``
    first add ``roll(p, d)`` along the lanes for d = 1, 2, .. < W
    (circular), leaving each W-lane run's total at its last lane.  A
    k-batched ``x2`` (kb, npages, 8, 128) gives (kb, T, 8, 128), column by
    column the same arithmetic."""
    _dense, W = k1_style(style)
    idx, ok = k1_x_index(plo, mg, q, style)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    xs = x2.reshape(*x2.shape[:-3], -1)
    prod = torch.where(ok, xs[..., idx], zero) * vals
    d = 1
    while d < W:
        prod = prod + torch.roll(prod, d, dims=-1)
        d *= 2
    g1 = ((mg >> 16) & 0xFFFF) - 1
    g = torch.gather(prod, -1, g1.clamp(min=0).to(torch.int64)
                     .expand(prod.shape))
    return torch.where(g1 >= 0, g, zero)


def k1(plo, mg, vals, x2, q: int, style: str = "lp"):
    """K1 in any style over a (T, 8, 128) tile stream; ``x2`` is the padded
    page grid (npages, 8, 128): for the lane-placed styles a multiple of
    the window's q8 pages, for the dense-tile styles (q <= 16) at least q
    pages.  Every tile's window must lie inside ``x2``
    (``ops/convert.py`` checks the plan's).  A k-batched grid (kb, npages,
    8, 128), kb <= MAX_KB, gives (kb, T, 8, 128) from the ``_kb`` kernel,
    which reads mg and vals once for all kb columns.  On the card the kb
    kernels of every style, and the ``lp`` SpMV kernel, raise (CUDA error
    1) for mg or vals off a 16-byte boundary."""
    dense, W = k1_style(style)
    _value_dtype("vals", vals)
    T = mg.shape[0]
    dev = vals.device
    _check("plo", plo, torch.int32, (T,), dev)
    _check("mg", mg, torch.int32, (T, 8, L), dev)
    _check("vals", vals, None, (T, 8, L), dev)
    _check("x2", x2, vals.dtype, None, dev)
    kb = _batch("x2", x2, 3)
    npages = x2.shape[-3]
    if tuple(x2.shape[-2:]) != (8, L):
        raise ValueError(f"x2: shape {tuple(x2.shape)} is not a page grid")
    if dense:
        qk = q       # the dense kernel's window: q pages anywhere in x2
        if not 1 <= q <= 16 or npages < q:
            raise ValueError(f"x2: {npages} pages for a dense window "
                             f"of q={q} (1..16) pages")
    else:
        qk = _q8(q)  # the lane-placed kernel's: aligned q8-page blocks
        if npages % qk:
            raise ValueError(f"x2: shape {tuple(x2.shape)} is not a grid of "
                             f"q8={qk}-page windows")
    if _route(dev) == "cpu":
        return k1_plain(plo, mg, vals, x2, q, style)
    out = torch.empty(x2.shape[:-3] + (T, 8, L), dtype=vals.dtype,
                      device=dev)
    args = [plo.data_ptr(), mg.data_ptr(), vals.data_ptr(), x2.data_ptr(),
            out.data_ptr(), T, qk]
    if W:
        args.append(W)
    key = _K1_KEYS[(dense, W > 0)]
    if kb:
        key += "_kb"
        args += [kb, npages * PAGE]
    _launch(key, vals.dtype, *args, _stream(dev))
    return out


# ---------------------------------------------------------------------------
# T1: (A2R*128, 128) -> (A2R, 128, 128) transposed blocks
# ---------------------------------------------------------------------------

def t1_plain(a1, A2R: int):
    """Block ``a`` = ``a1[a*128:(a+1)*128].T`` (``fused.py:_build_t1``); a
    k-batched (kb, A2R*128, 128) gives (kb, A2R, 128, 128)."""
    return a1.view(*a1.shape[:-2], A2R, L, L).transpose(-2, -1).contiguous()


def t1(a1, A2R: int):
    _value_dtype("a1", a1)
    kb = _batch("a1", a1, 2)
    _check("a1", a1, None, a1.shape[:-2] + (A2R * L, L))
    if _route(a1.device) == "cpu":
        return t1_plain(a1, A2R)
    out = torch.empty(a1.shape[:-2] + (A2R, L, L), dtype=a1.dtype,
                      device=a1.device)
    if kb:
        _launch("t1_kb", a1.dtype, a1.data_ptr(), out.data_ptr(), A2R, kb,
                _stream(a1.device))
    else:
        _launch("t1", a1.dtype, a1.data_ptr(), out.data_ptr(), A2R,
                _stream(a1.device))
    return out


# ---------------------------------------------------------------------------
# K2: the middle stage, per outer color
# ---------------------------------------------------------------------------

def k2_plain(a1t, g2a, g2b, g2c, W2: int, D2R: int):
    """``E1[c,d,l]`` from A1T (A2R, 128, 128) through the raw g2a/g2b/g2c
    wires (``fused.py:_build_k2``; ``route._route_instance_np``); a
    k-batched (kb, A2R, 128, 128) gives (kb, 128, D2R, 128)."""
    A2R = a1t.shape[-3]
    zero = torch.zeros((), dtype=a1t.dtype, device=a1t.device)

    def take(src, idx):   # gather along the lanes, wires shared by columns
        return torch.gather(src, -1, idx.expand(src.shape[:-1]
                                                + idx.shape[-1:]))

    B = a1t.transpose(-3, -2)                         # [c, b, j]
    ga = g2a.to(torch.int64)
    C1 = torch.where(ga >= 0, take(B, ga.clamp(min=0)), zero)
    C1T = C1.transpose(-2, -1)[..., :W2, :]           # [c, w, b]
    gb = g2b[:, :, :D2R].to(torch.int64)              # [c, w, d]
    D1 = torch.where((gb >= 0) & (gb < A2R),
                     take(C1T, gb.clamp(0, A2R - 1)), zero)
    D1T = D1.transpose(-2, -1)                        # [c, d, w]
    gc = g2c.to(torch.int64)                          # [c, d, l]
    return torch.where((gc >= 0) & (gc < W2),
                       take(D1T, gc.clamp(0, W2 - 1)), zero)


def k2(a1t, g2a, g2b, g2c, W2: int, D2R: int):
    """K2 for one route instance.  Both forms run the one ``k2_kernel``; a
    k-batched ``a1t`` (kb, A2R, 128, 128) resolves each wire chain once for
    all kb columns and is counted under ``k2_kb``."""
    _value_dtype("a1t", a1t)
    kb = _batch("a1t", a1t, 3)
    A2R = a1t.shape[-3]
    dev = a1t.device
    if not 1 <= A2R <= L or not 1 <= W2 <= L or not 1 <= D2R <= L:
        raise ValueError(f"k2: A2R={A2R}, W2={W2}, D2R={D2R} outside 1..128")
    _check("a1t", a1t, None, a1t.shape[:-3] + (A2R, L, L), dev)
    _check("g2a", g2a, torch.int8, (L, A2R, L), dev)
    _check("g2b", g2b, torch.int8, (L, W2, L), dev)
    _check("g2c", g2c, torch.int8, (L, D2R, L), dev)
    if _route(dev) == "cpu":
        return k2_plain(a1t, g2a, g2b, g2c, W2, D2R)
    out = torch.empty(a1t.shape[:-3] + (L, D2R, L), dtype=a1t.dtype,
                      device=dev)
    args = [a1t.data_ptr(), g2a.data_ptr(), g2b.data_ptr(), g2c.data_ptr(),
            out.data_ptr(), A2R, W2, D2R]
    if kb:
        _launch("k2_kb", a1t.dtype, *args, kb, _stream(dev))
    else:
        _launch("k2", a1t.dtype, *args, _stream(dev))
    return out


# ---------------------------------------------------------------------------
# K3: G3 fold-resolve + DIA windows + single y write
# ---------------------------------------------------------------------------

def _shifted(x, o: int, n: int, nx: int):
    """``w[..., r] = x[..., r + o]`` for r in [0, n), 0 where ``r + o`` is
    outside [0, nx)."""
    lo = max(0, -o)
    start = o + lo
    xp = F.pad(x[..., :nx], (lo, max(0, start + n - (nx + lo))))
    return xp[..., start: start + n]


def _k3_ref(e1s, xb, xrb):
    """The first value operand of a K3 call, which sets its dtype, device
    and batch."""
    return next((t for t in (xb, xrb, *e1s) if t is not None), None)


def k3_plain(e1s, g3s, dv, dia_offsets, adv, anti_offsets, xb, xrb,
             ncols: int, D2R: int):
    """``y[i,p,l] = sum_inst sum_k E1[g3[i,k,p,l], i, p]`` (0 where the wire
    is negative) ``+ sum_d dv[i,d,p,l] * x[row + o_d]`` ``+ sum_a
    adv[i,a,p,l] * xr[row + o'_a]``, in the Pallas kernel's order
    (``fused.py:_build_k3``).  Returns (D2R, 128, 128), or (kb, D2R, 128,
    128) for k-batched E1s (kb, 128, D2R, 128) and x blocks (kb, nb, 128,
    128), column by column the same sums."""
    ref = _k3_ref(e1s, xb, xrb)
    lead = ref.shape[:-3] if ref.dim() == 4 else ()
    zero = torch.zeros((), dtype=ref.dtype, device=ref.device)
    total = torch.zeros(lead + (D2R, L, L), dtype=ref.dtype,
                        device=ref.device)
    for e1, g3 in zip(e1s, g3s):
        E2 = e1.movedim(-3, -1)                       # [i, p, c]
        for k in range(g3.shape[1]):
            idx = g3[:, k].to(torch.int64)
            total = total + torch.where(
                idx >= 0, torch.gather(E2, -1, idx.clamp(min=0)
                                       .expand(total.shape)), zero)
    n = D2R * TILE3
    for xs, offs, vals in ((xb, dia_offsets, dv), (xrb, anti_offsets, adv)):
        for d, o in enumerate(offs):
            w = _shifted(xs.reshape(lead + (-1,)), int(o), n,
                         ncols).view(lead + (D2R, L, L))
            total = total + vals[:, d] * w
    return total


def _ptr_array(ts: Sequence[torch.Tensor]):
    arr = (ctypes.c_void_p * MAX_INSTANCES)()
    for s, t in enumerate(ts):
        arr[s] = t.data_ptr()
    return arr


def k3(e1s, g3s, dv, dia_offsets, adv, anti_offsets, xb, xrb,
       ncols: int, D2R: int):
    """One K3 over <= 8 routed instances + the DIA tables.

    ``e1s[i]`` (128, D2R, 128), ``g3s[i]`` int8 (D2R, K_i, 128, 128);
    ``dv`` (D2R, D, 128, 128) with static ``dia_offsets``; ``adv`` likewise
    with ``anti_offsets`` already rebased to the reversed-x frame; ``xb`` /
    ``xrb`` the x / reversed-x blocks (``_to_blocks``), read as 0 outside
    [0, ncols).  k-batched E1s (kb, 128, D2R, 128) and x blocks (kb, nb,
    128, 128) give (kb, D2R, 128, 128) from the ``_kb`` kernel, which reads
    g3, dv and adv once for all kb columns."""
    if len(e1s) != len(g3s) or len(e1s) > MAX_INSTANCES:
        raise ValueError(f"k3: {len(e1s)} E1 / {len(g3s)} g3 operands "
                         f"(at most {MAX_INSTANCES} instances)")
    ref = _k3_ref(e1s, xb, xrb)
    if ref is None:
        raise ValueError("k3: nothing to combine")
    _value_dtype("k3 operands", ref)
    dev, dt = ref.device, ref.dtype
    kb = _batch("k3 operands", ref, 3)
    lead = ref.shape[:1] if kb else ()
    for e1, g3 in zip(e1s, g3s):
        _check("e1", e1, dt, lead + (L, D2R, L), dev)
        _check("g3", g3, torch.int8, None, dev)
        if g3.dim() != 4 or g3.shape[0] != D2R or g3.shape[2:] != (L, L):
            raise ValueError(f"g3: shape {tuple(g3.shape)}, expected "
                             f"({D2R}, K, {L}, {L})")
    for name, xs, offs, vals in (("dv", xb, dia_offsets, dv),
                                 ("adv", xrb, anti_offsets, adv)):
        if offs:
            _check(name, vals, dt, (D2R, len(offs), L, L), dev)
            _check(name + " x", xs, dt, None, dev)
            if xs.dim() != len(lead) + 3 or xs.shape[:len(lead)] != lead:
                raise ValueError(f"{name}: x blocks of shape "
                                 f"{tuple(xs.shape)} for a batch {lead}")
            if xs[(0,) * len(lead)].numel() < ncols:
                raise ValueError(f"{name}: x blocks hold fewer than "
                                 f"ncols={ncols} values a column")
    if _route(dev) == "cpu":
        return k3_plain(e1s, g3s, dv, dia_offsets, adv, anti_offsets, xb,
                        xrb, ncols, D2R)
    y = torch.empty(lead + (D2R, L, L), dtype=dt, device=dev)
    Ks = (ctypes.c_int * MAX_INSTANCES)(*[g.shape[1] for g in g3s])
    nd, na = len(dia_offsets), len(anti_offsets)
    doff = _offsets_tensor(tuple(dia_offsets), str(dev)) if nd else None
    aoff = _offsets_tensor(tuple(anti_offsets), str(dev)) if na else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = [_ptr_array(e1s), _ptr_array(g3s), Ks, len(e1s),
            ptr(dv) if nd else None, ptr(doff), nd,
            ptr(adv) if na else None, ptr(aoff), na,
            ptr(xb) if nd else None, ptr(xrb) if na else None, ncols, D2R,
            y.data_ptr()]
    if kb:
        # values per column of the x and reversed-x blocks
        args += [kb, xb[0].numel() if nd else 0, xrb[0].numel() if na else 0]
    _launch("k3_kb" if kb else "k3", dt, *args, _stream(dev))
    return y


# ---------------------------------------------------------------------------
# glue (same names and static metas as sparsex_tpu/ops/fused.py)
# ---------------------------------------------------------------------------

# The glue takes x as a vector (ncols,) for the SpMV or k-major (k, ncols),
# k <= MAX_KB, for the SpMM, as the reference's does: every operand and
# result then carries the same leading k axis (``...`` below).

def _to_blocks(x):
    """x (n,) -> ((nb, 128, 128) blocks, nb); zero-pads only when ragged
    (``fused.py:1568``).  k-major x (k, n) gives (k, nb, 128, 128)."""
    n = x.shape[-1]
    nb = max(-(-n // TILE3), 1)
    xp = F.pad(x, (0, nb * TILE3 - n)) if nb * TILE3 != n else x
    return xp.reshape(x.shape[:-1] + (nb, L, L)), nb


def k1_window(q: int, npages: int, style: str) -> Tuple[int, int]:
    """``(align, npages_pad)`` of the page grid a K1 part of ``style``
    reads (``fused.py:1598-1605``): a lane-placed part's window of ``q``
    pages rounds up to a power of two q8, its grid to a multiple of q8
    pages; a dense-tile part's window is ``q`` pages anywhere in a grid of
    ``max(npages, q)`` pages."""
    if k1_style(style)[0]:
        return 1, max(npages, q)
    q8 = _q8(q)
    return q8, max(-(-npages // q8) * q8, q8)


def _k1_x2(x, ncols: int, q: int, npages: int, style: str, x2):
    """The page grid a K1 part of ``style`` reads; reuses a caller-shared
    grid when it is large enough and a multiple of the window's alignment
    (``fused.py:1591``).  k-major x gives a (k, npages, 8, L) grid."""
    align, npages_pad = k1_window(q, npages, style)
    if (x2 is not None and x2.dim() == x.dim() + 2
            and x2.shape[-3] >= npages_pad and x2.shape[-3] % align == 0):
        return x2
    return page_grid(x, ncols, npages_pad)


def fused_delta_a1(meta, arrays, x, ncols: int, x2=None):
    """K1 only: the delta segment's (T*8, L) routed grid, in the plan's
    style ``meta[6]`` (``lp``, or ``sl`` where lane placement failed);
    (k, T*8, L) for k-major x.  Hybrid plans (``meta[7]`` set, bulk and
    tail both ``lp``) run K1 twice and re-interleave the two outputs
    fold-major through the static slice list (``fused.py:1627``,
    :1647-1663)."""
    T, q, npages = meta[:3]
    style = meta[6] if len(meta) > 6 else "sl"
    pm = meta[7] if len(meta) > 7 else None
    k1_style(style)
    lead = x.shape[:-1]
    if pm is None:
        x2 = _k1_x2(x, ncols, q, npages, style, x2)
        a1 = k1(arrays["plo"], arrays["mg"], arrays["vals"], x2, q, style)
        return a1.reshape(lead + (T * 8, L))
    (T2, q2, npages2, style2), inter = pm
    k1_style(style2)
    # one shared page grid, aligned for the LARGER window
    x2 = _k1_x2(x, ncols, max(q, q2), max(npages, npages2), "lp", x2)
    a1a = k1(arrays["plo"], arrays["mg"], arrays["vals"], x2, q, style)
    a1b = k1(arrays["plo2"], arrays["mg2"], arrays["vals2"], x2, q2, style2)
    segs = [(a1a if pid == 0 else a1b)[..., lo:hi, :, :]
            for pid, lo, hi in inter]
    a1 = torch.cat(segs, dim=-3) if len(segs) > 1 else segs[0]
    return a1.reshape(lead + (-1, L))


def _instance_e1(meta_i, i, arrays, src, D2R: int, g1: bool):
    """One route instance over the source grid ``src`` (S, L), or k-major
    (k, S, L): its rows ``a0:a1`` zero-padded from S1c to S1p
    (``fused.py:777``), the G1 lane gather through ``g1_{i}`` where ``g1``,
    T1 and K2.  Returns the ``(e1, g3, K, um3)`` entry for
    :func:`k3_combine`."""
    S1c, S1p, A2R, _D2Ri, _Dp, K, W2, a0, a1 = meta_i[:9]
    um = meta_i[9] if len(meta_i) > 9 else 0
    Si = src[..., a0:a1, :]
    if S1p != S1c:
        Si = F.pad(Si, (0, 0, 0, S1p - S1c))
    Si = Si.contiguous()
    if g1:
        Si = route.lane_gather(Si, arrays[f"g1_{i}"][None])
    e1 = k2(t1(Si, A2R), arrays[f"g2a_{i}"], arrays[f"g2b_{i}"],
            arrays[f"g2c_{i}"], W2, D2R)
    return e1, arrays[f"g3_{i}"], K, bool(um & 2)


def _e1s_from_a1(inst, arrays, A1, D2R: int):
    """Per-instance T1 + K2 over slices of the A1 grid (S, L), or k-major
    (k, S, L), whose rows K1 has already routed."""
    return [_instance_e1(m, i, arrays, A1, D2R, False)
            for i, m in enumerate(inst)]


def fused_delta_e1s(meta, arrays, x, ncols: int, nrows_part: int, x2=None):
    """K1 + T1 + K2 for the delta elements (``fused.py:1666``)."""
    D2R = _d2r(nrows_part)
    A1 = fused_delta_a1(meta, arrays, x, ncols, x2=x2)
    return _e1s_from_a1(meta[3], arrays, A1, D2R)


def fused_run_a1(meta, arrays, x, ncols: int, x2=None):
    """K1 (style ``rlp{W}`` or ``run{W}``) only: the run segment's (T*8, L)
    grid, (k, T*8, L) for k-major x (``fused.py:764``); ``meta = (T, q,
    npages, inst, n_res, style)``."""
    T, q, npages = meta[:3]
    x2 = _k1_x2(x, ncols, q, npages, meta[5], x2)
    a1 = k1(arrays["plo"], arrays["mg"], arrays["vals"], x2, q, meta[5])
    return a1.reshape(x.shape[:-1] + (T * 8, L))


def fused_run_e1s(meta, arrays, x, ncols: int, nrows_part: int, x2=None):
    """K1 (run style) + T1 + K2 per route instance (``fused.py:804``)."""
    A1 = fused_run_a1(meta, arrays, x, ncols, x2=x2)
    return _e1s_from_a1(meta[3], arrays, A1, _d2r(nrows_part))


def merged_e1s(inst_meta, arrays, src_global, nrows_part: int):
    """Per-instance G1 + T1 + K2 over the concatenated RAW source grid
    (S, L), or k-major (k, S, L), of every fused segment
    (``fused.py:882``).  G1 is the lane gather, run per instance: merged
    instances may overlap in source rows and colour them independently, so
    their G1 wires are never unioned."""
    D2R = _d2r(nrows_part)
    return [_instance_e1(m, i, arrays, src_global, D2R, True)
            for i, m in enumerate(inst_meta)]


def partial_segment_e1s(inst_meta, arrays, partials_flat, nrows_part: int):
    """G1 + T1 + K2 per instance over a flat partial stream (``fs``,
    ``fused.py:1740``): ``partials_flat`` (M_pad,), a multiple of 128
    long, is the (M_pad / 128, 128) source grid of the instances of
    ``plan_partial_segment``.  Returns the ``(e1, g3, K, um3)`` list for
    :func:`k3_combine`."""
    if partials_flat.dim() != 1 or partials_flat.shape[0] % L:
        raise ValueError(f"partials: shape {tuple(partials_flat.shape)} is "
                         f"not a flat stream of whole {L}-lane rows")
    return merged_e1s(inst_meta, arrays, partials_flat.view(-1, L),
                      nrows_part)


def k3_combine(e1_g3, dia_pack, x, nrows_part: int, ncols: int):
    """One K3 over every routed instance + every DIA table: y written once
    (``fused.py:1774``).  More than MAX_INSTANCES instances split into
    several K3 calls, the first carrying the DIA tables; anti-diagonal
    offsets ``s`` rebase to ``ncols-1-s`` over the reversed x.  k-major x
    (k, ncols) with k-major E1s gives (k, nrows_part)."""
    if len(e1_g3) > MAX_INSTANCES:
        head = k3_combine(e1_g3[:MAX_INSTANCES], dia_pack, x, nrows_part,
                          ncols)
        tail = k3_combine(e1_g3[MAX_INSTANCES:], ((), None, (), None), x,
                          nrows_part, ncols)
        return head + tail
    dia_offsets, dv, anti_offsets, adv = dia_pack
    D2R = _d2r(nrows_part)
    xb = _to_blocks(x)[0] if dia_offsets else None
    if anti_offsets:
        xrb = _to_blocks(torch.flip(x, (-1,)))[0]
        anti_rebased = tuple(ncols - 1 - s for s in anti_offsets)
    else:
        xrb, anti_rebased = None, ()
    y3 = k3([e for e, _, _, _ in e1_g3], [g for _, g, _, _ in e1_g3],
            dv, tuple(dia_offsets), adv, anti_rebased, xb, xrb, ncols, D2R)
    acc = y3.reshape(x.shape[:-1] + (-1,))
    return acc[..., :nrows_part] if acc.shape[-1] != nrows_part else acc


def add_products(acc, vals, cols, dest, x, ncols: int):
    """``acc[dest] += vals * x[cols]`` in place, columns clamped to
    [0, ncols) (the reference's ``take(mode="clip")``); k-major x and acc
    take the same products column by column."""
    return add_totals(acc, vals * x[..., cols.clamp(0, ncols - 1)], dest)


# the CUDA kernels whose launches ``launches`` counts (K1 under one key
# per style family: lp, rlp{W}, sl, run{W}; the lane gather is launched
# from ``ops/route.py``, dia / delta_pages / delta_pages_acc /
# paged_gather / paged_units from ``ops/pallas_kernels.py``), then the
# k-batched (SpMM) variants, each under its kernel's key + ``_kb``
KB_KERNELS = ("k1_kb", "k1_rlp_kb", "k1_sl_kb", "k1_run_kb", "t1_kb",
              "k2_kb", "k3_kb", "lane_gather_kb")
KERNELS = ("k1", "k1_rlp", "k1_sl", "k1_run", "t1", "k2", "k3",
           "lane_gather", "dia", "delta_pages", "delta_pages_acc",
           "paged_gather", "paged_units") + KB_KERNELS


def launch_counts() -> Dict[str, int]:
    return {k: int(launches[k]) for k in KERNELS}


__all__: List[str] = [
    "build_fused_delta", "build_fused_run", "merge_segment_plan",
    "pad_dias_for_k3", "pack_k1_meta", "instance_g1", "instances_overlap",
    "plan_partial_segment", "k1",
    "k1_key", "k1_plain", "k1_style", "k1_window", "k1_x_index", "t1",
    "t1_plain", "k2", "k2_plain", "k3", "k3_plain", "k3_combine", "fused_delta_a1",
    "fused_delta_e1s", "fused_run_a1", "fused_run_e1s", "merged_e1s",
    "partial_segment_e1s",
    "add_products", "add_totals", "launches", "launch_counts", "KERNELS",
    "KB_KERNELS", "MAX_KB",
]
