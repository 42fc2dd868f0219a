"""The scatter-routing network's planner and lane gather on PyTorch.

Counterpart of ``sparsex_tpu/ops/route.py``.  Its host half is the port's
own copy (``build_scatter_plan``, ``demote_small_instances``,
``fold_sort_key`` and the NumPy reference ``apply_scatter_plan_np``;
unchanged NumPy, with the C++ edge colouring of ``native/``), so both
packages plan the same wires.  Its device half, the ``_build_lane_gather``
Pallas kernel, is the CUDA kernel of ``csrc/route.cu``: ``lane_gather``
launches it on a CUDA tensor and runs ``lane_gather_plain`` only on a CPU
tensor; each launch adds one to ``ops.fused.launches["lane_gather"]``.
``apply_scatter_plan``, the routed scatter-add of a legacy plan, is five
lane gathers per route instance with torch transposes and pads between
them, as the reference's is XLA glue around its Pallas gathers.

The copied planner keeps the reference's comments, which cite its TPU
measurements (the thresholds' origins); none of them is a number of the
port.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparsex_tpu_torch.ops._launch import (L, _batch, _check, _launch,
                                           _route, _stream, _value_dtype)

# ---------------------------------------------------------------------------
# the planner (copied from sparsex_tpu/ops/route.py:45-421)
# ---------------------------------------------------------------------------

MAX_DEST_ROWS = 16384           # D' cap: n_dest <= 2,097,152
CHUNK_SRC_ROWS = 16384          # source rows per pipeline chunk
MAX_FOLDS = 8                   # network instances per chunk
MIN_ELEMS = 1 << 15             # below this the XLA scatter is cheaper
# A fold instance's cost is ~flat (K2's color-grid passes + the
# D2R-sized E1/g3 streams) regardless of how few edges it carries,
# while a residual element costs ~13 ns (serialized gather +
# scatter-add).  r4 measured the instance at ~50-60 us (threshold
# 4096); the r5 unmasked kernels + batched transposes cut it to
# ~25-30 us, so the break-even moved to ~2k edges — diagc's 4,083-edge
# fold is now cheaper kept as an instance than serialized (53 us res).
RES_DEMOTE_ELEMS = 2048


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _rank_within(keys: np.ndarray) -> np.ndarray:
    """Stable rank of each element among equal keys (0-based)."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    rank = np.arange(ks.size) - np.searchsorted(ks, ks)
    out = np.empty(keys.size, dtype=np.int64)
    out[order] = rank
    return out


def fold_sort_key(dest: np.ndarray, n_dest: int, tiebreak: np.ndarray):
    """Sort key grouping elements by their capacity fold (page-rank // 128)
    then by ``tiebreak`` (e.g. column, for gather-page locality).

    High-multiplicity matrices overflow the 128-elements-per-dest-page
    capacity of one network instance; pre-sorting by fold makes the folds
    source-CONTIGUOUS, so :func:`build_scatter_plan` can cut its chunks at
    fold boundaries and each instance's grids are sized to its own
    elements instead of the whole source.
    """
    dest = np.asarray(dest, dtype=np.int64)
    fold = _rank_within(dest // L) // L
    return fold * (np.int64(np.asarray(tiebreak).max()) + 2) + tiebreak


def _chunk_ranges(dest: np.ndarray, n_dest: int, S1_total: int):
    """Chunk boundaries in source-row space: every CHUNK_SRC_ROWS, plus the
    rows where the element fold steps (no-ops unless the caller pre-sorted
    with :func:`fold_sort_key`)."""
    valid = (dest >= 0) & (dest < n_dest)
    fold = np.full(dest.size, -1, dtype=np.int64)
    idx = np.flatnonzero(valid)
    fold[idx] = _rank_within(dest[idx] // L) // L
    # per-row label: max fold present in the row (monotone when pre-sorted);
    # cut where the fold steps between consecutive fold-carrying rows
    row_fold = fold.reshape(S1_total, L).max(axis=1)
    cuts = {0, S1_total}
    vrows = np.flatnonzero(row_fold >= 0)
    if vrows.size:
        vf = row_fold[vrows]
        cuts.update(int(i) for i in vrows[1:][vf[1:] != vf[:-1]])
    bounds = sorted(cuts)
    ranges = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        for a0 in range(lo, hi, CHUNK_SRC_ROWS):
            ranges.append((a0, min(hi, a0 + CHUNK_SRC_ROWS)))
    return ranges


def build_scatter_plan(dest: np.ndarray, n_dest: int, max_k: int = 8,
                       min_elems: int = None,
                       uniform_chunks: bool = False,
                       ranges=None, max_folds: int = None,
                       max_res_frac: float = 0.25):
    """Plan the routing network for ``out[d] += src[e]`` over all e with
    ``dest[e] == d``.

    ``dest``: (M,) int; entries outside [0, n_dest) mark padding (those
    source lanes are never read).  M must be a multiple of 128.

    ``uniform_chunks`` forces fixed CHUNK_SRC_ROWS boundaries (the stacked
    SPMD planner needs identical chunk slots across shards); otherwise
    chunks additionally split at capacity-fold boundaries, which keeps
    high-multiplicity plans proportional to their elements when the caller
    pre-sorted with :func:`fold_sort_key`.

    Returns ``(metas, arrays, res_pos, res_dest)`` — per-instance static
    metas + index-array pytrees, plus residual element positions and
    destinations that exceeded network capacity (route those few via
    ``.at[].add``) — or None when the layout is not applicable.
    """
    from sparsex_tpu_torch import native

    if min_elems is None:
        min_elems = MIN_ELEMS
    if max_folds is None:
        max_folds = MAX_FOLDS
    dest = np.asarray(dest)
    M = dest.size
    if M % L or n_dest <= 0:
        return None
    Dq = -(-n_dest // L)
    if Dq > MAX_DEST_ROWS:
        return None
    valid_all = (dest >= 0) & (dest < n_dest)
    n_valid = int(valid_all.sum())
    if n_valid < min_elems:
        return None

    S1_total = M // L
    D2R = -(-Dq // L)
    Dp = max(_ceil_to(Dq, 64), 64)

    metas: List[Tuple] = []
    arrays: List[Dict[str, np.ndarray]] = []
    res_pos_all: List[np.ndarray] = []

    if ranges is not None:
        pass          # caller-supplied chunk boundaries (fused pipeline)
    elif uniform_chunks:
        ranges = [(a0, min(S1_total, a0 + CHUNK_SRC_ROWS))
                  for a0 in range(0, S1_total, CHUNK_SRC_ROWS)]
    else:
        ranges = _chunk_ranges(dest.astype(np.int64), n_dest, S1_total)

    for a0, a1 in ranges:
        e0, e1 = a0 * L, a1 * L
        dch = dest[e0:e1].astype(np.int64)
        pos0 = np.flatnonzero(valid_all[e0:e1])
        dv = dch[pos0]
        pages = dv // L

        fold = _rank_within(pages) // L
        res = fold >= max_folds
        S1c = a1 - a0
        S1p = _ceil_to(S1c, L)
        A2R = S1p // L

        for f in range(int(fold.max()) + 1 if fold.size else 0):
            if f >= max_folds:
                break
            sel = np.flatnonzero(fold == f)
            pos = pos0[sel]
            d = dv[sel]
            kf = _rank_within(d)
            # Adaptive K (r5): a g3 plane costs ~D2R*60 ns per SpMV
            # (its (D2R, L, L) i8 read + the K3 lane gathers), while a
            # residual element costs ~13 ns on the serialized XLA path.
            # Shave rank planes whose element count is cheaper as
            # residuals (headline: K 6 -> 4 for ~230 extra residuals,
            # PROFILE_r05 g3 was 6.3 MB at 6% fill).
            k_cap = max_k
            if kf.size:
                D2R_ = -(-Dq // L)
                plane_el = max(1, int(D2R_ * 60 / 13))
                hist = np.bincount(np.minimum(kf, max_k))
                tail_counts = np.cumsum(hist[::-1])[::-1]
                while k_cap > 1:
                    c = k_cap - 1
                    cnt = (int(tail_counts[c])
                           if c < tail_counts.size else 0)
                    if cnt >= plane_el:
                        break
                    k_cap -= 1
            over = kf >= k_cap
            if over.any():
                res_idx = sel[over]
                res[res_idx] = True
                keep = ~over
                sel = sel[keep]
                pos, d, kf = pos[keep], d[keep], kf[keep]
            if pos.size == 0:
                continue
            K = int(kf.max()) + 1

            a = pos // L                    # source row (chunk-local)
            lane_src = pos % L
            page = d // L
            j = d % L

            # --- outer coloring: source rows x dest pages, 128 colors ---
            c = native.color_bipartite(a, page, S1c, Dq, L)
            if c is None:  # cannot happen (degrees <= 128 by build)
                return None
            dsr = page // L
            asr = a // L
            # --- inner coloring: disjoint union over outer colors; the
            # color count W2 (a power of two >= the max inner degree) sets
            # the middle-grid row count L*W2, so lightly-loaded networks
            # stay small ---
            key_src = c * A2R + asr
            key_dst = c * D2R + dsr
            deg = max(int(np.bincount(key_src, minlength=1).max()),
                      int(np.bincount(key_dst, minlength=1).max()))
            W2 = 1 << max(int(np.ceil(np.log2(max(deg, 1)))), 0)
            W2 = min(max(W2, 8), L)
            c2 = native.color_bipartite(key_src, key_dst,
                                        L * A2R, L * D2R, W2)
            if c2 is None:
                return None

            # --- index arrays; -1 = masked (emit 0).  Every index is a
            # lane number < 128, so int8 halves-of-halves the dominant
            # HBM stream of the apply pipeline. ---
            g1 = np.full((S1p, L), -1, dtype=np.int8)
            g1[a, c] = lane_src.astype(np.int8)
            g2a = np.full((L * A2R, L), -1, dtype=np.int8)
            g2a[c * A2R + asr, c2] = (a % L).astype(np.int8)
            g2b = np.full((L * W2, L), -1, dtype=np.int8)
            g2b[c * W2 + c2, dsr] = asr.astype(np.int8)
            g2c = np.full((L * D2R, L), -1, dtype=np.int8)
            g2c[c * D2R + dsr, page % L] = c2.astype(np.int8)
            g3 = np.full((K, Dp, L), -1, dtype=np.int8)
            g3[kf, page, j] = c.astype(np.int8)

            # --- unmask remap: every -1 wire repoints at a lane whose
            # VALUE is a guaranteed zero, so the apply kernels drop the
            # maximum+where mask ops (K2 was op-bound, PROFILE_r05).
            # For g2a/g2b/g2c a zero lane exists whenever a -1 does:
            # the value-row occupancy count equals the wire-row use
            # count (each element contributes exactly one of each), so
            # "used < 128" on the wire side implies an unoccupied (=
            # exact zero) value lane.  g3 lacks that bijection — rank
            # planes split a page's elements — so it only unmasks when
            # every page with a -1 has an unused color lane (bit 1 of
            # the ``um`` bitmask appended to the meta). ---
            occ_a = np.zeros((L * A2R, L), dtype=bool)
            occ_a[c * A2R + asr, a % L] = True
            occ_b = np.zeros((L * W2, L), dtype=bool)
            occ_b[c * W2 + c2, asr] = True
            # g2b remap targets must stay under ceil8(A2R): the unmasked
            # K2 batches several colors' transposed C1 blocks into one
            # (128, 128) square and bakes a per-color lane offset into
            # the wires (fused._g2b_lane_offset) — lanes past the A2R8
            # pad belong to the NEXT color's block.  Lanes [A2R, A2R8)
            # are that block's zero pad, so they are safe targets.
            a2r8 = min(L, -(-A2R // 8) * 8)
            occ_b[:, a2r8:] = True
            occ_c = np.zeros((L * D2R, L), dtype=bool)
            occ_c[c * D2R + dsr, c2] = True
            um = 1
            for w, occ in ((g2a, occ_a), (g2b, occ_b), (g2c, occ_c)):
                zl = np.argmin(occ, axis=1)      # first zero-value lane
                bad = occ[np.arange(occ.shape[0]), zl]  # row fully used
                need = w == -1
                rows_need = need.any(axis=1)
                if bool((bad & rows_need).any()):  # cannot happen; guard
                    um = 0
                    break
                w[need] = np.broadcast_to(
                    zl.astype(np.int8)[:, None], w.shape)[need]
            if um:
                occ_p = np.zeros((Dp, L), dtype=bool)
                occ_p[page, c] = True
                zl3 = np.argmin(occ_p, axis=1)
                bad3 = occ_p[np.arange(Dp), zl3]
                need3 = g3 == -1
                rows3 = need3.any(axis=(0, 2))
                if not bool((bad3 & rows3).any()):
                    g3[need3] = np.broadcast_to(
                        zl3.astype(np.int8)[None, :, None],
                        g3.shape)[need3]
                    um |= 2

            metas.append((S1c, S1p, A2R, D2R, Dp, K, W2, a0, a1, um))
            arrays.append({"g1": g1, "g2a": g2a, "g2b": g2b, "g2c": g2c,
                           "g3": g3})
        res_pos_all.append(pos0[res] + e0)

    res_pos = (np.concatenate(res_pos_all) if res_pos_all
               else np.zeros(0, dtype=np.int64))
    if res_pos.size > n_valid * max_res_frac:
        # too much residual: the plan would not pay off.  Say so — the
        # caller falls back to the serialized XLA scatter (~17x slower
        # per element), which must never happen silently.
        from sparsex_tpu_torch.logger import log_warning
        log_warning(
            "scatter-route plan rejected: %d of %d elements exceed "
            "network capacity (folds>%d or k>%d); falling back to the "
            "serialized XLA scatter for this table",
            res_pos.size, n_valid, max_folds, max_k)
        return None
    res_dest = dest[res_pos].astype(np.int32)
    return tuple(metas), arrays, res_pos.astype(np.int32), res_dest


def demote_small_instances(plan, dest: np.ndarray,
                           min_elems: int = None):
    """Convert route instances carrying fewer than ``min_elems`` edges
    into residual elements.

    An instance's runtime cost is ~flat (G1 grid + T1 + K2's color-grid
    transposes, ~50-60 us measured) no matter how few edges it carries,
    while a residual element costs ~13 ns (serialized gather +
    scatter-add); below ~4,500 edges the residual is cheaper.  The blocky
    bench matrix spent a full pipeline pass on a 1,992-edge overflow
    fold, and the diag-class matrix on two sub-4k fold chunks.

    Called by the single-chip fused planners AFTER
    :func:`build_scatter_plan` (the stacked SPMD planner must not demote:
    shard slots have to stay identical).  At least one instance is kept,
    and the total demoted volume is capped at ``4 * min_elems`` so a
    pathological plan cannot silently become one big serialized scatter.
    """
    if min_elems is None:
        min_elems = RES_DEMOTE_ELEMS   # late-bound: tests tune the module
    metas, arrs, res_pos, res_dest = plan
    if len(metas) <= 1:
        return plan
    counts = [int((a["g1"] != -1).sum()) for a in arrs]
    victims = [i for i, c in enumerate(counts) if c < min_elems]
    # keep at least one instance; cap total demoted volume
    if len(victims) == len(metas):
        victims.remove(max(victims, key=lambda i: counts[i]))
    victims.sort(key=lambda i: counts[i])
    total, chosen = 0, []
    for i in victims:
        if total + counts[i] > 4 * min_elems:
            break
        total += counts[i]
        chosen.append(i)
    if not chosen:
        return plan
    chosen_set = set(chosen)
    new_pos = [res_pos.astype(np.int64)]
    for i in chosen:
        g1 = arrs[i]["g1"]
        S1c, a0 = metas[i][0], metas[i][7]
        r, c = np.nonzero(g1[:S1c] != -1)
        new_pos.append((a0 + r) * L + g1[:S1c][r, c].astype(np.int64))
    res_pos = np.concatenate(new_pos)
    res_dest = dest[res_pos].astype(np.int32)
    metas = tuple(m for i, m in enumerate(metas) if i not in chosen_set)
    arrs = [a for i, a in enumerate(arrs) if i not in chosen_set]
    return metas, arrs, res_pos.astype(np.int32), res_dest


# ---------------------------------------------------------------------------
# apply: the 5-gather/2-transpose pipeline (the NumPy reference)
# ---------------------------------------------------------------------------
def _take_masked_np(x: np.ndarray, idx: np.ndarray) -> np.ndarray:
    g = np.take_along_axis(x, np.maximum(idx, 0).astype(np.int64), axis=1)
    return np.where(idx >= 0, g, np.zeros((), dtype=x.dtype))


def _route_instance_np(src2d, arrs, meta):
    """NumPy reference of one instance's pipeline (tests / verification)."""
    S1c, S1p, A2R, D2R, Dp, K, W2, a0, a1 = meta[:9]
    A0 = np.zeros((S1p, L), dtype=src2d.dtype)
    A0[:S1c] = src2d
    A1 = _take_masked_np(A0, arrs["g1"])
    B = A1.T.reshape(L, A2R, L)                       # rows c, (asr, a%128)
    C1 = _take_masked_np(B.reshape(L * A2R, L), arrs["g2a"])
    C2 = np.transpose(C1.reshape(L, A2R, L), (0, 2, 1))[:, :W2]
    C2p = np.zeros((L, W2, L), dtype=src2d.dtype)
    C2p[:, :, :A2R] = C2                              # rows (c, c2)
    D1 = _take_masked_np(C2p.reshape(L * W2, L), arrs["g2b"])
    D2 = np.transpose(D1.reshape(L, W2, L)[:, :, :D2R], (0, 2, 1))
    if W2 == L:
        D2p = D2
    else:
        D2p = np.zeros((L, D2R, L), dtype=src2d.dtype)
        D2p[:, :, :W2] = D2                           # rows (c, dsr)
    E1 = _take_masked_np(D2p.reshape(L * D2R, L), arrs["g2c"])
    E2 = E1.reshape(L, D2R * L)[:, :Dp].T             # rows p, lane c
    out = sum(_take_masked_np(E2, arrs["g3"][k])
              for k in range(arrs["g3"].shape[0]))
    return out.reshape(-1)


def apply_scatter_plan_np(metas, arrays, src: np.ndarray,
                          n_dest: int) -> np.ndarray:
    y = np.zeros(n_dest, dtype=src.dtype)
    for meta, arrs in zip(metas, arrays):
        S1c, a0, a1 = meta[0], meta[7], meta[8]
        src2d = src[a0 * L: a1 * L].reshape(S1c, L)
        y = y + _route_instance_np(src2d, arrs, meta)[:n_dest]
    return y


# ---------------------------------------------------------------------------
# the lane gather (replaces route.py:_build_lane_gather)
# ---------------------------------------------------------------------------



def lane_gather_plain(x, idx):
    """``out[r, j] = sum_k (idx[k,r,j] >= 0 ? x[r, idx[k,r,j]] : 0)``, summed
    from 0 in wire order (``route.py:_build_lane_gather``); a k-batched x
    (kb, R, 128) takes the same wires in every column."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    acc = torch.zeros_like(x)
    for k in range(idx.shape[0]):
        w = idx[k].to(torch.int64)
        acc = acc + torch.where(w >= 0, torch.gather(
            x, -1, w.clamp(min=0).expand(x.shape)), zero)
    return acc


def lane_gather(x, idx):
    """The lane gather of ``x`` (R, 128) through ``idx`` (K, R, 128) int8
    wires; returns (R, 128).  A k-batched x (kb, R, 128), kb <= MAX_KB,
    runs the ``_kb`` kernel, which reads the wires once for all kb
    columns.  The SpMV kernel loads x as 16-byte vectors and the wires as
    4-byte words: on the card an x off a 16-byte boundary, or idx off a
    4-byte one, raises (CUDA error 1)."""
    _value_dtype("x", x)
    kb = _batch("x", x, 2)
    if x.shape[-1] != L:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (R, {L})")
    _check("x", x)
    R = x.shape[-2]
    if idx.dim() != 3 or idx.shape[0] < 1:
        raise ValueError(f"idx: shape {tuple(idx.shape)}, expected "
                         f"(K, {R}, {L}) with K >= 1")
    _check("idx", idx, torch.int8, (idx.shape[0], R, L), x.device)
    if _route(x.device) == "cpu":
        return lane_gather_plain(x, idx)
    out = torch.empty_like(x)
    args = [x.data_ptr(), idx.data_ptr(), out.data_ptr(), R, idx.shape[0]]
    if kb:
        _launch("lane_gather_kb", x.dtype, *args, kb, _stream(x.device))
    else:
        _launch("lane_gather", x.dtype, *args, _stream(x.device))
    return out


def apply_scatter_plan(metas, arrays, src, n_dest: int, gather=None):
    """Dense (n_dest,) scatter-add of the flat source values ``src`` through
    the plan's route instances (``route.py:apply_scatter_plan``, :491-529):
    per instance five lane gathers (g1, g2a, g2b, g2c and the K planes of
    g3) with the reference's transposes and zero pads between them, each
    made contiguous (the lane gather takes whole 128-lane rows); the
    instances' outputs summed in plan order.  ``arrays`` holds each
    instance's wires as ``(K, R, 128)`` int8 (K = 1 but for g3).  Masked
    source lanes are never read, so no zeroing is needed.  ``gather``
    (default :func:`lane_gather`) takes the place of the lane gather, as
    ``chip_smoke.py`` uses it to see each stage's input."""
    gather = gather or lane_gather
    y = None
    for meta, arrs in zip(metas, arrays):
        S1c, S1p, A2R, D2R, Dp, _K, W2, a0, a1 = meta[:9]
        A0 = F.pad(src[a0 * L: a1 * L].view(S1c, L),
                   (0, 0, 0, S1p - S1c)).contiguous()
        A1 = gather(A0, arrs["g1"])
        B = A1.t().contiguous().view(L * A2R, L)      # rows (c, asr)
        C1 = gather(B, arrs["g2a"])
        C2 = C1.view(L, A2R, L).transpose(1, 2)[:, :W2]
        C2p = F.pad(C2, (0, L - A2R)).contiguous()     # rows (c, c2)
        D1 = gather(C2p.view(L * W2, L), arrs["g2b"])
        D2 = D1.view(L, W2, L)[:, :, :D2R].transpose(1, 2)
        D2p = F.pad(D2, (0, L - W2)).contiguous()      # rows (c, dsr)
        E1 = gather(D2p.view(L * D2R, L), arrs["g2c"])
        E2 = E1.view(L, D2R * L)[:, :Dp].t().contiguous()  # rows p
        part = gather(E2, arrs["g3"]).view(-1)
        y = part if y is None else y + part
    return y[:n_dest]


__all__ = ["apply_scatter_plan", "apply_scatter_plan_np",
           "build_scatter_plan",
           "demote_small_instances", "fold_sort_key", "lane_gather",
           "lane_gather_plain"]
