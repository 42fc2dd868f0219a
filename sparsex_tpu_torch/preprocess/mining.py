"""DRLE substructure mining, fully vectorized.

The port's own copy of ``sparsex_tpu/preprocess/mining.py``,
with its imports pointed at ``sparsex_tpu_torch``: it behaves as the
reference does, so both packages plan alike.

Re-implements the reference's delta run-length-encoding miner
(``include/sparsex/internals/EncodingManager.hpp``: ``UpdateStats``
:1321-1408, ``UpdateStatsBlock`` :1410-1487, ``DoEncode`` :1003-1082) as
NumPy array passes instead of per-element C++ loops:

1. transform coordinates to the candidate iteration order, lexsort;
2. delta-encode column gaps within each transformed row;
3. run-length encode the deltas (maximal runs of a constant gap);
4. select pattern runs: a run of ``f`` equal deltas covers ``f`` elements,
   plus the immediately preceding element when it is not claimed by the
   previous pattern run (the reference's non-NUMA "include the previous
   element" rule); patterns require ``count >= min_unit_size`` and at least
   two equal deltas; runs longer than ``max_unit_size`` split into units,
   sub-``min`` remainders return to singles;
5. block types consider only gap-1 runs, align the start to the block
   dimension, and require at least 2 block columns (``other_dim >= 2``).

The inter-run dependency (a run may only absorb its predecessor element when
the adjacent previous run was not selected) is resolved with a vectorized
alternating-parity scan over chains of ambiguous runs, so the whole miner is
O(nnz log nnz) NumPy with no Python-per-element loops.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


def take1(arr: np.ndarray, order: np.ndarray) -> np.ndarray:
    """arr[order] via the threaded native permute when profitable."""
    from sparsex_tpu_torch import native
    return native.take1(np.ascontiguousarray(arr), order)


def covered_mask(start_elem: np.ndarray, count: np.ndarray,
                 m: int) -> np.ndarray:
    """Boolean coverage mask over m sorted elements for runs
    [start, start+count) — native scan, diff/cumsum fallback."""
    from sparsex_tpu_torch import native
    out = native.mark_covered(start_elem, count, m)
    if out is not None:
        return out
    diff = np.zeros(m + 1, dtype=np.int64)
    np.add.at(diff, start_elem, 1)
    np.add.at(diff, np.minimum(start_elem + count, m), -1)
    return np.cumsum(diff[:-1]) > 0


def lexsort_rc(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Row-major lexsort permutation (native radix sort when available —
    the Transform hot path is sort-bound, SURVEY §3.1)."""
    from sparsex_tpu_torch import native
    if rows.size > 4096:  # ctypes overhead not worth it for tiny inputs
        order = native.lexsort_rc(np.asarray(rows, dtype=np.int64),
                                  np.asarray(cols, dtype=np.int64))
        if order is not None:
            return order
    return np.lexsort((cols, rows))


def is_sorted_rc(rows: np.ndarray, cols: np.ndarray) -> bool:
    """Whether (rows, cols) is already STRICTLY row-major sorted.

    Two cheap sequential passes vs the ~10 memory passes of a full radix
    sort + 3 permutes — the tune pipeline's inputs usually arrive sorted
    (the MMF loader enforces it, ``from_coo`` sorts once), so every later
    stage checks before re-sorting (measured: 2 of the 3 full-size
    sort+permute groups on the headline bench matrix were redundant)."""
    if rows.size < 2:
        return True
    dr = rows[1:] != rows[:-1]
    up_r = rows[1:] > rows[:-1]
    if int(np.count_nonzero(dr)) != int(np.count_nonzero(up_r)):
        return False  # some row decreased
    return bool(np.all(dr | (cols[1:] > cols[:-1])))


@dataclass
class RunUnits:
    """Pattern units found for one (type, delta) instantiation.

    ``heads`` are positions into the miner's sorted element order; a unit's
    elements are the ``size`` consecutive sorted positions starting there.
    """

    delta: int
    heads: np.ndarray  # (U,) int64 — sorted-order position of first element
    sizes: np.ndarray  # (U,) int64 — number of elements (nnz) in the unit


@dataclass
class BlockRuns:
    """Raw aligned dense-block runs (before second-dim splitting).

    Each run is a dense ``align x other_dim`` block: ``other_dim * align``
    consecutive sorted elements starting at ``heads`` (tcol-aligned).
    """

    align: int
    heads: np.ndarray       # (K,) sorted-order position of first element
    other_dims: np.ndarray  # (K,) number of block columns (>= 2)


@dataclass
class MiningResult:
    order: np.ndarray             # lexsort order applied to the inputs
    trows: np.ndarray             # sorted transformed rows
    tcols: np.ndarray             # sorted transformed cols
    runs: List[RunUnits] = field(default_factory=list)
    block_runs: Optional[BlockRuns] = None
    covered: Optional[np.ndarray] = None  # bool mask over sorted elements


def _segment_runs(trows: np.ndarray, tcols: np.ndarray):
    """RLE over within-row column deltas.

    Returns (j0, f, delta, adjacent) per maximal run: ``j0`` the delta-index
    of the run start (element index of the first delta element is ``j0+1``),
    ``f`` the run length in deltas, ``delta`` the gap, and ``adjacent`` true
    when the run immediately follows the previous run in the same row.

    Dispatches to the native C++ scan (``native/kernels.cpp``
    ``spx_segment_runs``) when available; the NumPy path below is the
    fallback and the correctness reference for it.
    """
    from sparsex_tpu_torch import native
    res = native.segment_runs(trows, tcols)
    if res is not None:
        return res
    return _segment_runs_np(trows, tcols)


def _segment_runs_np(trows: np.ndarray, tcols: np.ndarray):
    """Pure-NumPy segment scan (vectorized fallback)."""
    m = trows.size
    if m < 2:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, np.zeros(0, dtype=bool)
    same = trows[1:] == trows[:-1]
    d = tcols[1:] - tcols[:-1]
    valid = same
    dj = np.arange(m - 1, dtype=np.int64)

    prev_valid = np.concatenate([[False], valid[:-1]])
    prev_d = np.concatenate([[0], d[:-1]])
    run_start = valid & (~prev_valid | (d != prev_d))
    starts = np.flatnonzero(run_start)
    if starts.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, np.zeros(0, dtype=bool)

    # Run end: first j >= start where validity breaks or a new run starts.
    breaks = np.flatnonzero(~valid)
    # For each start, run continues while valid and not a new start.
    next_start = np.concatenate([starts[1:], [m - 1]])
    # Within [start, next_start) validity may break; find first break.
    if breaks.size:
        brk_idx = np.searchsorted(breaks, starts, side="left")
        first_break = np.where(brk_idx < breaks.size, breaks[np.minimum(brk_idx, breaks.size - 1)], m - 1)
    else:
        first_break = np.full(starts.shape, m - 1, dtype=np.int64)
    ends = np.minimum(next_start, first_break)
    f = ends - starts
    delta = d[starts]
    # Adjacent to previous run: previous run's last delta is starts-1.
    adjacent = np.zeros(starts.size, dtype=bool)
    if starts.size > 1:
        adjacent[1:] = starts[1:] == ends[:-1]
    return starts, f, delta, adjacent


def _resolve_patterns(f: np.ndarray, adjacent: np.ndarray,
                      eligible: np.ndarray, min_limit: int) -> np.ndarray:
    """Which runs become patterns, honoring the absorb-previous rule.

    ``eligible`` pre-masks runs whose delta is allowed (e.g., explicit-delta
    encoding).  A run is certain when ``f >= min_limit``; a run with
    ``f == min_limit - 1`` is a pattern only if it can absorb its anchor,
    i.e. the adjacent previous run is not itself a pattern.
    """
    n = f.size
    pattern = np.zeros(n, dtype=bool)
    if n == 0:
        return pattern
    certain = eligible & (f >= max(min_limit, 2))
    ambiguous = eligible & (f == min_limit - 1) & (f >= 2)
    pattern[:] = certain
    if not ambiguous.any():
        return pattern

    # Chains of consecutive ambiguous runs (linked by adjacency) alternate:
    # pattern[k] = not pattern[k-1] within a chain.
    prev_amb = np.concatenate([[False], ambiguous[:-1]])
    chain_start = ambiguous & ~(prev_amb & adjacent)
    # Base value at a chain start: True unless adjacent predecessor is a
    # certain pattern.
    prev_pattern = np.concatenate([[False], certain[:-1]])
    base_at_start = ~(adjacent & prev_pattern)

    amb_idx = np.flatnonzero(ambiguous)
    # chain id per ambiguous run; position within chain
    cs = chain_start[amb_idx]
    chain_id = np.cumsum(cs) - 1
    first_in_chain = np.zeros(chain_id.max() + 1, dtype=np.int64)
    first_in_chain[chain_id[cs]] = amb_idx[cs]
    pos = amb_idx - first_in_chain[chain_id]
    base = base_at_start[first_in_chain[chain_id]]
    pattern[amb_idx] = base ^ (pos % 2 == 1)
    return pattern


def mine_runs(trows: np.ndarray, tcols: np.ndarray, *,
              min_limit: int, max_limit: int,
              allowed_deltas: Optional[np.ndarray] = None,
              presorted: bool = False) -> MiningResult:
    """Mine constant-stride runs (non-block types).

    Returns units grouped per delta plus the coverage mask; caller converts
    sorted positions back to original coordinates via the inverse transform.
    """
    trows = np.asarray(trows, dtype=np.int64)
    tcols = np.asarray(tcols, dtype=np.int64)
    if presorted:
        order = np.arange(trows.size, dtype=np.int64)
        tr, tc = trows, tcols
    else:
        order = lexsort_rc(trows, tcols)
        tr, tc = take1(trows, order), take1(tcols, order)
    res = MiningResult(order=order, trows=tr, tcols=tc)
    m = tr.size
    covered = np.zeros(m, dtype=bool)
    res.covered = covered
    if m < 2:
        return res

    j0, f, delta, adjacent = _segment_runs(tr, tc)
    if j0.size == 0:
        return res

    from sparsex_tpu_torch import native
    sel_native = native.select_units(j0, f, delta, adjacent, m,
                                     min_limit, max_limit, allowed_deltas)
    if sel_native is not None:
        heads, sizes, udelta, cov = sel_native
        covered[:] = cov
        for dv in np.unique(udelta):
            mask = udelta == dv
            res.runs.append(RunUnits(delta=int(dv), heads=heads[mask],
                                     sizes=sizes[mask]))
        return res

    if allowed_deltas is not None:
        eligible = np.isin(delta, np.asarray(allowed_deltas))
    else:
        eligible = delta > 0
    eligible = eligible & (delta > 0)

    pattern = _resolve_patterns(f, adjacent, eligible, min_limit)
    if not pattern.any():
        return res

    prev_pattern = np.concatenate([[False], pattern[:-1]])
    absorbed = pattern & ~(adjacent & prev_pattern)
    # Elements: run k covers sorted positions [start_elem, start_elem+count).
    i0 = j0 + 1  # element index of first delta element
    start_elem = np.where(absorbed, i0 - 1, i0)
    count = f + absorbed.astype(np.int64)

    sel = np.flatnonzero(pattern)
    start_elem = start_elem[sel]
    count = count[sel]
    rdelta = delta[sel]

    # Split into units of <= max_limit; drop sub-min remainders to singles.
    nfull = count // max_limit
    rem = count % max_limit
    keep_rem = rem >= min_limit
    n_units = nfull + keep_rem.astype(np.int64)
    covered_count = nfull * max_limit + np.where(keep_rem, rem, 0)
    ok = n_units > 0
    start_elem, count = start_elem[ok], count[ok]
    rdelta, nfull, rem = rdelta[ok], nfull[ok], rem[ok]
    keep_rem, n_units = keep_rem[ok], n_units[ok]
    covered_count = covered_count[ok]
    if start_elem.size == 0:
        return res

    total_units = int(n_units.sum())
    unit_run = np.repeat(np.arange(n_units.size), n_units)
    excl = np.concatenate([[0], np.cumsum(n_units)[:-1]])
    u = np.arange(total_units, dtype=np.int64) - excl[unit_run]
    heads = start_elem[unit_run] + u * max_limit
    sizes = np.where(u < nfull[unit_run], max_limit, rem[unit_run])
    udelta = rdelta[unit_run]

    covered[:] = covered_mask(start_elem, covered_count, m)

    for dv in np.unique(udelta):
        mask = udelta == dv
        res.runs.append(RunUnits(delta=int(dv), heads=heads[mask],
                                 sizes=sizes[mask]))
    return res


def mine_blocks(trows: np.ndarray, tcols: np.ndarray, *,
                align: int, min_other_dim: int = 2,
                presorted: bool = False) -> MiningResult:
    """Mine aligned dense-block runs (gap-1 runs in block-transformed space).

    Parity with ``UpdateStatsBlock`` (ref ``EncodingManager.hpp:1410-1487``):
    only runs of gap 1 qualify; the run start is advanced to the next
    ``align`` boundary; the usable length is ``other_dim * align`` with
    ``other_dim >= 2`` (>= ``min_other_dim``).
    """
    trows = np.asarray(trows, dtype=np.int64)
    tcols = np.asarray(tcols, dtype=np.int64)
    if presorted:
        order = np.arange(trows.size, dtype=np.int64)
        tr, tc = trows, tcols
    else:
        order = lexsort_rc(trows, tcols)
        tr, tc = take1(trows, order), take1(tcols, order)
    res = MiningResult(order=order, trows=tr, tcols=tc)
    m = tr.size
    covered = np.zeros(m, dtype=bool)
    res.covered = covered
    if m < 2:
        return res

    j0, f, delta, _adj = _segment_runs(tr, tc)
    sel = np.flatnonzero(delta == 1)
    if sel.size == 0:
        return res
    j0, f = j0[sel], f[sel]
    i0 = j0 + 1
    # Blocks always absorb the anchor element (the previous run can never be
    # a gap-1 pattern adjacent to another gap-1 run).
    start_elem = i0 - 1
    count = f + 1

    s_col = tc[start_elem]
    skip_front = (-s_col) % align
    start_elem = start_elem + skip_front
    avail = count - skip_front
    other_dim = np.where(avail > 0, avail // align, 0)
    ok = other_dim >= min_other_dim
    if not ok.any():
        return res
    start_elem, other_dim = start_elem[ok], other_dim[ok]

    covered_count = other_dim * align
    covered[:] = covered_mask(start_elem, covered_count, m)

    res.block_runs = BlockRuns(align=align, heads=start_elem,
                               other_dims=other_dim)
    return res


def split_block_runs(runs: BlockRuns, kmax: int,
                     dominant_k: Optional[int] = None,
                     min_other_dim: int = 2) -> Tuple[np.ndarray, np.ndarray, int]:
    """Split raw block runs into uniform units of ``k`` block-columns.

    The TPU analogue of the reference BlockSplitter
    (``src/internals/Statistics.cpp:50-88``): rather than keeping one unit
    table per observed second dimension, pick the dominant ``k`` (the value
    maximizing encodable nnz) and split every run into units of exactly
    ``k`` columns — uniform units keep the padded device tables dense.

    Returns (unit_heads, n_units_per_run-expanded heads) as (heads, k).
    """
    if runs.heads.size == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64), 0
    other = runs.other_dims
    if dominant_k is None:
        cand = np.unique(np.minimum(other, kmax))
        cand = cand[cand >= min_other_dim]
        if cand.size == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64), 0
        best_k, best_nnz = 0, -1
        for k in cand:
            nnz = int(((other // k) * k).sum()) * runs.align
            if nnz > best_nnz:
                best_k, best_nnz = int(k), nnz
        dominant_k = best_k
    k = int(dominant_k)
    n_units = other // k
    total = int(n_units.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64), k
    unit_run = np.repeat(np.arange(n_units.size), n_units)
    excl = np.concatenate([[0], np.cumsum(n_units)[:-1]])
    u = np.arange(total, dtype=np.int64) - excl[unit_run]
    heads = runs.heads[unit_run] + u * k * runs.align
    sizes = np.full(total, k * runs.align, dtype=np.int64)
    return heads, sizes, k
