"""Encoding selection and extraction — the EncodingManager equivalent.

The port's own copy of ``sparsex_tpu/preprocess/encoder.py``,
with its imports pointed at ``sparsex_tpu_torch``: it behaves as the
reference does, so both packages plan alike.

Parity with ``include/sparsex/internals/EncodingManager.hpp``:

- ``gen_type_stats``  <-> ``GenerateStats``/``GenAllStats`` (:707-813) with
  uniform window sampling (``SelectSplits`` :1489-1516) and scale-up;
- ``type_score``      <-> ``GetTypeScore`` (:836-861): ``ratio`` counts
  ``encoded - patterns``; ``cost`` additionally charges one dispatch switch
  per unit (the TPU analogue: every unit has fixed head/index overhead);
- coverage filtering  <-> ``CoverageFilter`` (``Statistics.hpp:697-756``),
  dropping instantiations below ``min_coverage`` of the partition nnz;
- block splitting     <-> ``BlockSplitter`` (``Statistics.cpp:50-88``), here
  a dominant-second-dim split that keeps device tables uniform;
- ``encode_all``      <-> ``EncodeAll`` (:905-960): greedy pick-best-encode
  loop until no type scores > 0;
- ``encode_serial``   <-> ``EncodeSerial`` (:962-986): user-forced sequence
  with optional explicit deltas.

The element pool starts as the partition's singles; each encode pass removes
the covered elements and appends unit tables, so later passes only mine what
remains (encoded patterns are opaque to further encoding, as in the
reference).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from sparsex_tpu_torch.config import Config
from sparsex_tpu_torch.logger import log_info, log_verbose
from sparsex_tpu_torch.preprocess.encodings import EncType, EncodingSequence
from sparsex_tpu_torch.preprocess.mining import (
    BlockRuns, MiningResult, is_sorted_rc, lexsort_rc, mine_blocks,
    mine_runs, split_block_runs, take1,
)
from sparsex_tpu_torch.preprocess.tables import (
    BlockTable, CsxTables, DeltaTable, RunTable, pack_run_units,
)
from sparsex_tpu_torch.preprocess.xform import from_xform, to_xform
from sparsex_tpu_torch.timing import TimerCollection


@dataclass
class InstStats:
    """StatsData parity: nnz encoded + number of pattern units.

    ``n_groups`` counts distinct diagonals (offsets) for diagonal types —
    the tpu heuristic estimates DIA-fold fill from it."""

    encoded: int = 0
    patterns: int = 0
    n_groups: int = 0


class Encoder:
    """Per-partition encoding pipeline (rows are partition-local)."""

    def __init__(self, nrows: int, ncols: int, rows, cols, vals,
                 config: Optional[Config] = None):
        self.cfg = config or Config.instance()
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if is_sorted_rc(rows, cols):
            # from_coo hands over row-major-sorted shard slices — the
            # check costs 2 passes vs a redundant radix sort + 3 permutes
            self.rows = rows
            self.cols = cols
            self.vals = np.ascontiguousarray(vals)
        else:
            order = lexsort_rc(rows, cols)
            self.rows = take1(rows, order)
            self.cols = take1(cols, order)
            self.vals = take1(np.asarray(vals), order)
        self.nnz_total = int(self.rows.size)
        self.run_tables: List[RunTable] = []
        self.block_tables: List[BlockTable] = []
        self.encoded_types: List[EncType] = []
        self.timers = TimerCollection()
        self.encoding_log: List[str] = []

    # ------------------------------------------------------------------
    # statistics
    # ------------------------------------------------------------------
    def _sample_indices(self) -> Optional[np.ndarray]:
        """Uniform window sampling over the current singles (portion mode);
        window mode uses fixed-size windows.  Returns None for full stats."""
        cfg = self.cfg
        n = self.rows.size
        if cfg.sampling == "none" or n == 0:
            return None
        nr_samples = cfg.nr_samples
        if cfg.sampling == "window" and cfg.window_size > 0:
            win = min(int(cfg.window_size), n)
        else:
            win = int(np.ceil(cfg.sampling_portion * n / max(1, nr_samples)))
            win = max(win, 4 * cfg.min_unit_size)
        if win * nr_samples >= n:
            return None  # sampling covers everything: use full stats
        starts = np.linspace(0, n - win, nr_samples).astype(np.int64)
        idx = (starts[:, None] + np.arange(win)[None, :]).ravel()
        return np.unique(idx)

    def _mine(self, t: EncType, rows: np.ndarray, cols: np.ndarray,
              allowed_deltas: Optional[Sequence[int]] = None) -> MiningResult:
        trows, tcols = to_xform(t, rows, cols, self.nrows, self.ncols)
        # identity xforms (HORIZONTAL) on still-row-major data skip the
        # full sort + permutes; the check is 2 cheap passes
        pre = trows.size > 4096 and is_sorted_rc(trows, tcols)
        if t.is_block:
            return mine_blocks(trows, tcols, align=t.block_alignment,
                               presorted=pre)
        return mine_runs(
            trows, tcols,
            min_limit=self.cfg.min_unit_size,
            max_limit=self.cfg.max_unit_size,
            allowed_deltas=(np.asarray(list(allowed_deltas))
                            if allowed_deltas is not None else None),
            presorted=pre,
        )

    def gen_type_stats(self, t: EncType,
                       sample_idx: Optional[np.ndarray] = None
                       ) -> Dict[int, InstStats]:
        rows, cols = self.rows, self.cols
        scale = 1.0
        if sample_idx is not None and sample_idx.size:
            rows, cols = rows[sample_idx], cols[sample_idx]
            scale = self.rows.size / max(1, sample_idx.size)
        res = self._mine(t, rows, cols)
        stats: Dict[int, InstStats] = {}
        if t.is_block:
            if res.block_runs is not None:
                br = res.block_runs
                for k in np.unique(br.other_dims):
                    m = br.other_dims == k
                    s = stats.setdefault(int(k), InstStats())
                    s.encoded += int(scale * m.sum() * k * br.align)
                    s.patterns += int(np.ceil(scale * m.sum()))
        else:
            diag_like = t in (EncType.DIAGONAL, EncType.ANTI_DIAGONAL)
            for ru in res.runs:
                s = stats.setdefault(ru.delta, InstStats())
                s.encoded += int(scale * ru.sizes.sum())
                s.patterns += int(np.ceil(scale * ru.heads.size))
                if diag_like:
                    # distinct diagonals touched (trow IS the diagonal id in
                    # the transformed frame); sampling underestimates, which
                    # overestimates fill — acceptable optimism
                    s.n_groups += int(np.unique(
                        res.trows[ru.heads]).size)
        return stats

    def _filter_coverage(self, stats: Dict[int, InstStats]) -> Dict[int, InstStats]:
        min_cov = self.cfg.min_coverage
        thresh = min_cov * max(1, self.nnz_total)
        return {d: s for d, s in stats.items() if s.encoded >= thresh}

    # Measured on TPU v5e: arbitrary gather/scatter ~6.6 ns/element
    # (serialized), sorted segment-sum ~8.8 ns/element, dense elementwise
    # ~0.006 ns/element.  The delta (leftover singles) path costs one x
    # gather + one segment-sum per nnz.
    _TPU_DELTA_NS = 15.0
    _TPU_GATHER_NS = 6.6
    _TPU_UNIT_OVERHEAD_NS = 30.0

    def _tpu_exec_ns(self, t: EncType, inst: int,
                     s: Optional[InstStats] = None) -> float:
        """Estimated execution cost per encoded nnz for a pattern type.

        The TPU replacement for the reference's switch-count cost model
        (``GetTypeScore``, EncodingManager.hpp:836-861): what matters on TPU
        is not dispatch switches but which memory-access class the pattern
        lowers to — dense elementwise (DIA-folded diagonals), unit-sized
        gather+scatter (horizontal/vertical runs), or block gather + MXU
        einsum (blocks).
        """
        if t in (EncType.DIAGONAL, EncType.ANTI_DIAGONAL):
            # DIA fold is elementwise at HBM speed, but only diagonals whose
            # fill reaches spx.tpu.dia_min_fill fold; the rest execute as
            # scatter RunTables, which are WORSE than the (paged) delta
            # path.  Estimate fill from the distinct-offsets count.
            if s is not None and s.n_groups:
                fill = s.encoded / max(1.0, s.n_groups * self.nrows)
                if fill < self.cfg.dia_min_fill:
                    return self._TPU_DELTA_NS + 1.0  # never worth encoding
            return 0.5
        if t == EncType.HORIZONTAL:
            return self._TPU_GATHER_NS + 0.5  # x gather per nnz, y per unit
        if t == EncType.VERTICAL:
            return self._TPU_GATHER_NS + 0.5  # y scatter per nnz, x per unit
        if t.is_block:
            a = t.block_alignment
            br, bc = (a, inst) if t.is_block_row else (inst, a)
            return self._TPU_GATHER_NS * (1.0 / br + 1.0 / bc) + 1.0
        return self._TPU_DELTA_NS

    def type_score(self, t: EncType, stats: Dict[int, InstStats]) -> int:
        """Type selection score.

        ``ratio``/``cost`` follow the reference (GetTypeScore,
        EncodingManager.hpp:836-861); ``tpu`` (the default) scores by
        estimated execution-time savings vs leaving the nnz on the delta
        path, charging a fixed per-unit overhead.
        """
        return sum(self.inst_scores(t, stats).values())

    def inst_scores(self, t: EncType,
                    stats: Dict[int, InstStats]) -> Dict[int, int]:
        """Per-instantiation score contributions (>= 0)."""
        out: Dict[int, int] = {}
        for inst, s in stats.items():
            if self.cfg.heuristic == "tpu":
                saved = (s.encoded
                         * (self._TPU_DELTA_NS
                            - self._tpu_exec_ns(t, inst, s))
                         - s.patterns * self._TPU_UNIT_OVERHEAD_NS)
                out[inst] = max(0, int(saved))
            elif self.cfg.heuristic == "cost":
                out[inst] = max(0, s.encoded - 2 * s.patterns)
            else:
                out[inst] = max(0, s.encoded - s.patterns)
        return out

    # ------------------------------------------------------------------
    # encoding (extraction)
    # ------------------------------------------------------------------
    def _extract_runs(self, t: EncType, res: MiningResult) -> None:
        """Turn mined run units into RunTables and remove covered singles."""
        order = res.order
        vals_sorted = take1(self.vals, order)
        covered = res.covered
        for ru in res.runs:
            if ru.heads.size == 0:
                continue
            smax = int(ru.sizes.max())
            from sparsex_tpu_torch import native
            padded = native.pad_units(vals_sorted, ru.heads, ru.sizes, smax)
            if padded is None:
                lane = np.arange(smax, dtype=np.int64)
                idx = np.minimum(ru.heads[:, None] + lane[None, :],
                                 vals_sorted.size - 1)
                mask = lane[None, :] < ru.sizes[:, None]
                padded = np.where(mask, vals_sorted[idx],
                                  0).astype(self.vals.dtype)
            hr, hc = from_xform(t, res.trows[ru.heads], res.tcols[ru.heads],
                                self.nrows, self.ncols)
            self.run_tables.extend(pack_run_units(
                t, ru.delta, hr, hc, ru.sizes, padded,
                value_dtype=self.cfg.value_dtype,
                index_dtype=self.eff_index_dtype))
        # Remaining elements: inverse-transform the mined (already sorted)
        # coordinates at the kept positions — avoids two full-size random
        # permutes (the dominant pt cost on large matrices; the reference
        # pays the same via its Transform re-sorts, SparsePartition.hpp).
        keep_pos = np.flatnonzero(~covered)
        self.rows, self.cols = from_xform(
            t, res.trows[keep_pos], res.tcols[keep_pos],
            self.nrows, self.ncols)
        self.vals = vals_sorted[keep_pos]
        # NOTE: elements stay in the mined type's iteration order (the
        # reference also keeps its partition in the last Transform's order,
        # SparsePartition.hpp:680-744); finalize() restores row-major.

    def _extract_blocks(self, t: EncType, res: MiningResult,
                        allowed_ks: Optional[Sequence[int]] = None) -> None:
        """``allowed_ks`` (from an explicit sequence like ``"br2{4}"``)
        restricts the second block dimension to the listed values, in order
        (ref EncodeSerial's explicit instantiations)."""
        br = res.block_runs
        if br is None or br.heads.size == 0:
            return
        align = br.align
        kmax = max(2, self.cfg.max_unit_size // align)
        order = res.order
        vals_sorted = take1(self.vals, order)
        m = vals_sorted.size
        covered = np.zeros(m, dtype=bool)

        # pop() applies the largest listed dimension first
        forced = (sorted({int(k) for k in allowed_ks
                          if 2 <= int(k) <= kmax})
                  if allowed_ks else None)
        runs_left = BlockRuns(align=align, heads=br.heads.copy(),
                              other_dims=br.other_dims.copy())
        while True:
            if forced is not None:
                if not forced:
                    break
                k = forced.pop()
                heads, sizes, k = split_block_runs(runs_left, kmax,
                                                   dominant_k=k)
            elif self.cfg.split_blocks:
                heads, sizes, k = split_block_runs(runs_left, kmax)
            else:
                k = int(min(int(runs_left.other_dims.max()), kmax))
                heads, sizes, k = split_block_runs(runs_left, kmax,
                                                   dominant_k=k)
            if k < 2:
                break
            if heads.size == 0:
                if forced is not None:
                    continue
                break
            span = k * align
            idx = heads[:, None] + np.arange(span, dtype=np.int64)[None, :]
            ublock = vals_sorted[np.minimum(idx, m - 1)]
            # tcol order is (outer, inner) = (other_dim, align); reshape and
            # orient so vals are (U, row_extent, col_extent) row-major.
            if t.is_block_row:
                v3 = ublock.reshape(-1, k, align).transpose(0, 2, 1)  # (U,R,k)
            else:
                v3 = ublock.reshape(-1, k, align)  # (U,k,C)
            htr, htc = res.trows[heads], res.tcols[heads]
            hr, hc = from_xform(t, htr, htc, self.nrows, self.ncols)
            self.block_tables.append(BlockTable(
                enc=t,
                rows=hr.astype(self.eff_index_dtype),
                cols=hc.astype(self.eff_index_dtype),
                vals=v3.astype(self.cfg.value_dtype),
            ))
            diff = np.zeros(m + 1, dtype=np.int64)
            np.add.at(diff, heads, 1)
            np.add.at(diff, heads + span, -1)
            covered |= np.cumsum(diff[:-1]) > 0
            # Remainder columns (other_dims % k) of each run could form
            # smaller blocks; fold them back as new shorter runs.
            rem = runs_left.other_dims % k
            used = (runs_left.other_dims // k) * k
            keep_rem = rem >= 2
            if not keep_rem.any():
                break
            runs_left = BlockRuns(
                align=align,
                heads=(runs_left.heads + used * align)[keep_rem],
                other_dims=rem[keep_rem],
            )
            # forced mode continues with the next listed k only

        keep_pos = np.flatnonzero(~covered)
        self.rows, self.cols = from_xform(
            t, res.trows[keep_pos], res.tcols[keep_pos],
            self.nrows, self.ncols)
        self.vals = vals_sorted[keep_pos]

    def _resort(self) -> None:
        if is_sorted_rc(self.rows, self.cols):
            return  # leftovers already row-major (e.g. HORIZONTAL last)
        order = lexsort_rc(self.rows, self.cols)
        self.rows = take1(self.rows, order)
        self.cols = take1(self.cols, order)
        self.vals = take1(self.vals, order)

    def encode_type(self, t: EncType,
                    allowed_deltas: Optional[Sequence[int]] = None) -> None:
        if t == EncType.NONE or self.rows.size == 0:
            return
        res = self._mine(t, self.rows, self.cols, allowed_deltas)
        if t.is_block:
            # for blocks, explicit "deltas" are the second block dimension
            # (the reference's instantiation id, CsxUtil.hpp:57-73)
            self._extract_blocks(t, res, allowed_ks=allowed_deltas)
        else:
            self._extract_runs(t, res)
        self.encoded_types.append(t)

    # ------------------------------------------------------------------
    # selection loops
    # ------------------------------------------------------------------
    def _candidate_types(self) -> List[EncType]:
        seq = EncodingSequence(self.cfg.xform, self.cfg.one_dim_blocks)
        seen = set(self.encoded_types)
        return [t for t in seq.types() if t not in seen and t != EncType.NONE]

    def encode_all(self) -> None:
        """Greedy loop (EncodeAll parity, ref EncodingManager.hpp:905-960)."""
        self.timers.start_timer("Total")
        while self.rows.size:
            sample_idx = self._sample_indices()
            best_t, best_score, best_stats = EncType.NONE, 0, None
            self.timers.start_timer("Stats")
            for t in self._candidate_types():
                stats = self._filter_coverage(
                    self.gen_type_stats(t, sample_idx))
                score = self.type_score(t, stats)
                log_verbose("stats %s: %s score=%d", t.name,
                            {d: (s.encoded, s.patterns)
                             for d, s in stats.items()}, score)
                if score > best_score:
                    best_t, best_score, best_stats = t, score, stats
            self.timers.pause_timer("Stats")
            if best_t == EncType.NONE:
                break
            self.timers.start_timer("Encode")
            # only instantiations that actually scored > 0 get encoded
            # (the tpu heuristic zeroes low-fill diagonals, keeping their
            # nnz on the faster delta path)
            contrib = self.inst_scores(best_t, best_stats)
            allowed = (None if best_t.is_block
                       else sorted(d for d, v in contrib.items() if v > 0))
            log_info("Encode to %s", best_t.name)
            self.encoding_log.append(best_t.name)
            self.encode_type(best_t, allowed)
            self.timers.pause_timer("Encode")
        self.timers.pause_timer("Total")

    def encode_serial(self, seq: EncodingSequence) -> None:
        """EncodeSerial parity: forced sequence with explicit deltas."""
        for t, deltas in seq:
            if t == EncType.NONE:
                continue
            self.encoding_log.append(t.name)
            self.encode_type(t, deltas if deltas else None)

    def encode(self) -> None:
        """Entry point: explicit-delta sequences force serial encoding."""
        seq = EncodingSequence(self.cfg.xform, self.cfg.one_dim_blocks)
        if seq.explicit:
            self.encode_serial(seq)
        else:
            self.encode_all()
        # parity: "==== PREPROCESSING TIMING STATISTICS ====" report
        # (ref EncodingManager.hpp:958-959), printed at INFO
        log_info("==== PREPROCESSING TIMING STATISTICS ====")
        for name in ("Total", "Stats", "Encode"):
            log_info("  %s: %.6f s", name, self.timers.get_secs(name))
        log_info("  encoding sequence: %s",
                 ",".join(self.encoding_log) or "none")

    # ------------------------------------------------------------------
    @property
    def eff_index_dtype(self):
        """Narrowed index dtype: int16 when every coordinate of this
        partition fits (ref ``GetDeltaSize`` picks 8/16/32-bit deltas,
        ``CsxManager.hpp:635-682``); the user's int64 choice is honored.
        """
        idt = self.cfg.index_dtype
        if (idt == np.dtype(np.int32)
                and max(self.nrows, self.ncols) < (1 << 15)):
            return np.dtype(np.int16)
        return idt

    def finalize(self, row_start: int = 0) -> CsxTables:
        """Package leftovers as the delta (CSR) table and emit CsxTables."""
        self._resort()  # back to row-major for the CSR delta table
        idt = self.eff_index_dtype
        rowptr = np.zeros(self.nrows + 1, dtype=np.int64)
        np.add.at(rowptr, self.rows + 1, 1)
        rowptr = np.cumsum(rowptr)
        delta = DeltaTable(
            rowptr=rowptr.astype(idt),
            cols=self.cols.astype(idt),
            vals=self.vals.astype(self.cfg.value_dtype),
            row_ids=self.rows.astype(idt),
        )
        from sparsex_tpu_torch.preprocess.tables import fold_diagonals
        runs, dias = fold_diagonals(
            self.run_tables, self.nrows,
            min_fill=self.cfg.dia_min_fill,
            value_dtype=self.cfg.value_dtype)
        return CsxTables(
            nrows=self.nrows, ncols=self.ncols, nnz=self.nnz_total,
            row_start=row_start, delta=delta,
            runs=runs, blocks=self.block_tables, dias=dias,
            value_type=(None if self.cfg.value_type != "bfloat16"
                        else "bfloat16"),
        )
