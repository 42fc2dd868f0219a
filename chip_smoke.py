"""Smoke test of sparsex_tpu_torch on one CUDA GPU (written for an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

or, for some of the one-card paths alone (all their value types, no phase
after them), with their labels:

    python3 chip_smoke.py --paths "urand 2^19" "headline 2^22"

It builds the CUDA kernels from ``sparsex_tpu_torch/csrc`` (one nvcc per
source, run together) and drives the port's paths on the card at full
width, each tuned with ``sparsex_tpu_torch.mat_tune`` and multiplied with
``matvec_kernel`` in float32 and float64.  The matrices are made here from
seeds (``build_matrix`` and ``build_blocky_matrix`` are bench.py's, copied:
this script imports nothing of the JAX package or its benchmark):

- the headline matrix (``build_matrix(1 << 20)``: 2^20 rows, 5.77M
  nonzeros): the fused delta pipeline (K1 style lp, T1, K2, K3) with the
  DIA tables riding K3;
- the blocky matrix (``build_blocky_matrix(1 << 21)``: 2^21 rows, 6.82M
  nonzeros of 4x2 blocks, width-8 runs and singles): the delta pipeline
  plus two fused run tables (K1 styles rlp8 and rlp2) in one merged route
  plan (per instance: the G1 lane gather, T1, K2), one K3; timed in
  float32; then the same plan classes at 2^19, whose merged plan has a
  masked instance: timed in float32 (bench.py's blocky size) and checked
  untimed in float64;
- bench.py's diag-class matrix (``build_diagc_matrix(1 << 19)``: 2^19
  rows, 1.11M nonzeros of partial diagonals, anti-diagonals, vertical
  runs and singles): the delta pipeline alone (K1 lp bulk and tail, 4
  route instances of T1 and K2, the fourth of a shape of its own, one K3
  with no DIA), the vertical runs demoted into it (``cvt``); timed in
  float32, checked in float64;
- the dense-tile K1 styles, which the planners take where lane placement
  does not apply:
  - ``wide_run_matrix(1 << 21, 16)`` (width-16 runs plus singles): a fused
    run table in K1 style run16, the delta pipeline (lp) and a merged
    route plan;
  - ``lane_skew_matrix(1 << 21)`` (singles on a coarse column grid): the
    delta pipeline in K1 style sl with its own route instances;
  - both timed in float32 and checked in float64 at 2^19 rows, where the
    planners make the same plan classes and styles;
  - one untimed float32 check of ``wide_run_matrix(1 << 19, 128)``, whose
    run table takes K1 style run128 (seven roll passes) on 8 route
    instances of its own besides the delta pipeline's, so that K3 runs in
    two calls (at 2^20 the table would need 16 instances, more than K3's
    8, and the planner gives it a paged plan with an ``fs`` route);
- the partial-segment route (``fs``), which the planner takes for a paged
  run table whose width does not divide 128 and a block table with bc not
  dividing 128 (the paged-units kernel writes the table's partials, then
  per route instance the G1 lane gather, T1 and K2 feed the shared K3):
  - ``wide_run_matrix(1 << 21, 5)`` (4.72M nonzeros): a paged width-5 run
    table with an ``fs`` route beside the delta pipeline;
  - ``block3_matrix(3 << 19)`` (9.44M nonzeros of 3x3 blocks, as 3-D FEM
    matrices have): a paged block table with an ``fs`` route;
  - both timed in float32 and checked in float64 at a quarter of the
    rows (2^19 and 3 x 2^17);
  - one untimed check in float32 and float64 of
    ``overlap_run_matrix(1 << 16)`` (3 width-16 runs a row), whose fused
    run plan had route instances overlapping outside a merged plan: the
    port re-plans its run table as a paged table with an ``fs`` route;
- the fused pipeline kept off (``spx.tpu.min_fused_nnz`` above the
  nonzeros, a public option), at 2^20 rows in float32 and float64:
  - ``build_matrix(1 << 20)``: the legacy paged delta with its scatter
    route (``dscatter``: the delta-pages product, then five lane gathers
    per route instance with torch transposes between them) beside the DIA
    kernel on the 5 diagonals;
  - ``build_blocky_matrix(1 << 20)``: the same routed delta, the fblk
    chain of its 4x2 block table (the unit-page gather, per block row a
    multiply and lane-roll sums) into a merged plan of ``blk`` segments
    with ``bres`` residuals (G1 lane gather, T1, K2, K3), and a paged
    width-8 run table with an ``fs`` route;
- the non-fused variants, which the fused planners refuse (more than 2^21
  rows, or nothing to fuse):
  - HPCG's 27-point stencil on a 128^3 grid (``hpcg_matrix``: 2^21 rows,
    55.7M nonzeros): the plain-table variant, one DIA kernel launch of 27
    diagonals;
  - ``build_matrix(1 << 22)`` (23.1M nonzeros): the legacy paged variant,
    the delta-pages kernel's scatter epilogue (the products added into y
    by the kernel) and the DIA kernel on the 5 diagonals;
  - ``build_blocky_matrix(1 << 22)`` (13.6M nonzeros): the paged delta
    stream and the paged run and block tables, whose partials the
    paged-units kernel forms and scatter-adds itself (the unit-page
    gather is held against its plain version on the same windows, off
    this path);
  - GAP's urand graph at scale 19 (``urand_matrix(1 << 19)``: 16.8M
    entries, 1 / degree of the column; the benchmark's
    ``gap-urand19-f32``): the paged delta stream laid out in row blocks
    (``drows``), the row-blocked epilogue kernel
    (``delta_rowblock_acc``) alone; both delta streams of 2^22 above are
    too sparse for row blocks and keep the planner's layout;
- symmetric matrices (``spx.matrix.symmetric``), each tuned once as its
  lower triangle and diagonal and run in both modes (``spx.tpu.sym_full``
  on, then off): bench.py's CSX-Sym matrix ``build_symmetric_matrix(1 <<
  20)`` (7.9M nonzeros of the full matrix; the rates count them all) and
  HPCG's stencil on a 128^3 grid: the full mirror on the main path (the
  fused lp pipeline with 7 DIAs in K3; one DIA kernel of 27 diagonals)
  and the per-shard plan (the DIA kernel on the lower diagonals, the
  delta-pages product on the direct and the transposed delta streams,
  ``dpages`` and ``dpagesT``, each routed by five lane gathers per
  instance of ``dscatter`` / ``dscatterT``; the 13 lower diagonals and
  the transposed windows in torch), the scatter epilogue held on the
  transposed stream off the path;
- matrices of several shards on one card (``spx.rt.nr_threads``, each
  shard planned as a matrix of its rows, all run from one CUDA graph a
  call; ``run_shard_paths``), after the one-shard paths they are compared
  with: headline 2^20 in 2 and 4 shards (SpMM k = 8 timed on 2, f32) and
  blocky 2^21 in 2 (SpMM k = 8 checked), in float32 and float64, each
  shard's plan fused; symmetric 2^20 in 2 shards in both modes (per shard:
  shard 1 at its own ``row_start``), timed in float32 and checked in
  float64.  Each prints every shard's plan, holds every kernel on every
  shard against its plain version (timed in float32), the matrix graph's
  kernel nodes against the sum of its shards' counts, each shard's SpMV
  alone and the load imbalance, and the cost against the same matrix in
  one shard (graph µs, launches, glue).  On headline 2^20 x2 f32,
  ``set_entry`` on a delta and a DIA entry of shard 1 shows in the next
  SpMV, and ``mat_save`` / ``mat_restore`` on the card gives bit-equal
  plans and SpMV (``entries_phase``);
- several ranks, one process each (``parallel.shard.ShardedCsx`` on
  torch.distributed; ``run_rank_paths``, the counterpart of the JAX
  package's ``dryrun_multichip``): the matrix tuned here in N shards (its
  one-device executor, y, plan bytes and CG the comparison), its host
  tables handed to N spawned ranks (``parallel.comm.run_ranks``, a
  ``FileStore``), all on cuda:0 with gloo, the exchanges through the
  host: headline 2^20 on 2 ranks (x replicated; K1 lp, T1, K2, K3 per
  rank; SpMM k = 8 in float32 through the kb kernels), HPCG 128^3 on 4
  (a halo ring of one chunk each way; the DIA kernel on each rank's local
  set, its halo delta beside it), bench.py's CSX-Sym matrix at 2^20 on 2
  (the per-shard symmetric plan: DIA, ``dpages`` / ``dpagesT``, the
  ``dscatter`` lane gathers; the partials reduce-scattered) and
  symmetric HPCG 128^3 on 4 (symmetric halo: one window-rebased table
  set a rank), float32 timed and float64 checked, then CG in float64 to
  1e-8 on symmetric HPCG x4 (``graph=False``) against the one-device CG.
  Per path and type: every rank's y equal, within the bar of the oracle
  and of the one-device y; each rank's first call launching its
  executors' plans' kernels (warm-up and capture) and its replay none;
  rank 0's kernels against their plain versions at its shapes; each
  rank's plan bytes on its device and under (1 + 1/N) / 2 of the whole
  matrix's; timed, each rank's executors alone (in turns), each exchange
  and the whole SpMV, labelled ``ONE_CARD``: not a multi-GPU time.  With
  two GPUs or more the same paths also run on NCCL, a GPU a rank;
  otherwise a line says it was not run;
- the solvers (``sparsex_tpu_torch.solvers``; a block of
  ``solvers.BLOCK`` iterations captured as one CUDA graph a solve, the
  host reading the stop flag once a block): CG on symmetric HPCG 128^3's
  full mirror (b = A 1) on the matrix that path tuned, and CG and block CG
  (k = 8, the kb kernels) on ``spd_symmetric_matrix(1 << 20)`` (the
  CSX-Sym matrix with 2.0 on its diagonal, s.p.d. by Gershgorin; the same
  plan, fused lp with 7 DIAs in K3) as its full mirror, a path of its
  own; then SpGEMM (``spgemm_matrix``, bench.py's bench_spgemm operand,
  C = A A tuned onto the card; ``spgemm_panel`` of the headline 2^20 f32
  matrix and a 2^20 x 256 operand in panels of 64) and each
  ``examples/*_torch.py`` at its default size;
- the tools (``tools/*_torch.py``, ``tools_phase``), as a user runs them:
  the diagc matrix at 2^19 as an MMF through ``test_sparsex_torch`` and
  ``bench_spmv_torch`` (the port, torch's CSR product, the host's native
  CSR and scipy), ``profile_fused_torch`` on bench.py's four workloads
  and blocky's SpMM, then ``weak_scaling_torch`` and ``soak_torch`` (its
  sharded checks on 2 ranks) as processes of their own;
- the SpMM (``matmat_kernel``, X of shape (n, k) from a numpy seed) on the
  matrix each path has tuned: timed at k = 8 (one k-batched chunk) on
  headline 2^20 in float32 and float64 and on blocky 2^21, wide-run
  and lane-skew 2^21, blocky 2^19 and fs-run 2^21 (k-batched, the fs
  table by row scatter) in float32 (blocky 2^19: bench.py's SpMM
  configuration, whose SpMV is timed too); untimed checks in float64 at
  k = 8 on blocky, wide-run and lane-skew 2^19, in float32 at k = 8 on
  diagc 2^19, at k = 11 on
  headline 2^20 (chunks of 8 and 3), k = 3 on blocky 2^19 (the masked g3
  instance), k = 8 on fs-block (the SpMV once per column), k = 2 on the
  two fused-gate-off paths, HPCG 128^3, headline 2^22 and the symmetric
  paths in both modes (the SpMV once per column, but on the fused full
  mirror).

Every phase is fatal on failure:

1. the device, torch / CUDA versions and the kernel build time, with
   nvcc's register, spill and shared-memory report per kernel (stderr);
2. tuning, with the plan checked to hold the expected execution classes
   and K1 styles;
3. each kernel of the path against its plain PyTorch version on that
   plan's arrays, at every shape the path gives it, each stage fed what the
   SpMV feeds it (``kernel_phase``): K1 (every style), T1, K2, the lane
   gather (G1 of every route instance and each stage of a legacy scatter
   route), the DIA kernel, the delta-pages product, the unit-page gather
   (on the fblk tables' window streams where the path runs it) and the
   paged-units kernel bit-equal, K3 and the scatter epilogues of the
   delta-pages (fold-sorted or row-blocked) and paged-units kernels
   (atomic adds, as ``index_add_``'s) within 1e-6 of the largest value;
4. the SpMV end to end against a float64 COO oracle (``CHECK_TOL`` in
   float32, 1e-6 in float64) at alpha=1/beta=0 and alpha=2/beta=0.5.  An
   executor replays a CUDA graph of its own on every call, captured at its
   first call after one eager warm-up run, so the launch counters see that
   first call only: its counts must be twice one SpMV's, derived from the
   plan (warm-up and capture), which shows that each kernel ran on that
   path; the second call, a replay, must launch nothing from Python, the
   kernel nodes of the executor's graph (read through the CUDA driver) must
   be one SpMV's by name and number, and the replay must equal the eager body on the same x
   (bit for bit, or within 1e-6 of the largest value where atomic adds
   reorder sums); the T1, lane-gather and K1 launchers refuse operands
   off a 16-byte boundary, so this phase also shows that every call site
   on the path (an instance's row slice, K1's reshaped output) passes
   aligned tensors;
5. CUDA-event times, median over 5 runs of 128 calls after a warm-up: the
   SpMV end to end as a Python caller gets it (a replay of the executor's
   graph), the host's time to enqueue one, the SpMV captured in a CUDA
   graph of this script's (device time), and the eager body called from
   Python (the dispatch before executors kept graphs); the memory each
   executor's graphs took at their capture; each kernel
   and its plain version replayed from CUDA graphs, in the order plain,
   kernel, kernel, plain (all of one kernel's calls of an SpMV, 128 times in
   a row: its inputs stay warm in L2), beside its bound (the bytes it must
   move at 3.35 TB/s, or its operations at the card's peak, whichever is
   longer) and, where one PyTorch call computes the same function, that
   call's time; not for the untimed checks;
6. a torch.profiler trace of 50 SpMVs: each kernel's device time inside
   the real SpMV, the PyTorch glue kernels around them (the four largest
   by name), and the share of the called-from-Python time the device is
   busy;
7. per SpMM (``spmm_phase``): on a fused plan each k-batched kernel
   (``_kb``) against its plain version fed one chunk of X as the SpMM
   feeds it (bit-equal, K3 within 1e-6); two SpMMs against the oracle
   (alpha=1/beta=0, alpha=2/beta=0.5 with a Y), the first one's launch
   counts twice one SpMM's (ceil(k/8) x the plan's per-SpMV counts under
   the ``_kb`` keys and no other launch, or k SpMVs on a plan without a
   fused segment), the graph checked as the SpMV's; when timed,
   the SpMM called from Python and replayed from a CUDA graph, Gnnz*k/s,
   SpMV-equivalents (graph time over k x the path's SpMV graph time), each
   kb kernel alone beside its bound and k x its kb = 0 time per SpMV, and
   a profile of 20 SpMMs;
8. on headline 2^20 and blocky 2^21, a bf16 matrix computed in float32
   (``bf16_phase``): a bf16 SpMV and k = 8 SpMM within ``BF16_TOL`` of the
   oracle on the bf16-rounded values and x, and the SpMV's times;
9. the solvers (``hpcg_cg_phase``, ``spd_solver_phase``): each solve from
   its captured block against the same solve run eagerly (one iteration a
   Python step, the same kernels): the same iteration count, x within
   ``SOLVE_BAR``; the block's graph holding ``BLOCK`` SpMVs' (SpMMs')
   kernels by name and number (read through the CUDA driver), which give
   the kernel entries of the ``cg`` / ``block-cg`` paths (the path's own
   entries, launches per iteration); float64 CG to tol 1e-8 with its true
   residual through the float64 COO oracle within ``CG_BAR``; block CG's
   columns against cg per column within ``COLUMN_BAR``; µs per iteration
   (replays of the block / ``BLOCK``) beside the SpMV / SpMM graph time,
   the solve's wall time with and without the block's capture;
10. SpGEMM (``spgemm_phase``): C's SpMV against A (A x) and each panel's
   columns against the oracle within ``CHECK_TOL``, the host MFLOPS of
   ``spgemm_coo`` (labelled a host number), µs per panel and the k = 64
   graph's MiB; then each example's ``main`` must return 0 after its own
   check (``examples_phase``), with its seconds;
11. the tools (``tools_phase``): each must exit 0 (``test_sparsex_torch``
   within 1e-6 of the COO oracle, ``bench_spmv_torch``'s four adapters
   cross-checked OK, ``soak_torch`` passing every check), with its
   seconds; their numbers go into the summary.

The card's name and power limit (nvidia-smi) come two lines before the
last; the line before the last is a JSON object ``{"kernels": [...]}``
(per timed path and value type, each kernel that path runs, with that
path's launch counts); the last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
LOOPS, OUTER = 128, 5
N = 1 << 20
N_BLOCKY = 1 << 21
N_BLOCKY_CHECK = 1 << 19
N_DENSE = 1 << 21       # the wide-run (W = 16) and lane-skew matrices
N_DENSE_CHECK = 1 << 19  # their float64 checks, and the fs-run one
N_RUN128 = 1 << 19      # the width-128 wide-run check
N_BIG = 1 << 22         # past the fused planners' 2^21-row cap
N_FS_BLOCK = 3 << 19    # the 3x3-block matrix: 2^19 block rows
N_FS_BLOCK_CHECK = 3 << 17  # its float64 check
HPCG_NX = 128           # the HPCG stencil's grid edge: 2^21 rows
N_OVERLAP = 1 << 16     # the run matrix whose fused-run route overlapped
# the fused pipeline kept off (a public option): the legacy paged variant
# with its routed delta scatter, fused block tables and their merged plan
NO_FUSE = (("spx.tpu.min_fused_nnz", str(1 << 30)),)
N_SYM = 1 << 20         # bench.py's CSX-Sym matrix (build_symmetric_matrix)
N_DIAGC = 1 << 19       # bench.py's diag-class matrix (build_diagc_matrix)
N_URAND = 1 << 19       # GAP's urand graph at scale 19 (urand_matrix)
# a symmetric matrix, tuned as its lower triangle and diagonal; its two
# modes (spx.tpu.sym_full): the full mirror and the per-shard plan
SYMMETRIC = (("spx.matrix.symmetric", "true"),)
SYM_MODES = {"full": "on", "per-shard": "off"}
# the card's peaks for the bounds (H100 SXM: 3.35 TB/s of HBM3; 67 TFLOP/s
# in float32 and 34 in float64 outside the tensor cores, NVIDIA's data
# sheet), read at the card's full power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
SOURCE = {"lane_gather": "sparsex_tpu_torch/csrc/route.cu",
          "lane_gather_kb": "sparsex_tpu_torch/csrc/route.cu",
          "dia": "sparsex_tpu_torch/csrc/dia.cu",
          "delta_pages": "sparsex_tpu_torch/csrc/pages.cu",
          "delta_pages_acc": "sparsex_tpu_torch/csrc/pages.cu",
          "delta_rowblock_acc": "sparsex_tpu_torch/csrc/pages.cu",
          "paged_gather": "sparsex_tpu_torch/csrc/pages.cu",
          "paged_units": "sparsex_tpu_torch/csrc/pages.cu"}
FUSED_SOURCE = "sparsex_tpu_torch/csrc/fused.cu"
REPLACES = {
    "k1": "sparsex_tpu/ops/fused.py:962",
    "k1_rlp": "sparsex_tpu/ops/fused.py:962",
    "k1_sl": "sparsex_tpu/ops/fused.py:962",
    "k1_run": "sparsex_tpu/ops/fused.py:962",
    "t1": "sparsex_tpu/ops/fused.py:1317",
    "k2": "sparsex_tpu/ops/fused.py:1143",
    "k3": "sparsex_tpu/ops/fused.py:1372",
    "lane_gather": "sparsex_tpu/ops/route.py:425",
    "dia": "sparsex_tpu/ops/pallas_kernels.py:40",
    "delta_pages": "sparsex_tpu/ops/pallas_kernels.py:233",
    # the delta-pages product with the scatter-add after it (:312-321)
    "delta_pages_acc": "sparsex_tpu/ops/pallas_kernels.py:233",
    # the same, over the port's row-blocked layout of the stream
    "delta_rowblock_acc": "sparsex_tpu/ops/pallas_kernels.py:233",
    "paged_gather": "sparsex_tpu/ops/pallas_kernels.py:389",
    # the unit-page gather with the multiply and unit sums around it
    "paged_units": "sparsex_tpu/ops/pallas_kernels.py:389",
    # the k-batched (kb > 0) pallas_calls of the same builders
    "k1_kb": "sparsex_tpu/ops/fused.py:1063",
    "k1_rlp_kb": "sparsex_tpu/ops/fused.py:1063",
    "k1_sl_kb": "sparsex_tpu/ops/fused.py:1063",
    "k1_run_kb": "sparsex_tpu/ops/fused.py:1063",
    "t1_kb": "sparsex_tpu/ops/fused.py:1343",
    "k2_kb": "sparsex_tpu/ops/fused.py:1282",
    "k3_kb": "sparsex_tpu/ops/fused.py:1545",
    "lane_gather_kb": "sparsex_tpu/ops/route.py:461",
}
# the SpMM phases: X (ncols, k) from a numpy seed; timed kernel replays of
# one SpMM take fewer loops (a plain version at kb = 8 runs for ms)
MM_LOOPS, MM_OUTER = 16, 3
# the SpGEMM panel stream: the headline matrix times a 2^20 x PANEL_COLS
# operand, PANEL columns a panel
PANEL, PANEL_COLS = 64, 256


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_time_ms(fn, loops=LOOPS, outer=OUTER):
    """Median over ``outer`` CUDA-event timings of ``loops`` calls, in ms
    per call (one warm-up call first)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(outer):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(loops):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / loops)
    return statistics.median(times)


def graph_time_ms(fn, loops=LOOPS, outer=OUTER):
    """Device time per call: ``loops`` calls captured in one CUDA graph,
    replayed ``outer`` times (median).  Python dispatch, which exceeds the
    device time of these small kernels, is kept out of the measurement."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(loops):
            fn()
    return cuda_time_ms(graph.replay, loops=1, outer=outer) / loops


def paired_ms(kernel, plain, loops=LOOPS, outer=OUTER):
    """(kernel ms, plain ms) of device time per call, timed in the order
    plain, kernel, kernel, plain and averaged, so a clock that drifts
    during the run weighs on both alike."""
    p1, k1, k2, p2 = (graph_time_ms(f, loops, outer)
                      for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def warm_up(seconds=3.0):
    """Keep the card busy for a few seconds so that its clocks have risen
    before the first timing."""
    import torch
    a = torch.ones(1 << 26, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            a.mul_(1.0)
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def csr_input(spx, rows, cols, vals, n):
    rowptr = np.zeros(n + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    return spx.input_load_csr(rowptr, cols, vals, n, n)


def extras_of(meta):
    return {e[0]: e[1:] for e in meta[5:] if e}


def fused_runs(meta):
    """(run table index, fused-run meta) of every ``frun`` table."""
    return [(ri, e[5][1]) for ri, e in enumerate(meta[2])
            if len(e) > 5 and e[5] and e[5][0] == "frun"]


def paged_tables(meta):
    """(kind, index, entry) of every paged run or block table (a unit-page
    plan at ``entry[3]``, not fused)."""
    return [(kind, i, e) for kind, metas in (("runs", meta[2]),
                                             ("blocks", meta[3]))
            for i, e in enumerate(metas)
            if len(e) > 3 and e[3] and not (len(e) > 5 and e[5])]


def fs_tables(meta):
    """(kind, index, entry) of every run or block table routed through a
    partial segment (``fs`` at ``entry[4]``)."""
    return [(kind, i, e) for kind, metas in (("runs", meta[2]),
                                             ("blocks", meta[3]))
            for i, e in enumerate(metas)
            if len(e) > 4 and e[4] and e[4][0] == "fs"]


def routed_tables(meta):
    """(kind, index, entry) of every run or block table routed through a
    legacy scatter plan (its route metas at ``entry[4][0]``)."""
    return [(kind, i, e) for kind, metas in (("runs", meta[2]),
                                             ("blocks", meta[3]))
            for i, e in enumerate(metas)
            if len(e) > 4 and e[4] and e[4][0] != "fs"]


def fblk_tables(meta):
    """(index, entry) of every fused block table (``fblk``)."""
    return [(bi, e) for bi, e in enumerate(meta[3])
            if len(e) > 5 and e[5] and e[5][0] == "fblk"]


def expected_counts(meta, k=0):
    """Kernel launches of one SpMV (``k`` = 0), derived from the plan: one
    K1 per delta part and per fused run table, under the key of the kernel
    its style runs (``k1`` lp, ``k1_rlp``, ``k1_sl``, ``k1_run``); per route
    instance one T1 and one K2 (and one lane gather for a merged plan's
    G1) and per instance of a partial-segment route (``fs``) one lane
    gather, T1 and K2; per fused block table (``fblk``) one unit-page
    gather and, unless a merged plan takes its block rows, per instance of
    each row's segment one lane gather, T1 and K2; one K3 per 8 instances;
    one DIA kernel per standalone DIA table; per paged delta stream (the
    direct ``dpages`` and a symmetric shard's transposed ``dpagesT``) one
    delta-pages product and five lane gathers per instance of its scatter
    route (``dscatter``, ``dscatterT``), or one launch of the product's
    scatter epilogue (``delta_pages_acc``) where it has no route, one of the
    row-blocked epilogue (``delta_rowblock_acc``) for ``drows``; five lane
    gathers per instance of a table's legacy scatter plan, one paged-units
    kernel per paged table.  Of one SpMM of ``k`` columns: on a
    fused
    plan ceil(k / 8) times the counts of the fused segments under the
    k-batched kernels' keys (``_kb``) and no other launch (a paged table's
    gather and an ``fs`` table's scatter are torch glue there); else k
    SpMVs."""
    from sparsex_tpu_torch.ops import fused as tf
    from sparsex_tpu_torch.ops.kernels import fused_mm_ok
    if not k:
        return _spmv_counts(tf, meta)
    if not fused_mm_ok(meta):
        return {key: k * v for key, v in _spmv_counts(tf, meta).items()}
    chunks = -(-k // tf.MAX_KB)
    out = dict.fromkeys(tf.KERNELS, 0)
    for key, v in _spmv_counts(tf, meta, unit_tables=False).items():
        if key + "_kb" in out:
            out[key + "_kb"] = chunks * v
    return out


def matrix_counts(csx, k=0):
    """One call's launches of a tuned matrix: the sum over the executors of
    its mode in use (one per shard; ``expected_counts`` of each plan), all
    of which the matrix's one executor runs."""
    csx._executor()
    out = {}
    for ex in csx.executors:
        for key, v in expected_counts(ex.meta, k).items():
            out[key] = out.get(key, 0) + v
    return out


def _spmv_counts(tf, meta, unit_tables=True):
    ex = extras_of(meta)
    dfused, fall = ex.get("dfused"), ex.get("fall")
    counts = dict.fromkeys(tf.KERNELS, 0)
    n_inst = 0
    if dfused is not None:
        fmeta = dfused[0]
        counts[tf.k1_key(fmeta[6])] += 1
        if len(fmeta) > 7 and fmeta[7] is not None:
            counts[tf.k1_key(fmeta[7][0][3])] += 1
        n_inst += len(fmeta[3])
    for _ri, m in fused_runs(meta):
        counts[tf.k1_key(m[5])] += 1
        n_inst += len(m[3])
    if fall is not None:
        n_inst = counts["lane_gather"] = len(fall[1])
    if unit_tables:
        n_fs = sum(len(e[4][1]) for _k, _i, e in fs_tables(meta))
        if fall is None:
            n_fs += sum(len(inst) for _bi, e in fblk_tables(meta)
                        for inst, _res, _m in e[5][1])
        counts["lane_gather"] += n_fs + 5 * sum(
            len(ex[key][0]) for key in ("dscatter", "dscatterT")
            if key in ex) + 5 * sum(
            len(e[4][0]) for _k, _i, e in routed_tables(meta))
        n_inst += n_fs
        counts["paged_units"] = len(paged_tables(meta))
        counts["paged_gather"] = len(fblk_tables(meta))
    counts["t1"] = counts["k2"] = n_inst
    counts["k3"] = -(-n_inst // 8) if n_inst else int("k3dias" in ex)
    counts["dia"] = (0 if "k3dias" in ex
                     else sum(1 for _a, offs, _n in meta[4] if offs))
    for stream, route in (("dpages", "dscatter"), ("dpagesT", "dscatterT")):
        if stream in ex:
            counts["delta_pages" if route in ex else "delta_pages_acc"] += 1
    counts["delta_rowblock_acc"] = int("drows" in ex)
    return counts


ROW_BLOCKS = "spx.tune.plan.build_row_blocks"


def tune(spx, rows, cols, vals, n, dtype_name, label, options=()):
    """mat_tune under bench.py's config and the extra ``options`` (key,
    value) pairs; says what the row-blocked layout's planner took of the
    tune (its span, rejected where the stream kept its layout)."""
    import torch
    before = spx.trace_snapshot()["spans"].get(ROW_BLOCKS)
    cfg = spx.Config.reset()
    cfg.set("spx.tpu.value_dtype", dtype_name)
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "portion")
    for key, value in options:
        cfg.set(key, value)
    t0 = time.perf_counter()
    mat = spx.mat_tune(csr_input(spx, rows, cols, vals, n))
    torch.cuda.synchronize()
    mat.tune_s = time.perf_counter() - t0
    say(f"[{label}] mat_tune: {mat.tune_s:.2f} s, {n}x{n}, "
        f"nnz={mat.nnz}, on {mat.device}, {len(mat.csx.shards)} shard(s)")
    after = spx.trace_snapshot()["spans"].get(ROW_BLOCKS)
    if after is not None:
        was = before or {"count": 0, "seconds": 0.0, "rejected_seconds": 0.0}
        say(f"[{label}] build_row_blocks: {after['count'] - was['count']} "
            f"call(s), {after['seconds'] - was['seconds']:.3f} s, rejected "
            f"{after['rejected_seconds'] - was['rejected_seconds']:.3f} s")
    return mat


def _fused_desc(meta):
    """One line of the fused parts of a plan."""
    extras = extras_of(meta)
    desc = []
    if "dfused" in extras:
        fmeta = extras["dfused"][0]
        tail = fmeta[7][0] if len(fmeta) > 7 and fmeta[7] else None
        desc.append(f"delta T={fmeta[0]} q={fmeta[1]} npages={fmeta[2]} "
                    f"style={fmeta[6]} tail={tail} instances="
                    f"{[m[:10] for m in fmeta[3]]} residuals={fmeta[4]} "
                    f"left={fmeta[5]}")
    desc.append("fused runs " + str([(ri, m[0], m[1], m[2], m[5], m[4],
                                      [i[:10] for i in m[3]])
                                     for ri, m in fused_runs(meta)]))
    desc.append("plain runs " + str([e[:3] for e in meta[2]
                                     if not (len(e) > 5 and e[5])]))
    if "fall" in extras:
        segs, inst, _bounds, res_desc = extras["fall"]
        desc.append(f"merged segments {segs} instances "
                    f"{[m[:10] for m in inst]} residuals {res_desc}")
    if "k3dias" in extras:
        desc.append(f"k3dias {extras['k3dias']}")
    return "; ".join(desc)


def check_plan(mat, label):
    """The headline plan: the hybrid lp delta pipeline with the DIA tables
    in K3."""
    ex = mat.csx.executors[0]
    extras = extras_of(ex.meta)
    if "dfused" not in extras or "k3dias" not in extras:
        fail(f"[{label}] plan holds {sorted(extras)}, expected dfused + "
             "k3dias")
    fmeta = extras["dfused"][0]
    if len(fmeta) < 8 or fmeta[7] is None:
        fail(f"[{label}] plan has no hybrid tail part")
    if extras["k3dias"][1]:
        fail(f"[{label}] the headline plan is expected to hold no "
             "anti-diagonals")
    say(f"[{label}] plan: {_fused_desc(ex.meta)}")
    return ex


def check_blocky_plan(mat, label):
    """The blocky plan: the delta pipeline and the rlp8 and rlp2 fused run
    tables in one merged route plan, no DIA tables."""
    ex = mat.csx.executors[0]
    extras = extras_of(ex.meta)
    styles = {m[5] for _, m in fused_runs(ex.meta)}
    if ("dfused" not in extras or "fall" not in extras
            or not {"rlp2", "rlp8"} <= styles or "k3dias" in extras):
        fail(f"[{label}] plan holds {sorted(extras)} and fused run styles "
             f"{sorted(styles)}, expected dfused + fall with rlp8 and rlp2")
    say(f"[{label}] plan: {_fused_desc(ex.meta)}")
    return ex


def check_masked_blocky_plan(mat, label):
    """The blocky plan at 2^19: a merged instance with a masked g3."""
    ex = check_blocky_plan(mat, label)
    if all(m[9] & 2 for m in extras_of(ex.meta)["fall"][1]):
        fail(f"[{label}] no merged instance with a masked g3 (um & 2 == 0)")
    return ex


def check_diagc_plan(instances):
    """The diag-class plan (``build_diagc_matrix``): the fused delta
    pipeline only (``dfused``, no DIA tables in K3, no fused run table),
    with the mined run tables demoted into it (``cvt`` entries: the
    vertical runs, and at small sizes the partial diagonals too) and
    ``instances`` route instances."""
    def check(mat, label):
        from sparsex_tpu_torch.ops.kernels import _kind
        ex = mat.csx.executors[0]
        meta = ex.meta
        extras = extras_of(meta)
        kinds = [_kind(e) for e in meta[2]]
        n_inst = (len(extras["dfused"][0][3]) if "dfused" in extras
                  else None)
        desc = (f"extras {sorted(extras)}; run tables (enc, delta, width, "
                f"class) {[e[:3] + (k,) for e, k in zip(meta[2], kinds)]}; "
                f"block tables {[e[:3] for e in meta[3]]}; DIA tables "
                f"{[(a, len(o)) for a, o, _n in meta[4]]}; "
                + _fused_desc(meta))
        if not (set(extras) == {"dfused"} and kinds
                and set(kinds) == {"cvt"} and not meta[3]
                and not any(offs for _a, offs, _n in meta[4])
                and n_inst == instances):
            fail(f"[{label}] expected dfused alone with cvt run tables and "
                 f"{instances} route instances: {desc}")
        say(f"[{label}] plan: {desc}")
        return ex
    return check


def check_dense_plan(style):
    """A plan check for the dense-tile K1 style ``style``: ``sl`` the delta
    pipeline in style sl; ``run{W}`` a fused run table in that style."""
    def check(mat, label):
        ex = mat.csx.executors[0]
        extras = extras_of(ex.meta)
        if style == "sl":
            ok = ("dfused" in extras
                  and extras["dfused"][0][6] == "sl")
        else:
            ok = any(m[5] == style for _, m in fused_runs(ex.meta))
        if not ok:
            fail(f"[{label}] no K1 part in style {style}: "
                 f"{_fused_desc(ex.meta)}")
        say(f"[{label}] plan: {_fused_desc(ex.meta)}")
        return ex
    return check


def check_fs_plan(kind):
    """A plan check for a table routed through a partial segment: ``runs``
    one paged run table with an ``fs`` route beside the fused delta
    pipeline (``dfused``); ``blocks`` at least one paged block table with
    an ``fs`` route."""
    def check(mat, label):
        ex = mat.csx.executors[0]
        extras = extras_of(ex.meta)
        fs = fs_tables(ex.meta)
        kinds = [k for k, _i, e in fs if e[3]]
        ok = (kinds == ["runs"] and "dfused" in extras if kind == "runs"
              else "blocks" in kinds)
        desc = (f"extras {sorted(extras)}; fs tables "
                + str([(k, e[:4], len(e[4][1]), e[4][2], e[4][3])
                       for k, _i, e in fs]) + "; " + _fused_desc(ex.meta))
        if not ok:
            fail(f"[{label}] no paged {kind} table with an fs route: {desc}")
        say(f"[{label}] plan: {desc}")
        return ex
    return check


def check_overlap_plan(mat, label):
    """``overlap_run_matrix``'s plan: no fused run table whose route
    instances overlap outside a merged plan (the port re-plans it as a
    paged run table with an ``fs`` route)."""
    from sparsex_tpu_torch.ops.kernels import _kind, unmerged_overlapping_runs
    ex = mat.csx.executors[0]
    fs = fs_tables(ex.meta)
    runs = [(e[:3], e[3], e[4][0] if e[4] else None, _kind(e))
            for e in ex.meta[2]]
    desc = (f"extras {sorted(extras_of(ex.meta))}; run tables (enc, delta, "
            f"width), pages, route, class: {runs}; fs tables "
            f"{[(k, e[:3], len(e[4][1])) for k, _i, e in fs]}")
    if (unmerged_overlapping_runs(ex.meta)
            or not any(k == "runs" for k, _i, _e in fs)):
        fail(f"[{label}] expected the width-16 run table re-planned with an "
             f"fs route, no overlapping fused run outside a merged plan: "
             f"{desc}")
    say(f"[{label}] plan: {desc}")
    return ex


def check_pages_plan(mat, kind, label):
    """The plans of the non-fused variants, as the reference planner makes
    them: ``hpcg`` the plain-table variant, one DIA table of 27 diagonals
    and nothing else; ``headline`` the paged delta stream (``dpages``, no
    scatter route: too sparse for row blocks, it keeps the planner's
    layout) and one standalone DIA table of 5; ``blocky`` the paged delta
    stream (likewise) with paged run and block tables; ``urand`` the paged
    delta stream laid out in row blocks (``drows``, the port's own layout)
    and no DIA, run or block table."""
    ex = mat.csx.executors[0]
    meta = ex.meta
    extras = extras_of(meta)
    dias = [(anti, len(offs)) for anti, offs, _n in meta[4]]
    paged = paged_tables(meta)
    want = {
        "hpcg": (ex.variant == "plain" and meta[2:4] == ((), ())
                 and dias == [(False, 27)] and ex.arrays["delta"] is None),
        "headline": (ex.variant == "paged" and set(extras) == {"dpages"}
                     and dias == [(False, 5)]),
        "blocky": (ex.variant == "paged" and set(extras) == {"dpages"}
                   and {k for k, _i, _e in paged} == {"runs", "blocks"}),
        "urand": (ex.variant == "paged" and set(extras) == {"drows"}
                  and meta[2:4] == ((), ()) and not dias),
    }[kind]
    delta = ex.arrays["delta"]
    desc = (f"{ex.variant} variant; extras {extras}; DIA tables {dias}; "
            f"run tables {[e[:4] for e in meta[2]]}; block tables "
            f"{[e[:4] for e in meta[3]]}; plain delta "
            f"{0 if delta is None else delta['cols'].shape[0]}")
    if not want:
        fail(f"[{label}] unexpected {kind} plan: {desc}")
    say(f"[{label}] plan: {desc}")
    return ex


def check_nofuse_plan(kind):
    """A plan check for the fused pipeline kept off (``NO_FUSE``):
    ``headline`` the paged delta stream with its scatter route (``dpages``
    + ``dscatter``) and one standalone DIA table of 5 diagonals;
    ``blocky`` the routed paged delta stream, a fused block table
    (``fblk``) whose block rows a merged plan takes (``fall`` of ``blk``
    segments, with ``bres`` residuals), and a paged run table routed
    through a partial segment (``fs``)."""
    def check(mat, label):
        ex = mat.csx.executors[0]
        meta = ex.meta
        extras = extras_of(meta)
        dias = [(anti, len(offs)) for anti, offs, _n in meta[4]]
        fall = extras.get("fall")
        if kind == "headline":
            ok = set(extras) == {"dpages", "dscatter"} and dias == [
                (False, 5)]
        else:
            ok = (set(extras) == {"dpages", "dscatter", "fall"}
                  and len(fblk_tables(meta)) == 1
                  and {seg[0] for seg in fall[0]} == {"blk"}
                  and {rd[0] for rd in fall[3]} == {"bres"}
                  and [k for k, _i, _e in fs_tables(meta)] == ["runs"])
        dscatter = extras.get("dscatter", ((), None))
        desc = (f"{ex.variant} variant; extras {sorted(extras)}; DIA "
                f"tables {dias}; dscatter instances "
                f"{[m[:10] for m in dscatter[0]]} residuals {dscatter[1]}; "
                f"fblk tables {[e[:4] for _bi, e in fblk_tables(meta)]}; "
                f"fs tables {[e[:4] for _k, _i, e in fs_tables(meta)]}; "
                f"run tables {[e[:3] for e in meta[2]]}")
        if fall is not None:
            desc += (f"; merged segments {fall[0]} instances "
                     f"{[m[:10] for m in fall[1]]} residuals {fall[3]}")
        if not (ex.variant == "paged" and ok):
            fail(f"[{label}] unexpected {kind} plan with the fused pipeline "
                 f"off: {desc}")
        say(f"[{label}] plan: {desc}")
        return ex
    return check


def check_sym_plan(kind):
    """A plan check for a symmetric matrix (``SYMMETRIC``) in its mode in
    use.  The full mirror: a plain executor of the mirrored tables,
    ``hpcg`` the plain-table variant with one DIA table of 27 diagonals,
    ``symmetric`` the fused delta pipeline (the mirrored singles) with the
    DIA tables in K3.  Per shard: the shard's own executor, ``hpcg`` its 13
    lower diagonals and nothing else (the diagonal in ``dvals``),
    ``symmetric`` both paged delta streams (``dpages``, ``dpagesT``)."""
    def check(mat, label):
        from sparsex_tpu_torch.symmetric import SymShardExecutor
        csx = mat.csx
        ex = csx.executors[0]
        meta = ex.meta
        extras = extras_of(meta)
        dias = [(anti, len(offs)) for anti, offs, _n in meta[4]]
        full = csx._full_active()
        shard = isinstance(ex, SymShardExecutor)
        if kind == "hpcg":
            ok = (not extras and (dias == [(False, 13)] and shard
                                  and ex.arrays["delta"] is None
                                  if not full else
                                  dias == [(False, 27)] and not shard))
        else:
            ok = ({"dpages", "dpagesT"} <= set(extras) and shard
                  if not full else "dfused" in extras and not shard)
        desc = (f"{'full mirror' if full else 'per shard'}: {ex.variant} "
                f"variant; extras {sorted(extras)}; DIA tables {dias}; run "
                f"tables {[e[:3] for e in meta[2]]}; block tables "
                f"{[e[:3] for e in meta[3]]}")
        for stream, route in (("dpages", "dscatter"),
                              ("dpagesT", "dscatterT")):
            if stream in extras:
                desc += f"; {stream} {extras[stream]}"
            if route in extras:
                desc += (f"; {route} instances "
                         f"{[m[:10] for m in extras[route][0]]} residuals "
                         f"{extras[route][1]}")
        if full:
            desc += "; " + _fused_desc(meta)
        desc += f"; {csx.nnz} nonzeros stored (lower triangle, diagonal)"
        if not ok:
            fail(f"[{label}] unexpected {kind} plan: {desc}")
        say(f"[{label}] plan: {desc}")
        return ex
    return check


def check_shards(kind):
    """A plan check for a matrix of several shards (``spx.rt.nr_threads``):
    each shard's plan printed, and checked to be ``headline``'s (the fused
    delta pipeline with the DIA tables in K3, or, where a shard's singles
    are too sparse in its columns for the fused and paged delta planners,
    as at 4 shards of 2^20 rows, the plain tables: the DIA kernel on the 5
    diagonals and the singles in torch), ``blocky``'s (the delta
    pipeline and the width-8 and width-2 fused run tables, lane-placed
    ``rlp{W}`` or, where a shard's units are too sparse for lane
    placement, dense-tile ``run{W}``, in one merged plan) or, for
    ``symmetric``, the full mirror's one executor (the fused delta
    pipeline) or each shard's per-shard plan (both paged delta streams) at
    its own ``row_start``.  Returns the executors of the mode in use."""
    def check(mat, label):
        from sparsex_tpu_torch.symmetric import SymShardExecutor
        csx = mat.csx
        csx._executor()
        exs = list(csx.executors)
        full = kind == "symmetric" and csx._full_active()
        part = csx.partition
        if part.nparts < 2 or len(csx.shards) != part.nparts:
            fail(f"[{label}] {part.nparts} shards, expected several")
        for i, ex in enumerate(exs):
            meta = ex.meta
            extras = extras_of(meta)
            styles = {m[5] for _, m in fused_runs(meta)}
            if kind == "headline":
                ok = ({"dfused", "k3dias"} <= set(extras) or (
                    ex.variant == "plain" and not extras
                    and [(a, len(o)) for a, o, _n in meta[4]] == [
                        (False, 5)]))
            elif kind == "blocky":
                ok = ({"dfused", "fall"} <= set(extras)
                      and sorted(meta[2][ri][2] for ri, _ in
                                 fused_runs(meta)) == [2, 8] and styles <= {"rlp2", "rlp8", "run2",
                                                     "run8"}
                      and len(styles) == 2)
            elif full:
                ok = (len(exs) == 1 and "dfused" in extras
                      and not isinstance(ex, SymShardExecutor))
            else:
                ok = ({"dpages", "dpagesT"} <= set(extras)
                      and isinstance(ex, SymShardExecutor)
                      and ex.row_start == part.row_start[i])
            where = ("the full mirror of all shards" if full else
                     f"shard {i}: rows [{part.row_start[i]}, "
                     f"{part.row_end[i]}), {part.nnz_per_part[i]} nonzeros")
            desc = (f"{where}; {ex.variant} variant; extras "
                    f"{sorted(extras)}; DIA tables "
                    f"{[(a, len(o)) for a, o, _n in meta[4]]}; "
                    + _fused_desc(meta))
            for stream in ("dpages", "dpagesT", "dscatter", "dscatterT"):
                if stream in extras:
                    desc += f"; {stream} {str(extras[stream])[:80]}"
            if not ok:
                fail(f"[{label}] unexpected {kind} shard plan: {desc}")
            say(f"[{label}] plan, {desc}")
        return exs
    return check


# ---------------------------------------------------------------------------
# kernels against their plain versions, with their bounds
# ---------------------------------------------------------------------------

def cmp(name, label, got, want, exact):
    """Max abs error of a kernel against its plain version; fails unless
    bit-equal (``exact``) or within 1e-6 of the largest value."""
    import torch
    err = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    if exact and not torch.equal(got, want):
        fail(f"{name} [{label}]: not bit-equal to its plain version (max "
             f"abs err {err:.3e})")
    if not exact and not err <= 1e-6 * scale:
        fail(f"{name} [{label}]: max abs err {err:.3e} > 1e-6 x "
             f"{scale:.3e}")
    return err


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _distinct(idx, mask):
    """The number of distinct indices ``idx[mask]``."""
    import torch
    return int(torch.unique(idx[mask]).numel())


def _kb(t, dims):
    """The number of columns of an operand that is k-batched past ``dims``
    dimensions (1 for the SpMV's)."""
    return t.shape[0] if t.dim() > dims else 1


def _bound_k1(a, out):
    """K1: plo, mg, vals read and out written once, plus each distinct x
    value that a slot holding a value reads, in each of the kb columns;
    one multiply per slot and log2(W) adds for the run styles, per
    column."""
    from sparsex_tpu_torch.ops import fused as tf
    plo, mg, vals, x2, q, style = a
    idx, ok = tf.k1_x_index(plo, mg, q, style)
    W = tf.k1_style(style)[1]
    kb = _kb(x2, 3)
    return (_nbytes(plo, mg, vals, out)
            + kb * _distinct(idx, ok & (vals != 0)) * x2.element_size(),
            kb * vals.numel() * max(1, W.bit_length()))


def _bound_pages(a, out):
    """The delta-pages product (plo, sl, vals, x2, q) and the unit-page
    gather (plo, sl, x2, q): the streams and out once, plus each distinct x
    value the windows read."""
    from sparsex_tpu_torch.ops import pallas_kernels as tpk
    plo, sl, *vals, x2, q = a
    idx, ok = tpk.window_index(plo, sl, q)
    if vals:
        ok = ok & (vals[0] != 0)
    return (_nbytes(plo, sl, *vals, out)
            + _distinct(idx, ok) * x2.element_size(),
            vals[0].numel() if vals else 0)


def _bound_pages_acc(a, out):
    """The delta-pages product's scatter epilogue (plo, sl, vals, x2, q,
    acc, rows): the streams once, each distinct x value the windows read,
    and a read and a write of each distinct accumulator row in range; a
    multiply and an add per value."""
    plo, sl, vals, x2, q, acc, rows = a
    nbytes, _ops = _bound_pages((plo, sl, vals, x2, q), None)
    return (nbytes + _nbytes(rows) + 2 * _distinct(
        rows, (rows >= 0) & (rows < acc.shape[0])) * acc.element_size(),
        2 * vals.numel())


def _bound_rowblock_acc(a, out):
    """The row-blocked scatter epilogue (plo, sl, lrow, vals, x2, q, acc,
    blk_tile, rb): as the delta-pages epilogue's, its local rows the
    stream of rows."""
    from sparsex_tpu_torch.ops import pallas_kernels as tpk
    plo, sl, lrow, vals, x2, q, acc, blk_tile, rb = a
    rows = tpk._rowblock_rows(lrow, blk_tile, rb)
    nbytes, ops = _bound_pages_acc((plo, sl, vals, x2, q, acc, rows), out)
    return nbytes - _nbytes(rows) + _nbytes(lrow, blk_tile), ops


def _bound_units(a, out):
    """The paged-units kernel (plo, sl, vals, x2, q, each): plo, sl and
    vals read and the partials written once, plus each distinct x value
    that a slot feeding a nonzero value reads; a multiply and an add per
    value."""
    from sparsex_tpu_torch.ops import pallas_kernels as tpk
    plo, sl, vals, x2, q, _each, *scatter = a
    su = vals.shape[-1]                    # window slots per unit
    idx, ok = tpk.window_index(plo, sl, q)
    used = slice(0, tpk.PAGE // su * su)   # a tile's slots that hold units
    idx = idx.reshape(plo.shape[0], -1)[:, used].reshape(-1, su)
    ok = ok.reshape(plo.shape[0], -1)[:, used].reshape(-1, su)
    nz = (vals != 0).any(1) if vals.dim() == 3 else vals != 0
    nbytes = (_nbytes(plo, sl, vals)
              + _distinct(idx, ok & nz) * x2.element_size())
    if scatter:   # the epilogue: dest read, each row of acc read + written
        acc, dest = scatter
        nbytes += _nbytes(dest) + 2 * _distinct(
            dest, (dest >= 0) & (dest < acc.shape[0])) * acc.element_size()
    else:
        nbytes += _nbytes(out)
    return nbytes, 2 * vals.numel()


def _bound_k3(a, out):
    """K3: the E1s, g3, dv / adv and x blocks read and y written once; one
    add per g3 wire and a multiply-add per dv / adv value, per column."""
    e1s, g3s, dv, _do, adv, _ao, xb, xrb, _ncols, _d2r = a
    kb = _kb(out, 3)
    return (_nbytes(*e1s, *g3s, dv, adv, xb, xrb, out),
            kb * (sum(g.numel() for g in g3s)
                  + 2 * sum(t.numel() for t in (dv, adv) if t is not None)))


# per kernel: (bytes, operations) of one call from its arguments and output;
# a k-batched call reads its metadata (wires, tile streams, dv) once and its
# values and output kb times (the operands' own sizes say so)
BOUNDS = {
    "k1": _bound_k1, "k1_rlp": _bound_k1, "k1_sl": _bound_k1,
    "k1_run": _bound_k1,
    "t1": lambda a, out: (_nbytes(a[0], out), 0),
    "k2": lambda a, out: (_nbytes(*a[:4], out), 0),
    "k3": _bound_k3,
    "lane_gather": lambda a, out: (_nbytes(a[0], a[1], out),
                                   _kb(out, 2) * a[1].numel()),
    "dia": lambda a, out: (_nbytes(a[0], a[1], out), 2 * a[0].numel()),
    "delta_pages": _bound_pages,
    "delta_pages_acc": _bound_pages_acc,
    "delta_rowblock_acc": _bound_rowblock_acc,
    "paged_gather": _bound_pages,
    "paged_units": _bound_units,
}
BOUNDS.update({key + "_kb": BOUNDS[key] for key in
               ("k1", "k1_rlp", "k1_sl", "k1_run", "t1", "k2", "k3",
                "lane_gather")})


def _library_t1(a):
    a1, A2R = a
    lead = a1.shape[:-2]
    return lambda: a1.view(lead + (A2R, 128, 128)).transpose(-2, -1) \
        .contiguous()


def _library_paged_gather(a):
    import torch
    from sparsex_tpu_torch.ops import pallas_kernels as tpk
    plo, sl, x2, q = a
    idx, _ok = tpk.window_index(plo, sl, q)
    flat = x2.reshape(-1)
    return lambda: torch.take(flat, idx)


def _library_delta_pages(a):
    """``torch.take`` of the window values times the values, and for the
    scatter epilogue ``index_add_`` of the products of the slots whose row
    is in range (selected beforehand)."""
    import torch
    from sparsex_tpu_torch.ops import pallas_kernels as tpk
    plo, sl, vals, x2, q, *scatter = a
    idx = tpk.window_index(plo, sl, q)[0].reshape(-1)
    flat, v = x2.reshape(-1), vals.reshape(-1)
    if not scatter:
        return lambda: torch.take(flat, idx) * v
    acc, rows = scatter
    keep = (rows >= 0) & (rows < acc.shape[0])
    idx, v, rows = idx[keep], v[keep], rows[keep]
    return lambda: acc.index_add_(0, rows, torch.take(flat, idx) * v)


def _library_delta_rowblock(a):
    """``_library_delta_pages`` of the row-blocked stream, its rows made
    from the local rows beforehand."""
    from sparsex_tpu_torch.ops import pallas_kernels as tpk
    plo, sl, lrow, vals, x2, q, acc, blk_tile, rb = a
    return _library_delta_pages((plo, sl, vals, x2, q, acc,
                                 tpk._rowblock_rows(lrow, blk_tile, rb)))


def _library_paged_units(a):
    """The glue the paged-units kernel replaced: ``torch.take`` of the
    window values, the multiply and the unit sums (no sum for ``each``),
    and for the scatter epilogue ``index_add_``."""
    import torch
    from sparsex_tpu_torch.ops import pallas_kernels as tpk
    plo, sl, vals, x2, q, each, *scatter = a
    su = vals.shape[-1]
    idx = tpk.window_index(plo, sl, q)[0].reshape(plo.shape[0], -1)
    idx = idx[:, : tpk.PAGE // su * su].reshape(-1, su)
    flat = x2.reshape(-1)
    if each:
        def partials():
            return torch.take(flat, idx) * vals
    elif vals.dim() == 3:
        def partials():
            return (vals * torch.take(flat, idx).unsqueeze(-2)).sum(-1)
    else:
        def partials():
            return (torch.take(flat, idx) * vals).sum(-1)
    if not scatter:
        return partials
    acc, dest = scatter     # and index_add_ (every row in range here)
    return lambda: acc.index_add_(0, dest, partials().reshape(-1))


# per kernel with one: the PyTorch call that computes the same function on
# the same inputs (indices precomputed), timed as a yardstick only
LIBRARY = {"t1": _library_t1, "t1_kb": _library_t1,
           "delta_pages": _library_delta_pages,
           "delta_pages_acc": _library_delta_pages,
           "delta_rowblock_acc": _library_delta_rowblock,
           "paged_gather": _library_paged_gather,
           "paged_units": _library_paged_units}


def check_kernel(res, label, timed, name, fn, plain, args, exact=True,
                 loops=LOOPS, outer=OUTER, fresh=None):
    """``fn`` (a kernel wrapper) against ``plain`` on each argument tuple in
    ``args``; ``res[name]`` holds the max abs error and, when ``timed``, the
    kernel's, the plain version's and the PyTorch call's ms for all the
    calls (one CUDA graph each, ``loops`` x ``outer`` replays), and the
    bound of the same work.  ``fresh`` maps an argument tuple to the one
    each checked call gets (a kernel that adds into an operand in place
    gets a fresh copy of it, where the timed calls keep adding into one).
    Returns the kernel's outputs."""
    import torch
    fresh = fresh or (lambda a: a)
    outs = [fn(*fresh(a)) for a in args]
    if outs and outs[0].is_cuda:
        torch.cuda.synchronize()
    errs = [cmp(name, label, o, plain(*fresh(a)), exact)
            for o, a in zip(outs, args)]
    entry = dict.fromkeys(("ms", "plain_ms", "bound_ms", "bound_by",
                           "library_ms"))
    entry["max_abs_err"] = max(errs)
    res[name] = entry
    if not timed:
        return outs
    entry["ms"], entry["plain_ms"] = paired_ms(
        lambda: [fn(*a) for a in args], lambda: [plain(*a) for a in args],
        loops, outer)
    nbytes = flops = 0
    for o, a in zip(outs, args):
        b, f = BOUNDS[name](a, o)
        nbytes, flops = nbytes + b, flops + f
    dt = str(outs[0].dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    entry["bound_ms"] = max(t_bytes, t_ops)
    entry["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    if name in LIBRARY:
        calls = [LIBRARY[name](a) for a in args]
        entry["library_ms"] = graph_time_ms(lambda: [c() for c in calls],
                                            loops, outer)
    return outs


def paged_units_args(ex, x):
    """The paged-units kernel's argument tuple for each paged table, as
    ``local_contrib`` gives it: the plan's window stream, the table's first
    T*g units' values, the shared page grid, q, whether each product is its
    own partial (a diagonal or anti-diagonal run table) and, where the
    table is scatter-added (no ``fs`` route), an accumulator of nrows
    zeros and the partials' destination rows (the scatter epilogue)."""
    import torch
    from sparsex_tpu_torch.ops import kernels as tk
    x2 = tk.paged_grid(ex.meta, x, ex.ncols)
    routed = {(k, i) for k, i, _e in fs_tables(ex.meta)}
    args = []
    for kind, i, e in paged_tables(ex.meta):
        t = ex.arrays[kind][i]
        T, q, g, _npages = e[3]
        each = tk._unit_layout(kind, e, x.device)[1]
        a = (t["plan"]["plo"], t["plan"]["sl"], t["vals"][:T * g], x2, q,
             each)
        if (kind, i) not in routed:
            dest = tk.unit_dest(kind, e, t, ex.nrows)
            a += (torch.zeros(ex.nrows, dtype=x.dtype, device=x.device),
                  dest[:dest.shape[0] // t["cols"].shape[0] * T * g])
        args.append(a)
    return args


def _fresh_acc(a):
    """A paged-units argument tuple with a zeroed copy of its accumulator:
    the scatter epilogue adds into it in place."""
    return a if len(a) == 6 else a[:6] + (a[6].clone().zero_(), a[7])


def _fresh_delta_acc(a):
    """A delta-pages epilogue argument tuple with a zeroed copy of its
    accumulator."""
    return a[:5] + (a[5].clone().zero_(), a[6])


def _fresh_rowblock_acc(a):
    """A row-blocked epilogue argument tuple with a zeroed copy of its
    accumulator."""
    return a[:6] + (a[6].clone().zero_(),) + a[7:]


# per kernel that adds into an operand in place: the argument tuple each
# checked call gets (check_kernel's ``fresh``)
FRESH = {"paged_units": _fresh_acc, "delta_pages_acc": _fresh_delta_acc,
         "delta_rowblock_acc": _fresh_rowblock_acc}


def unit_kernels(res, ex, x, label, timed, loops=LOOPS, outer=OUTER):
    """The paged-units kernel on every paged table of an SpMV (bit-equal
    to its plain version where it writes partials, within 1e-6 where it
    scatter-adds them, as ``index_add_`` does, in no fixed order), then the
    unit-page gather (held against ``gather_plain`` and ``torch.take``):
    on each fused block table's window stream (``fblk``, where the path
    runs it), else on the paged tables' streams, which the paged-units
    kernel took it off.  No path has both paged-units forms: bit-equality
    is asked where every call writes partials."""
    from sparsex_tpu_torch.ops import kernels as tk
    from sparsex_tpu_torch.ops import pallas_kernels as tpk
    args = paged_units_args(ex, x)
    if args:
        check_kernel(res, label, timed, "paged_units", tpk.paged_units,
                     tpk.paged_units_plain, args,
                     all(len(a) == 6 for a in args), loops, outer,
                     fresh=_fresh_acc)
    gathers = [a[:2] + a[3:5] for a in args]
    if fblk_tables(ex.meta):
        x2 = tk.paged_grid(ex.meta, x, ex.ncols)
        gathers = [(ex.arrays["blocks"][bi]["plan"]["plo"],
                    ex.arrays["blocks"][bi]["plan"]["sl"], x2, e[3][1])
                   for bi, e in fblk_tables(ex.meta)]
    if gathers:
        check_kernel(res, label, timed, "paged_gather", tpk.gather,
                     tpk.gather_plain, gathers, loops=loops, outer=outer)


def delta_pages_kernels(res, ex, x, x2, label, timed, loops=LOOPS,
                        outer=OUTER):
    """The delta-pages kernel on each paged delta stream of an SpMV (the
    direct ``dpages`` and a symmetric shard's transposed ``dpagesT``): the
    product form (bit-equal to its plain version) on each stream with a
    scatter route, the scatter epilogue (``delta_pages_acc``, within 1e-6:
    atomic adds in no fixed order) on each stream without one, into an
    accumulator of the stream's rows; the row-blocked epilogue
    (``delta_rowblock_acc``, likewise) on a ``drows`` stream.  A shard
    whose transposed stream is routed has its epilogue held too, on that
    stream, off the path."""
    import torch
    from sparsex_tpu_torch.ops import pallas_kernels as tpk
    extras = extras_of(ex.meta)
    products, epilogue = [], []
    for stream, key, route, n in (("dpages", "delta_pages", "dscatter",
                                   ex.nrows),
                                  ("dpagesT", "delta_pages_t", "dscatterT",
                                   ex.ncols)):
        if stream not in extras:
            continue
        rep = ex.arrays[key]
        a = (rep["plo"], rep["sl"], rep["vals"], x2, extras[stream][1])
        if route in extras:
            products.append(a)
        else:
            epilogue.append(a + (torch.zeros(n, dtype=x.dtype,
                                             device=x.device), rep["rows"]))
    if not epilogue and "dscatterT" in extras:    # off the path
        rep = ex.arrays["delta_pages_t"]
        epilogue.append((rep["plo"], rep["sl"], rep["vals"], x2,
                         extras["dpagesT"][1],
                         torch.zeros(ex.ncols, dtype=x.dtype,
                                     device=x.device),
                         transposed_rows(ex).to(x.device)))
    if products:
        check_kernel(res, label, timed, "delta_pages", tpk.delta_pages,
                     tpk.delta_pages_plain, products, True, loops, outer)
    if epilogue:
        check_kernel(res, label, timed, "delta_pages_acc", tpk.delta_pages_acc,
                     tpk.delta_pages_acc_plain, epilogue, False, loops, outer,
                     fresh=_fresh_delta_acc)
    if "drows" in extras:
        rep, (_T, q, _np, rb) = ex.arrays["delta_rows"], extras["drows"]
        check_kernel(res, label, timed, "delta_rowblock_acc",
                     tpk.delta_rowblock_acc, tpk.delta_rowblock_acc_plain,
                     [(rep["plo"], rep["sl"], rep["lrow"], rep["vals"], x2, q,
                       torch.zeros(ex.nrows, dtype=x.dtype, device=x.device),
                       rep["blk_tile"], rb)], False, loops,
                     outer, fresh=_fresh_rowblock_acc)


def transposed_rows(ex):
    """The destination row of each slot of a symmetric shard's transposed
    delta stream (int32): the planner's rows, which a routed stream's plan
    drops (its scatter route holds them), made again from the shard's
    tables by the planner call of ``symmetric.shard_plan``."""
    import torch
    from sparsex_tpu_torch.ops import pallas_kernels as tpk
    from sparsex_tpu_torch.ops.route import fold_sort_key
    d, r0, n = ex.tables.delta, ex.tables.row_start, ex.nrows_glob
    rows = np.asarray(d.row_ids, dtype=np.int64) + r0
    cols = np.asarray(d.cols, dtype=np.int64)
    rep, _left = tpk.build_delta_pages(rows, cols, np.asarray(d.vals), n, n,
                                       sort_key=fold_sort_key(cols, n, rows))
    if not np.array_equal(rep["plo"],
                          ex.arrays["delta_pages_t"]["plo"].cpu().numpy()):
        fail("the transposed delta stream planned again differs from the "
             "executor's")
    return torch.from_numpy(rep["rows"])


def scatter_lane_args(ex, x):
    """The lane gathers' argument tuples of every legacy scatter route of
    an SpMV: the paged delta products' (``dscatter``, and a symmetric
    shard's transposed ``dscatterT`` into all its ncols rows) and each
    routed table's partials', five a route instance, each stage's input
    made from the previous stage's output as ``route.apply_scatter_plan``
    makes it (through the plain lane gather)."""
    import torch.nn.functional as F
    from sparsex_tpu_torch.ops import kernels as tk
    from sparsex_tpu_torch.ops import pallas_kernels as tpk
    from sparsex_tpu_torch.ops import route as troute
    meta, arrs, ncols = ex.meta, ex.arrays, ex.ncols
    extras = extras_of(meta)
    x2 = tk.paged_grid(meta, x, ncols)
    args = []

    def record(xs, idx):
        args.append((xs, idx))
        return troute.lane_gather_plain(xs, idx)

    for stream, key, route, plan, n_dest in (
            ("dpages", "delta_pages", "dscatter", "delta_scatter", ex.nrows),
            ("dpagesT", "delta_pages_t", "dscatterT", "delta_scatter_t",
             ncols)):
        if route in extras:
            prods = tpk.delta_pages_products(extras[stream], arrs[key], x,
                                             ncols, x2=x2)
            troute.apply_scatter_plan(extras[route][0],
                                      arrs[plan]["chunks"], prods, n_dest,
                                      gather=record)
    for kind, i, e in routed_tables(meta):
        t = arrs[kind][i]
        part = tk.unit_table_partials(kind, e, t, x, ncols, ex.nrows,
                                      x2)[0].reshape(-1)
        troute.apply_scatter_plan(e[4][0], t["scatter"]["chunks"],
                                  F.pad(part, (0, e[4][2] - part.shape[0])),
                                  ex.nrows, gather=record)
    return args


def kernel_phase(ex, x, label, timed=True, loops=LOOPS, outer=OUTER):
    """Every kernel of a path against its plain version, on the plan's
    arrays at the main path's shapes, each stage fed what
    ``local_contrib`` feeds it: K1 on every part (the delta bulk and tail,
    each fused run table), grouped by the kernel its style runs; the DIA
    kernel per standalone DIA table (in its zero-padded x frame), the
    delta-pages product over the shared page grid; the paged-units kernel
    on each paged table and the unit-page gather (``unit_kernels``); then
    per route instance, the merged plan's (its G1 lane gather over the
    merged source grid, fblk block-row streams included) or each
    segment's own, T1 and K2 (raw g2b wires where um & 1); per instance of
    a table's partial-segment route (``fs``) and of each fblk block row's
    segment outside a merged plan, the G1 lane gather over its partials,
    T1 and K2; the five lane gathers of each instance of a legacy scatter
    route (``scatter_lane_args``) with the other lane gathers; then K3,
    where the path runs it, over every instance in calls of 8, the first
    with the DIA tables that ride it (masked g3 where um & 2 is 0).  A
    k-major x (kb, ncols), kb <= 8, is one chunk of an SpMM
    (``fused_mm_contrib``'s input): every kernel then runs its k-batched
    variant, named with ``_kb``, and the unit tables take torch glue.  All
    but K3 and the paged-units scatter epilogue must be bit-equal.
    Returns {name: entry} (``check_kernel``)."""
    import torch
    import torch.nn.functional as F
    from sparsex_tpu_torch.ops import fused as tf
    from sparsex_tpu_torch.ops import kernels as tk
    from sparsex_tpu_torch.ops import pallas_kernels as tpk
    from sparsex_tpu_torch.ops import route as troute

    meta, arrs, ncols = ex.meta, ex.arrays, ex.ncols
    D2R = tf._d2r(ex.nrows)
    extras = extras_of(meta)
    x2f = tk.shared_page_grid(meta, x, ncols)
    res = {}

    sfx = "_kb" if x.dim() == 2 else ""

    def run(name, fn, plain, args, exact=True):
        return check_kernel(res, label, timed, name + sfx, fn, plain, args,
                            exact, loops, outer)

    k1_args = {}
    dfused = extras.get("dfused")
    if dfused is not None:
        fmeta, far = dfused[0], arrs["fused"]
        parts = [("", fmeta[1], fmeta[2], fmeta[6])]
        hybrid = len(fmeta) > 7 and fmeta[7] is not None
        if hybrid:
            parts.append(("2",) + tuple(fmeta[7][0][1:4]))
        # one page grid for both parts, as fused_delta_a1 shares it
        x2 = tf._k1_x2(x, ncols, max(p[1] for p in parts),
                       max(p[2] for p in parts),
                       "lp" if hybrid else fmeta[6], x2f)
        for s, q, _np, style in parts:
            k1_args.setdefault(tf.k1_key(style), []).append(
                (far["plo" + s], far["mg" + s], far["vals" + s], x2, q,
                 style))
    for ri, m in fused_runs(meta):
        fr = arrs["runs"][ri]["frun"]
        k1_args.setdefault(tf.k1_key(m[5]), []).append(
            (fr["plo"], fr["mg"], fr["vals"],
             tf._k1_x2(x, ncols, m[1], m[2], m[5], x2f), m[1], m[5]))
    for key in tf.KERNELS:
        if key in k1_args:
            run(key, tf.k1, tf.k1_plain, k1_args[key])

    x2 = tk.paged_grid(meta, x, ncols)
    scatter_args = []
    if not sfx:    # the SpMV's non-fused parts
        if meta[4] and "k3dias" not in extras:
            args = []
            for offs, dv, xs in tk.dia_tables(meta[4], arrs["dias"], x,
                                              ncols):
                xp, pad_lo = tpk.dia_frame(offs, xs, ex.nrows, ncols)
                args.append((dv, xp, offs, pad_lo))
            run("dia", tpk.dia, tpk.dia_plain, args)
        delta_pages_kernels(res, ex, x, x2, label, timed, loops, outer)
        unit_kernels(res, ex, x, label, timed, loops, outer)
        scatter_args = scatter_lane_args(ex, x)

    def padded(src, m):   # an instance's source rows, padded to S1p
        return F.pad(src[..., m[7]:m[8], :],
                     (0, 0, 0, m[1] - m[0])).contiguous()

    fall = extras.get("fall")
    g1_args, g1_insts = [], []     # (source rows, G1 wires), (w, i, m)
    blk = tk.fblk_streams(meta, arrs, x, ncols, x2) if not sfx else {}
    if fall is not None:
        src = tk.merged_source(meta, arrs, x, ncols, x2f, blk)
        fa = arrs["fall"]
        g1_insts = [(fa, i, m) for i, m in enumerate(fall[1])]
        g1_args = [(padded(src, m), fa[f"g1_{i}"][None])
                   for _w, i, m in g1_insts]
        insts, a1s = [], []
    else:
        segs = []
        if dfused is not None:
            segs.append((tf.fused_delta_a1(fmeta, far, x, ncols, x2=x2f),
                         far, fmeta[3]))
        for ri, m in fused_runs(meta):
            fr = arrs["runs"][ri]["frun"]
            segs.append((tf.fused_run_a1(m, fr, x, ncols, x2=x2f), fr, m[3]))
        insts = [(w, i, m) for _a1, w, inst in segs
                 for i, m in enumerate(inst)]
        a1s = [padded(a1, m) for a1, _w, inst in segs for m in inst]
    if not sfx:    # the SpMV's routed partials: fs routes, fblk rows
        streams = []
        for kind, ti, e in fs_tables(meta):
            t = arrs[kind][ti]
            part = tk.unit_table_partials(kind, e, t, x, ncols, ex.nrows,
                                          x2)[0].reshape(-1)
            streams.append((F.pad(part, (0, e[4][3] - part.shape[0])),
                            t["fscatter"], e[4][1]))
        if fall is None:
            for bi, e in fblk_tables(meta):
                streams += [(blk[(bi, r)], arrs["blocks"][bi][f"fb_{r}"],
                             inst) for r, (inst, _res, _m)
                            in enumerate(e[5][1])]
        for flat, w, inst in streams:
            src = flat.view(-1, 128)
            for i, m in enumerate(inst):
                g1_insts.append((w, i, m))
                g1_args.append((padded(src, m), w[f"g1_{i}"][None]))
    if g1_args or scatter_args:
        insts += g1_insts
        a1s += run("lane_gather", troute.lane_gather,
                   troute.lane_gather_plain,
                   g1_args + scatter_args)[:len(g1_args)]
    if insts:
        a1ts = run("t1", tf.t1, tf.t1_plain,
                   [(a1, m[2]) for a1, (_w, _i, m) in zip(a1s, insts)])
        e1s = run("k2", tf.k2, tf.k2_plain,
                  [(a1t, w[f"g2a_{i}"], w[f"g2b_{i}"], w[f"g2c_{i}"], m[6],
                    D2R) for a1t, (w, i, m) in zip(a1ts, insts)])
    if insts or "k3dias" in extras:
        g3s = [w[f"g3_{i}"] for w, i, _m in insts]
        dia_offs, anti_offs = extras.get("k3dias", ((), ()))
        dias = (arrs.get("dias_fused_dv"), tuple(dia_offs),
                arrs.get("dias_fused_adv"),
                tuple(ncols - 1 - s for s in anti_offs),
                tf._to_blocks(x)[0] if dia_offs else None,
                tf._to_blocks(torch.flip(x, (-1,)))[0] if anti_offs
                else None)
        step = tf.MAX_INSTANCES
        run("k3", tf.k3, tf.k3_plain,
            [(e1s[s:s + step] if insts else [], g3s[s:s + step],
              *(dias if s == 0 else (None, (), None, (), None, None)),
              ncols, D2R) for s in range(0, max(len(insts), 1), step)],
            exact=False)
    say_kernels(res, label)
    return res


def shards_kernel_phase(exs, x, label, timed=True, loops=LOOPS,
                        outer=OUTER):
    """:func:`kernel_phase` on each shard's executor ``exs`` (of a matrix of
    several shards, each labelled with its shard), merged into one entry a
    kernel: the largest error, and the times and bounds of all the shards'
    calls summed (the calls of one matrix SpMV), ``bound_by`` that of the
    shard with the largest bound.  ``x`` is every executor's input, or a
    list of each one's (a rank's local and halo executors read its x chunk
    and its halo window)."""
    xs = x if isinstance(x, list) else [x] * len(exs)
    if len(exs) == 1:
        return kernel_phase(exs[0], xs[0], label, timed, loops, outer)
    res, top = {}, {}
    for i, ex in enumerate(exs):
        for name, r in kernel_phase(ex, xs[i], f"{label} shard {i}", timed,
                                    loops, outer).items():
            acc = res.setdefault(name, dict.fromkeys(r, None))
            acc["max_abs_err"] = max(acc["max_abs_err"] or 0.0,
                                     r["max_abs_err"])
            for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                if r[key] is not None:
                    acc[key] = (acc[key] or 0.0) + r[key]
            if r["bound_ms"] is not None and r["bound_ms"] > top.get(name,
                                                                     -1):
                top[name] = r["bound_ms"]
                acc["bound_by"] = r["bound_by"]
    return res


def say_kernels(res, label):
    unit = "SpMM" if "spmm" in label else "SpMV"
    for name, r in res.items():
        line = f"kernel {name} [{label}]: max abs err {r['max_abs_err']:.3e}"
        if r["ms"] is not None:
            lib = r["library_ms"]
            line += (f"; {r['ms'] * 1e3:.2f} us vs plain "
                     f"{r['plain_ms'] * 1e3:.2f} us"
                     + ("" if lib is None else
                        f", PyTorch call {lib * 1e3:.2f} us")
                     + f", bound {r['bound_ms'] * 1e3:.2f} us "
                     f"({r['bound_by']}), per {unit}, each replayed alone "
                     "(inputs warm in L2)")
        say(line)


# ---------------------------------------------------------------------------
# the SpMV end to end
# ---------------------------------------------------------------------------

# the port's kernels by the names of their entry points (``<name>_kernel``
# or ``<name>_kb_kernel``; K1's lp style ``k1_lp``)
_KERNEL_NAMES = (r"k1_lp|k1_rlp|k1_sl|k1_run|t1|k2|k3|lane_gather|dia|"
                 r"delta_pages_acc|delta_pages|delta_rowblock_acc|"
                 r"paged_gather|paged_units")
# an entry point's mangled name, as the CUDA driver gives it
_MANGLED = re.compile(rf"\d({_KERNEL_NAMES})(_kb)?_kernelI")


def graph_kernels(graph, kb=False):
    """Launches of our kernels in one replay of ``graph`` (a
    ``torch.cuda.CUDAGraph`` kept with ``keep_graph=True``, as an
    executor's are), by key: the names of its kernel nodes, read through
    the CUDA driver (``cuGraphGetNodes``, ``cuFuncGetName``); a replay
    runs no Python, so the launch counters cannot see it.  PyTorch's glue
    kernels are left out.  ``kb`` as in :func:`profile_phase`."""
    import ctypes

    from sparsex_tpu_torch.device import driver_call, graph_nodes
    call = driver_call()
    out = {}
    for node, kind in graph_nodes(graph):
        if kind != 0:                        # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = (ctypes.c_byte * 128)()     # CUDA_KERNEL_NODE_PARAMS_v2
        call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), params)
        name = ctypes.c_char_p()
        call("cuFuncGetName", ctypes.byref(name),
             ctypes.c_void_p.from_buffer(params))   # its first field: func
        m = _MANGLED.search(name.value.decode())
        if m:
            key = (("k1" if m.group(1) == "k1_lp" else m.group(1))
                   + (m.group(2) or ""))
            if kb and not key.endswith("_kb"):
                key += "_kb"
            out[key] = out.get(key, 0) + 1
    return out


def check_graph(ex, key, call, eager, expect, label, kb=False):
    """The executor's first call for ``key`` ran (before this) as its
    warm-up and its graph's capture: ``expect`` (one call's launches, from
    the plan) twice over from Python, which the caller has checked.  Here:
    the graph is kept, a second call (a replay) launches nothing from
    Python, the graph's kernel nodes (:func:`graph_kernels`) are
    ``expect``'s by name and number, and the replay's result equals the eager body's on
    the same input (bit for bit, else within 1e-6 of its largest value:
    atomic adds reorder sums).  Returns (bit-equal, max |replay - eager| /
    max |eager|)."""
    import torch
    from sparsex_tpu_torch.ops import fused as tf
    if key not in ex._graphs:
        fail(f"[{label}] the executor kept no graph for {key}")
    tf.launches.clear()
    got = call()
    torch.cuda.synchronize()
    if any(tf.launch_counts().values()):
        fail(f"[{label}] a replay of {key} launched "
             f"{ {k: v for k, v in tf.launch_counts().items() if v} } "
             "from Python")
    names = graph_kernels(ex._graphs[key].graph, kb)
    want = {k: v for k, v in expect.items() if v}
    if names != want:
        fail(f"[{label}] the graph of {key} launches the kernels {names}, "
             f"expected {want}")
    ref = eager()
    torch.cuda.synchronize()
    exact = bool(torch.equal(got, ref))
    rel = float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
    say(f"[{label}] graph {key}: replay "
        + ("bit-equal to" if exact else f"within {rel:.3e} of")
        + f" the eager body; kernels in the graph {names}; the graph "
        f"took {ex.graph_bytes()[key] / 2**20:.2f} MiB")
    if not exact and not rel <= 1e-6:
        fail(f"[{label}] the replay of {key} differs from the eager body "
             f"by {rel:.3e}")
    return exact, rel


def e2e_phase(spx, tf, mat, rows, cols, vals, x, tol, dtype_name,
              timed=True):
    """Two SpMVs through matvec_kernel against the float64 COO oracle.  The
    first runs the SpMV from Python twice, the warm-up and the capture of
    the executor's graph, and then replays it: its launch counts must be
    twice one SpMV's (``expected_counts``); the second only replays
    (:func:`check_graph`).  Returns (counts of the first call, ms per SpMV
    called from Python, host ms to enqueue one, ms per SpMV replayed from a
    graph of the caller's, ms per SpMV of the eager body called from
    Python (the dispatch before graphs), oracle errors, the timed SpMV
    call); the times are None when not ``timed``."""
    import torch

    n = mat.nrows
    ex = mat.csx._executor()
    xh = x.double().cpu().numpy()
    # float64 COO oracle
    want = np.bincount(rows, weights=vals.astype(np.float64) * xh[cols],
                       minlength=n)
    y0 = np.random.default_rng(2).standard_normal(n)
    y0d = torch.as_tensor(y0, dtype=x.dtype, device=x.device)
    want2 = 2.0 * want + 0.5 * y0d.double().cpu().numpy()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    tf.launches.clear()
    y = spx.matvec_kernel(1.0, mat, x, 0.0, None)
    torch.cuda.synchronize()
    counts = tf.launch_counts()
    grown = torch.cuda.memory_allocated() - mem0
    one = matrix_counts(mat.csx)
    expect = {k: 2 * v for k, v in one.items()}
    if counts != expect:
        fail(f"[{dtype_name}] launch counts {counts} of the first SpMV (its "
             f"warm-up and its graph's capture), expected {expect}")
    y2 = spx.matvec_kernel(2.0, mat, x, 0.5, y0d)

    def eager():
        with ex._on_device():
            return ex._matvec(x)

    def spmv():
        return spx.matvec_kernel(1.0, mat, x, 0.0, None)

    check_graph(ex, ("mv",), spmv, eager, one, dtype_name)
    say(f"[{dtype_name}] memory_allocated grew {grown / 2**20:.2f} MiB over "
        "the first SpMV (the graph's static x and output, and the result)")
    errs = []
    for got, ref in ((y, want), (y2, want2)):
        g = got.double().cpu().numpy()
        if g.shape != (n,) or not np.isfinite(g).all():
            fail(f"[{dtype_name}] SpMV result has shape {g.shape} or "
                 "non-finite values")
        errs.append(_mixed_rel_err(g, ref))
    say(f"spmv [{dtype_name}]: oracle rel err {errs[0]:.3e} (alpha=1, "
        f"beta=0), {errs[1]:.3e} (alpha=2, beta=0.5); bar {tol:g}; "
        f"launches of the first SpMV (warm-up and capture) "
        f"{ {k: v for k, v in counts.items() if v} }")
    if not max(errs) < tol:
        fail(f"[{dtype_name}] SpMV diverges from the oracle: {errs} vs "
             f"{tol:g}")

    if not timed:
        return counts, None, None, None, None, errs, spmv
    ms = cuda_time_ms(spmv)
    # host time to enqueue one SpMV (no synchronisation inside the loop):
    # when it is close to ``ms`` the end-to-end time is set by the host
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LOOPS):
        spmv()
    host_ms = (time.perf_counter() - t0) * 1e3 / LOOPS
    torch.cuda.synchronize()
    eager_ms = cuda_time_ms(eager)
    return counts, ms, host_ms, graph_time_ms(spmv), eager_ms, errs, spmv


_KERNEL_NAME = re.compile(rf"\b({_KERNEL_NAMES})(_kb)?_kernel\b")


def trace_us(fn, reps):
    """{device event name: microseconds per call of ``fn``} from a
    torch.profiler trace of ``reps`` calls (after one call outside it):
    the kernels and copies, which do not nest; None when the trace holds
    no device event.  The events of CUDA graph replays are the graphs'
    kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    agg = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            agg[ev.name] = (agg.get(ev.name, 0.0)
                            + ev.time_range.elapsed_us() / reps)
    return agg or None


def kernel_key(name, kb=False):
    """The launch-count key of a kernel of ours by its device event name
    (``k1`` for K1 lp; with ``kb`` a kernel that serves both forms under
    one name, K2, counts under its ``_kb`` key), or None for any other
    kernel (the PyTorch glue)."""
    from sparsex_tpu_torch.ops.fused import KERNELS
    m = _KERNEL_NAME.search(name)
    if not m:
        return None
    key = ("k1" if m.group(1) == "k1_lp" else m.group(1)) + (m.group(2)
                                                              or "")
    return key + "_kb" if kb and key + "_kb" in KERNELS else key


def profile_phase(spmv, reps=50, kb=False):
    """Device microseconds per SpMV of each kernel and of the PyTorch glue
    kernels (pads, the hybrid interleave, the residual adds), from a
    torch.profiler trace of ``reps`` SpMVs (:func:`trace_us`): the kernels
    as the main path runs them, each finding in L2 what the previous one
    left.  Returns ``(us, glue)``, ``glue`` the four largest glue kernels
    by name, or ``(None, None)`` when the trace holds no device events.
    ``kb``: the calls are k-batched (:func:`kernel_key`)."""
    from sparsex_tpu_torch.ops.fused import KERNELS
    agg = trace_us(spmv, reps)
    if agg is None:
        return None, None
    us = dict.fromkeys(KERNELS + ("glue",), 0.0)
    glue = {}
    for name, t in agg.items():
        key = kernel_key(name, kb)
        us[key or "glue"] += t
        if key is None:
            glue[name[:70]] = glue.get(name[:70], 0.0) + t
    return us, sorted(glue.items(), key=lambda kv: -kv[1])[:4]


def report(label, mat, res, timing, profiled, nnz):
    """Print the profile and end-to-end lines of one timed path; returns
    its summary.  Gnnz/s counts ``nnz``, the nonzeros of the full matrix
    (a symmetric matrix's mirrored ones too, as bench.py:495-497 counts
    them)."""
    counts, ms, host_ms, graph_ms, eager_ms, errs, _spmv = timing
    prof, glue = profiled
    if prof is None:
        say(f"[{label}] profile: the trace holds no device events; in-SpMV"
            " kernel times not measured")
    else:
        dev_us = sum(prof.values())
        say(f"[{label}] profile (50 SpMVs): device {dev_us:.2f} us per SpMV"
            " = " + ", ".join(f"{k} {v:.2f}" for k, v in prof.items() if v)
            + f"; busy {100 * dev_us / (ms * 1e3):.1f}% of the "
            f"{ms * 1e3:.2f} us called from Python")
        say(f"[{label}] largest glue kernels (us per SpMV): "
            + "; ".join(f"{v:.2f} {k}" for k, v in glue))
    gnnz = nnz / (ms * 1e-3) / 1e9
    timed = all(r["ms"] is not None for r in res.values())
    dev_ms = sum(r["ms"] for r in res.values()) if timed else None
    say(f"[{label}] SpMV end to end: {ms * 1e3:.2f} us ({gnnz:.2f} Gnnz/s) "
        f"called from Python, host enqueue {host_ms * 1e3:.2f} us; "
        f"{graph_ms * 1e3:.2f} us "
        f"({nnz / (graph_ms * 1e-3) / 1e9:.2f} Gnnz/s) replayed from a "
        "CUDA graph; the checked kernels alone "
        + (f"{dev_ms * 1e3:.2f} us" if timed else "not timed")
        + f"; the eager body called from Python {eager_ms * 1e3:.2f} us")
    graphs = mat.csx._executor().graph_bytes()
    say(f"[{label}] the executor's graphs hold "
        + ", ".join(f"{k}: {b / 2**20:.2f} MiB" for k, b in graphs.items()))
    return {"us_per_spmv": ms * 1e3, "gnnz_per_s": gnnz,
            "host_enqueue_us": host_ms * 1e3,
            "graph_us_per_spmv": graph_ms * 1e3,
            "eager_us_per_spmv": eager_ms * 1e3,
            "graph_mib": {" ".join(map(str, k)): b / 2**20
                          for k, b in graphs.items()},
            "kernel_us": dev_ms and dev_ms * 1e3, "oracle_rel_err": errs,
            "launches_first_spmv": counts, "profile_device_us": prof,
            "profile_glue_us": glue}


def kernel_entries(res, counts, prof, label, extra=None):
    """The ``kernels`` JSON entries of one timed path, for each kernel that
    the path launched (the unit-page gather checked off the path, on the
    paged tables' windows, is left out): ``ms_in_spmv`` is the profile's
    device time per SpMV (per SpMM on an SpMM path); ``extra`` adds keys
    per kernel name."""
    return [{"name": f"{name}[{label}]", "route": "cuda",
             "source": SOURCE.get(name, FUSED_SOURCE),
             "replaces": REPLACES[name], "launches": counts[name],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "ms_in_spmv": None if prof is None else prof[name] * 1e-3,
             **(extra or {}).get(name, {})}
            for name, r in res.items() if counts[name]]


# ---------------------------------------------------------------------------
# the SpMM end to end
# ---------------------------------------------------------------------------

def spmm_phase(spx, tf, mat, rows, cols, vals, k, label, tol, timed, spmv):
    """One SpMM of X (ncols, k) from a numpy seed through ``matmat_kernel``.

    On a fused plan (``fused_mm_ok``) first each k-batched kernel against
    its plain version, fed one chunk of X as the SpMM feeds it
    (``kernel_phase`` on the k-major X.T[:8]).  Then two SpMMs
    (alpha=1/beta=0, alpha=2/beta=0.5 with a Y) against the float64 COO
    oracle; the first one's launch counts (warm-up and capture of the
    executor's ("mm", k) graph) twice ``expected_counts(meta, k)``:
    ceil(k/8) x the plan's per-SpMV counts under the ``_kb`` keys and
    nothing else on a fused plan, k SpMVs otherwise; the graph checked by
    :func:`check_graph`.  When ``timed``: the
    SpMM called from Python and replayed from a CUDA graph, Gnnz*k/s,
    SpMV-equivalents (graph time / (k x the path's SpMV graph time,
    ``spmv[1]``)), each kb kernel beside k x its kb = 0 time per SpMV
    (``spmv[0]``), and a profile of 20 SpMMs.  Returns (summary, kernel
    entries), both empty when not timed."""
    import torch
    from sparsex_tpu_torch.ops.kernels import fused_mm_ok
    ex = mat.csx._executor()
    fused = [e for e in mat.csx.executors if fused_mm_ok(e.meta)]
    kb = len(fused) == len(mat.csx.executors)
    n = mat.nrows
    lab = f"{label} spmm k={k}"
    X = torch.as_tensor(np.random.default_rng(3).standard_normal((n, k)),
                        dtype=ex.dtype, device=mat.device)
    Y0 = torch.as_tensor(np.random.default_rng(4).standard_normal((n, k)),
                         dtype=ex.dtype, device=mat.device)
    res = {}
    if fused:
        res = shards_kernel_phase(fused, X.T[:tf.MAX_KB].contiguous(), lab,
                                  timed, MM_LOOPS, MM_OUTER)
    xh = X.double().cpu().numpy()
    v64 = vals.astype(np.float64)
    want = np.stack([np.bincount(rows, weights=v64 * xh[cols, j],
                                 minlength=n) for j in range(k)], axis=1)
    want2 = 2.0 * want + 0.5 * Y0.double().cpu().numpy()
    tf.launches.clear()
    Y = spx.matmat_kernel(1.0, mat, X, 0.0, None)
    torch.cuda.synchronize()
    counts = tf.launch_counts()
    one = matrix_counts(mat.csx, k)
    expect = {key: 2 * v for key, v in one.items()}
    if counts != expect:
        fail(f"[{lab}] launch counts {counts} of the first SpMM (its warm-up "
             f"and its graph's capture), expected {expect}")
    Y2 = spx.matmat_kernel(2.0, mat, X, 0.5, Y0)

    def spmm():
        return spx.matmat_kernel(1.0, mat, X, 0.0, None)

    def eager():
        return ex.matmat(X)

    check_graph(ex, ("mm", k), spmm, eager, one, lab, kb=kb)
    errs = []
    for got, ref in ((Y, want), (Y2, want2)):
        g = got.double().cpu().numpy()
        if g.shape != (n, k) or not np.isfinite(g).all():
            fail(f"[{lab}] SpMM result has shape {g.shape} or non-finite "
                 "values")
        errs.append(_mixed_rel_err(g, ref))
    say(f"spmm [{lab}]: oracle rel err {errs[0]:.3e} (alpha=1, beta=0), "
        f"{errs[1]:.3e} (alpha=2, beta=0.5); bar {tol:g}; launches of the "
        "first SpMM (warm-up and capture) "
        f"{ {key: v for key, v in counts.items() if v} }")
    if not max(errs) < tol:
        fail(f"[{lab}] SpMM diverges from the oracle: {errs} vs {tol:g}")
    del Y, Y2, want, want2
    if not timed:
        return {}, []
    ms = cuda_time_ms(spmm, 2 * MM_LOOPS)
    graph_ms = graph_time_ms(spmm, 2 * MM_LOOPS)
    prof, glue = profile_phase(spmm, reps=20, kb=kb)
    spmv_res, spmv_graph_ms = spmv
    col_loop = {name: {"k_x_spmv_kernel_ms":
                       k * spmv_res[name[:-3]]["ms"]}
                for name in res if spmv_res.get(name[:-3], {}).get("ms")}
    for name, r in res.items():
        if name in col_loop:
            say(f"kernel {name} [{lab}]: {r['ms'] * 1e3:.2f} us alone per "
                f"SpMM vs {k} x its kb = 0 kernel "
                f"{col_loop[name]['k_x_spmv_kernel_ms'] * 1e3:.2f} us; "
                f"bound {r['bound_ms'] * 1e3:.2f} us; in the SpMM "
                + ("not measured" if prof is None
                   else f"{prof[name]:.2f} us"))
    if prof is not None:
        dev_us = sum(prof.values())
        say(f"[{lab}] profile (20 SpMMs): device {dev_us:.2f} us per SpMM = "
            + ", ".join(f"{key} {v:.2f}" for key, v in prof.items() if v)
            + f"; busy {100 * dev_us / (ms * 1e3):.1f}% of the "
            f"{ms * 1e3:.2f} us called from Python; largest glue "
            + "; ".join(f"{v:.2f} {key}" for key, v in glue))
    nnzk = rows.size * k
    equiv = graph_ms / (k * spmv_graph_ms)
    say(f"[{lab}] SpMM end to end: {ms * 1e3:.2f} us "
        f"({nnzk / (ms * 1e-3) / 1e9:.2f} Gnnz*k/s) called from Python; "
        f"{graph_ms * 1e3:.2f} us ({nnzk / (graph_ms * 1e-3) / 1e9:.2f} "
        f"Gnnz*k/s) replayed from a CUDA graph = {equiv:.3f} "
        f"SpMV-equivalents (k x {spmv_graph_ms * 1e3:.2f} us)")
    summary = {"us_per_spmm": ms * 1e3,
               "gnnzk_per_s": nnzk / (ms * 1e-3) / 1e9,
               "graph_us_per_spmm": graph_ms * 1e3,
               "graph_gnnzk_per_s": nnzk / (graph_ms * 1e-3) / 1e9,
               "spmv_equivalents": equiv, "oracle_rel_err": errs,
               "launches_first_spmm": counts, "profile_device_us": prof,
               "profile_glue_us": glue}
    return summary, kernel_entries(res, counts, prof, lab, col_loop)


def bf16_phase(spx, tf, label, n, rows, cols, vals):
    """A bf16 matrix, computed in float32: tuned with
    ``spx.tpu.value_dtype=bfloat16``, one SpMV of a bf16 x and one k = 8
    SpMM of a bf16 X through the executor's graphs, each a bf16 result
    within ``BF16_TOL`` of the largest value of the float64 COO oracle on
    the bf16-rounded values and x (the reference's bar,
    tests/test_route.py:246), the SpMV's first call with the launches of
    an f32 SpMV on the same plan; then the SpMV called from Python and
    replayed from a graph of the caller's.  Returns {label: summary}."""
    import torch
    mat = tune(spx, rows, cols, vals, n, "bfloat16", label)
    ex = mat.csx.executors[0]
    if ex.dtype != torch.float32:
        fail(f"[{label}] a bf16 matrix computes in {ex.dtype}")
    vb = torch.from_numpy(vals).bfloat16().double().numpy()
    X = torch.as_tensor(np.random.default_rng(1).standard_normal((n, 8)),
                        dtype=torch.bfloat16, device=mat.device)
    x = X[:, 0].contiguous()
    Xh = X.double().cpu().numpy()
    tf.launches.clear()
    y = spx.matvec_kernel(1.0, mat, x, 0.0, None)
    torch.cuda.synchronize()
    expect = {k: 2 * v for k, v in expected_counts(ex.meta).items()}
    if tf.launch_counts() != expect:
        fail(f"[{label}] launch counts {tf.launch_counts()} of the first "
             f"SpMV, expected {expect}")
    Y = spx.matmat_kernel(1.0, mat, X, 0.0, None)
    errs = []
    for got, xs in ((y[:, None], Xh[:, :1]), (Y, Xh)):
        if got.dtype != torch.bfloat16 or got.shape != (n, xs.shape[1]):
            fail(f"[{label}] result of dtype {got.dtype}, shape "
                 f"{tuple(got.shape)}")
        want = np.stack([np.bincount(rows, weights=vb * xs[cols, j],
                                     minlength=n)
                         for j in range(xs.shape[1])], axis=1)
        g = got.double().cpu().numpy()
        if not np.isfinite(g).all():
            fail(f"[{label}] non-finite values")
        errs.append(float(np.abs(g - want).max() / np.abs(want).max()))
    if not max(errs) < BF16_TOL:
        fail(f"[{label}] diverges from the oracle: {errs} vs {BF16_TOL:g}")

    def spmv():
        return spx.matvec_kernel(1.0, mat, x, 0.0, None)

    ms, graph_ms = cuda_time_ms(spmv), graph_time_ms(spmv)
    say(f"[{label}] bf16 computed in f32: oracle max err / max "
        f"{errs[0]:.3e} (SpMV), {errs[1]:.3e} (SpMM k=8); bar {BF16_TOL:g};"
        f" SpMV {ms * 1e3:.2f} us called from Python, "
        f"{graph_ms * 1e3:.2f} us replayed from a CUDA graph")
    out = {label: {"us_per_spmv": ms * 1e3,
                   "graph_us_per_spmv": graph_ms * 1e3,
                   "oracle_max_err": errs}}
    del mat, ex, X, Y, y
    torch.cuda.empty_cache()
    return out


def x_for(mat, n, dtype_name):
    import torch
    return torch.as_tensor(
        np.random.default_rng(1).standard_normal(n),
        dtype=torch.float32 if dtype_name == "float32" else torch.float64,
        device=mat.device)


def sym_mode(spx, mat, mode, label):
    """Select a symmetric matrix's mode (``SYM_MODES``: ``spx.tpu.sym_full``
    on or off) and build its executor, dropping the other mode's (and its
    graphs)."""
    import torch
    csx = mat.csx
    spx.Config.instance().set("spx.tpu.sym_full", SYM_MODES[mode])
    if mode == "full":
        csx._shard_execs = csx._multi = None
    else:
        csx._full_exec = None
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    csx._executor()
    torch.cuda.synchronize()
    say(f"[{label}] the {mode} executor: planned and uploaded in "
        f"{time.perf_counter() - t0:.2f} s")


def shards_phase(mat, x, label):
    """A matrix of several shards: its one graph's node types (the x copy
    runs before the replay, outside the graph, once a call), each shard's
    SpMV alone (``measure_load_imbalance``: CUDA events around replays of
    that shard's own graph, median of 5 x 32) and the load imbalance."""
    from sparsex_tpu_torch.device import graph_node_types
    csx = mat.csx
    types = graph_node_types(csx._executor()._graphs[("mv",)].graph)
    secs, imb = csx.measure_load_imbalance(x)
    say(f"[{label}] {len(secs)} shards: the matrix graph holds "
        f"{types.get('kernel', 0)} kernel, {types.get('memcpy', 0)} memcpy "
        f"and {types.get('memset', 0)} memset nodes; each shard's SpMV alone "
        + ", ".join(f"{s * 1e6:.2f}" for s in secs)
        + f" us (sum {sum(secs) * 1e6:.2f}); load imbalance (max-min)/min "
        f"{imb:.3f}")
    return {"shard_us_per_spmv": [s * 1e6 for s in secs],
            "load_imbalance": imb, "graph_node_types": types,
            "shard_rows": [e - s for s, e in zip(csx.partition.row_start,
                                                 csx.partition.row_end)],
            "shard_nnz": list(csx.partition.nnz_per_part)}


def entries_phase(spx, tf, rows, cols, vals, tol):
    """``after`` for ``run_path``: on a matrix of several shards,
    ``set_entry`` on a delta entry and a DIA entry of shard 1, then an SpMV
    through the graph (its first call plans and uploads shard 1 again and
    captures a new graph; shard 0 is not planned again) against the oracle
    with the new values, which the old oracle must miss; then
    ``mat_save`` / ``mat_restore`` on the card: every restored device
    array bit-equal to the original's, the restored SpMV bit-equal to the
    original's (both eager bodies under torch's deterministic algorithms,
    since the residual adds' ``index_add_`` reorders sums) and within the
    replay bound through the graphs, and the restore seconds beside the
    tune seconds; last the old values set back (the SpMM phases after it
    check against the original oracle)."""
    def after(mat, x, lab):
        import tempfile
        import torch
        csx = mat.csx
        r0, r1 = csx.partition.bounds(1)
        idx = np.nonzero((rows >= r0) & (rows < r1))[0]
        picks = {}
        for i in idx[::max(1, idx.size // 20000)]:
            loc = csx._locate(int(rows[i]), int(cols[i]))
            if loc is not None and loc[0] in ("delta", "dia"):
                picks.setdefault(loc[0], int(i))
            if len(picks) == 2:
                break
        if set(picks) != {"delta", "dia"}:
            fail(f"[{lab}] no delta and DIA entries found in shard 1: "
                 f"{picks}")
        new = vals.astype(np.float64)
        for kind, i in sorted(picks.items()):
            v = -3.0 * float(vals[i]) + 0.25
            spx.mat_set_entry(mat, int(rows[i]), int(cols[i]), v)
            new[i] = float(np.asarray(v, dtype=vals.dtype))
            got = spx.mat_get_entry(mat, int(rows[i]), int(cols[i]))
            if got != new[i]:
                fail(f"[{lab}] get_entry of the {kind} entry gave {got}, "
                     f"set {new[i]}")
        tf.launches.clear()
        y = spx.matvec_kernel(1.0, mat, x, 0.0, None)
        torch.cuda.synchronize()
        expect = {k: 2 * v for k, v in matrix_counts(csx).items()}
        if tf.launch_counts() != expect or csx.replans != 1:
            fail(f"[{lab}] after set_entry: launches {tf.launch_counts()}, "
                 f"expected {expect}; {csx.replans} shards planned again, "
                 "expected 1")
        y = spx.matvec_kernel(1.0, mat, x, 0.0, None).double().cpu().numpy()
        xh = x.double().cpu().numpy()
        err = _mixed_rel_err(y, np.bincount(rows, weights=new * xh[cols],
                                            minlength=mat.nrows))
        old = _mixed_rel_err(y, np.bincount(
            rows, weights=vals.astype(np.float64) * xh[cols],
            minlength=mat.nrows))
        say(f"[{lab}] set_entry on shard 1's delta entry {picks['delta']} "
            f"and DIA entry {picks['dia']}: the next SpMV (a new graph, "
            f"shard 1 planned again) within {err:.3e} of the oracle with "
            f"the new values (bar {tol:g}), {old:.3e} of the old one")
        if not (err < tol and old > tol):
            fail(f"[{lab}] the SpMV after set_entry: {err:.3e} from the new "
                 f"oracle, {old:.3e} from the old one")
        fd, path = tempfile.mkstemp(suffix=".npz")
        os.close(fd)
        try:
            t0 = time.perf_counter()
            spx.mat_save(mat, path)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = spx.mat_restore(path)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            nbytes = os.path.getsize(path)
        finally:
            os.remove(path)
        for i, (a, b) in enumerate(zip(csx.executors,
                                       back.csx.executors)):
            if a.meta != b.meta or not _same_tree(a.arrays, b.arrays):
                fail(f"[{lab}] restored shard {i}'s plan differs from the "
                     "original's")
        ya = spx.matvec_kernel(1.0, mat, x, 0.0, None)
        yb = spx.matvec_kernel(1.0, back, x, 0.0, None)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            ea, eb = (m.csx._executor()._matvec(x) for m in (mat, back))
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        graph_rel = float((ya - yb).abs().max() / ya.abs().max())
        if not torch.equal(ea, eb) or not graph_rel <= 1e-6:
            fail(f"[{lab}] the restored SpMV differs: eager bodies "
                 f"{'equal' if torch.equal(ea, eb) else 'differ'}, graphs "
                 f"{graph_rel:.3e}")
        say(f"[{lab}] mat_save {save_s:.2f} s ({nbytes / 2**20:.1f} MiB), "
            f"mat_restore {restore_s:.2f} s on the card beside mat_tune "
            f"{mat.tune_s:.2f} s; every device array of the restored plans "
            "bit-equal; the restored SpMV bit-equal to the original's "
            "(eager bodies, deterministic algorithms), through the graphs "
            + ("bit-equal" if torch.equal(ya, yb)
               else f"within {graph_rel:.3e} (atomic adds reorder sums)"))
        spx.mat_destroy(back)
        # the old values back, for the phases after this one
        for i in picks.values():
            spx.mat_set_entry(mat, int(rows[i]), int(cols[i]), vals[i])
        y = spx.matvec_kernel(1.0, mat, x, 0.0, None).double().cpu().numpy()
        back_err = _mixed_rel_err(y, np.bincount(
            rows, weights=vals.astype(np.float64) * xh[cols],
            minlength=mat.nrows))
        if not back_err < tol or csx.replans != 2:
            fail(f"[{lab}] with the old values set back: {back_err:.3e} "
                 f"from the oracle, {csx.replans} re-plans (expected 2)")
        return {f"{lab} entries": {
            "set_entry_oracle_rel_err": err, "old_oracle_rel_err": old,
            "save_s": save_s, "restore_s": restore_s, "tune_s": mat.tune_s,
            "archive_mib": nbytes / 2**20, "graph_rel_diff": graph_rel}}
    return after


def _same_tree(a, b):
    """Whether two plans' device array trees are equal, tensor for tensor
    (dtype and bits)."""
    import torch
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same_tree(u, v) for u, v in zip(a, b)))
    return a == b


def shard_cost(many, one, nshards, label):
    """The cost of sharding on one card: a matrix of ``nshards`` shards
    (summary ``many``) against the same matrix in one shard (``one``, the
    earlier path of the same run): the graph's device µs, the kernel
    launches of one SpMV and the torch glue's device µs."""
    def launches(s):
        return sum(s["launches_first_spmv"].values()) // 2

    def glue(s):
        p = s["profile_device_us"]
        return None if p is None else p["glue"]

    out = {"graph_us": [many["graph_us_per_spmv"], one["graph_us_per_spmv"]],
           "us_from_python": [many["us_per_spmv"], one["us_per_spmv"]],
           "launches": [launches(many), launches(one)],
           "glue_us": [glue(many), glue(one)]}
    g = out["glue_us"]
    say(f"[{label}] {nshards} shards against one: graph "
        f"{many['graph_us_per_spmv']:.2f} against "
        f"{one['graph_us_per_spmv']:.2f} us "
        f"({100 * (many['graph_us_per_spmv'] / one['graph_us_per_spmv'] - 1):+.1f} %), "
        f"from Python {many['us_per_spmv']:.2f} against "
        f"{one['us_per_spmv']:.2f} us, launches {out['launches'][0]} "
        f"against {out['launches'][1]}, glue "
        + ("not measured" if None in g else f"{g[0]:.2f} against {g[1]:.2f}")
        + " us")
    return out


def run_path(spx, tf, label, n, rows, cols, vals, dtype_name, tol, check,
             options=(), timed=True, spmm=(), modes=(), kernels_timed=None,
             after=None, solve=None):
    """One path in one value type: tune (under the extra ``options``),
    check the plan, each kernel against its plain version
    (``kernel_phase``, on each shard of a matrix of several), the SpMV
    against the oracle with its launch counts, and when ``timed`` the
    times and a profile (the kernels alone only if ``kernels_timed``, by
    default ``timed``); on a matrix of several shards the load imbalance
    (``shards_phase``); then ``after(mat, x, lab)`` where given, on the
    same tuned matrix one ``spmm_phase`` per (k, timed) in ``spmm``, and
    last ``solve(mat, x, lab)`` where given (the solvers, whose solves
    replay the executor's graphs that the phases before captured).  A
    symmetric matrix runs all that once per mode in ``modes``
    (:func:`sym_mode`), on the one tuned matrix, labelled ``label`` and the
    mode.  Returns ({label: summary}, kernel entries) of the timed
    parts."""
    import torch
    t0 = time.perf_counter()
    ktimed = timed if kernels_timed is None else kernels_timed
    mat = tune(spx, rows, cols, vals, n, dtype_name, label, options)
    summary, entries = {}, []
    for mode in modes or (None,):
        lab = label if mode is None else f"{label} {mode}"
        if mode is not None:
            sym_mode(spx, mat, mode, lab)
        ex = check(mat, lab)
        x = x_for(mat, n, dtype_name)
        res = shards_kernel_phase(ex if isinstance(ex, list) else [ex], x,
                                  lab, timed and ktimed)
        timing = e2e_phase(spx, tf, mat, rows, cols, vals, x, tol, lab,
                           timed)
        if timed:
            profiled = profile_phase(timing[-1])
            summary[lab] = report(lab, mat, res, timing, profiled, rows.size)
            if ktimed:
                entries += kernel_entries(res, timing[0], profiled[0], lab)
            if len(mat.csx.executors) > 1:
                summary[lab].update(shards_phase(mat, x, lab))
        if after is not None:
            summary.update(after(mat, x, lab) or {})
        for k, mm_timed in spmm:
            s, e = spmm_phase(spx, tf, mat, rows, cols, vals, k, lab, tol,
                              mm_timed, (res, timing[3]))
            if mm_timed:
                summary[f"{lab} spmm k={k}"] = s
                entries += e
        if solve is not None:
            summary.update(solve(mat, x, lab) or {})
        del ex, x, timing
    out = (summary, entries)
    del mat
    torch.cuda.empty_cache()
    say(f"[{label}] path done in {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the solvers, SpGEMM and the examples
# ---------------------------------------------------------------------------

# the CG phases: a symmetric HPCG solve runs HPCG's own 50 iterations when
# timed; bars of the true residual ||b - A x|| / ||b|| (float64 COO oracle)
CG_ITERS = 50
CG_BAR = {"float64": 1e-7, "float32": 1e-4}
# graph against eager solve, and block CG against cg per column: max |a -
# b| / max |b|
SOLVE_BAR = {"float64": 1e-10, "float32": 1e-6}
COLUMN_BAR = {"float64": 1e-8, "float32": 1e-4}
SOLVER_K = 8


def _oracle_spmv(n, rows, cols, vals, x):
    """A @ x in float64 (x a tensor or an array, of one or more columns)."""
    xh = x.double().cpu().numpy() if hasattr(x, "cpu") else np.asarray(
        x, np.float64)
    v64 = vals.astype(np.float64)
    if xh.ndim == 1:
        return np.bincount(rows, weights=v64 * xh[cols], minlength=n)
    return np.stack([np.bincount(rows, weights=v64 * xh[cols, j],
                                 minlength=n) for j in range(xh.shape[1])],
                    axis=1)


def _rel(a, b):
    """max |a - b| / max |b| of two tensors."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def block_launches(st, counted, one, label, kb=False):
    """Launches per iteration of a solve's captured block (``st``, the
    solver's stats): its graph's kernel nodes (``graph_kernels``) over
    ``solvers.BLOCK``, which must be ``one`` (one SpMV's or SpMM's counts
    from the plan) by name and number, as must the launch counters over
    the solve (``counted``: the executors' graphs exist already, so the
    counters see only the block's capture)."""
    from sparsex_tpu_torch import solvers
    if st["graph"] is None:
        fail(f"[{label}] the solve captured no graph")
    got = graph_kernels(st["graph"], kb)
    want = {k: solvers.BLOCK * v for k, v in one.items() if v}
    counted = {k: v for k, v in counted.items() if v}
    if got != want or counted != want:
        fail(f"[{label}] the block's graph launches {got}, the counters "
             f"saw {counted}, expected {solvers.BLOCK} x {one}")
    return {k: v // solvers.BLOCK for k, v in got.items()}


def counted_solve(solve, **kw):
    """``(solve(**kw), the launch counters over it)``."""
    from sparsex_tpu_torch.ops import fused as tf
    tf.launches.clear()
    out = solve(**kw)
    return out, tf.launch_counts()


def us_per_iteration(st):
    """Device µs per iteration: replays of a solve's kept block (its state,
    ``st["state"]``, past its stop point: every iteration still runs its
    SpMV and vector updates, masked) timed with CUDA events, over
    ``solvers.BLOCK``."""
    from sparsex_tpu_torch import solvers
    return cuda_time_ms(st["graph"].replay, loops=8) * 1e3 / solvers.BLOCK


def graph_vs_eager(solve, label, dtype_name):
    """A solve from its captured block against the same solve run eagerly
    (``graph=False``: one iteration a Python step, the same kernels):
    the same count, x within ``SOLVE_BAR``.  Returns the graph solve's
    (x, it, res, stats, launch counters)."""
    import torch
    st, ste = {}, {}
    (x, it, res), counted = counted_solve(solve, graph=True, stats=st)
    xe, ite, _ = solve(graph=False, stats=ste)
    rel = _rel(x, xe)
    say(f"[{label}] graph solve: {it} iterations in {st['blocks']} blocks, "
        f"{st['seconds'] * 1e3:.2f} ms ({st['capture_s'] * 1e3:.2f} ms of "
        f"it the block's capture); eager solve {ite} iterations, "
        f"{ste['seconds'] * 1e3:.2f} ms; x "
        + ("bit-equal" if torch.equal(x, xe) else f"within {rel:.3e}"))
    if it != ite or not rel <= SOLVE_BAR[dtype_name]:
        fail(f"[{label}] graph and eager solves differ: {it} against {ite} "
             f"iterations, x within {rel:.3e}")
    return x, it, res, st, counted


def cg_timing(spx, mat, b, label, x):
    """HPCG's 50 iterations at tol = 0 from a captured block: µs per
    iteration (block replays / BLOCK) beside the SpMV graph time (the SpMV
    captured in a graph of this script's), and the solve's wall time with
    and without its capture; launches per iteration from the block's
    graph."""
    from sparsex_tpu_torch import solvers
    st = {}
    _out, counted = counted_solve(solvers.cg, matvec=mat.csx.matvec, b=b,
                                  tol=0.0, maxiter=CG_ITERS, stats=st)
    if st["iterations"] != CG_ITERS:
        fail(f"[{label}] tol = 0 stopped at {st['iterations']} iterations")
    launches = block_launches(st, counted, matrix_counts(mat.csx), label)
    it_us = us_per_iteration(st)
    spmv_us = graph_time_ms(
        lambda: spx.matvec_kernel(1.0, mat, x, 0.0, None)) * 1e3
    say(f"[{label}] CG {CG_ITERS} iterations at tol=0: {it_us:.2f} us per "
        f"iteration from its block's graph = {it_us / spmv_us:.3f} x the "
        f"SpMV graph {spmv_us:.2f} us; the solve {st['seconds'] * 1e3:.2f} "
        f"ms wall, {(st['seconds'] - st['capture_s']) * 1e3:.2f} ms "
        f"without the block's capture; the block's graph "
        f"{st['graph_bytes'] / 2**20:.2f} MiB; launches per iteration "
        f"{launches}")
    return {"us_per_iteration": it_us, "spmv_graph_us": spmv_us,
            "iterations_per_spmv": it_us / spmv_us,
            "solve_ms": st["seconds"] * 1e3,
            "solve_ms_without_capture":
                (st["seconds"] - st["capture_s"]) * 1e3,
            "graph_mib": st["graph_bytes"] / 2**20,
            "launches_per_iteration": launches}


def hpcg_cg_phase(spx, rows, cols, vals, dtype_name):
    """``solve`` for ``run_path`` on symmetric HPCG 128^3 (the full mirror
    only): b = A 1 (HPCG's right-hand side); in float64 CG to tol 1e-8,
    its true residual against ``CG_BAR``, graph against eager solve; in
    float32 graph against eager at HPCG's 50 iterations; in both the
    timing of ``cg_timing``.  The CG's kernel entries are the path's,
    with launches per iteration."""
    def solve(mat, x, lab):
        import torch
        if not lab.endswith(" full"):
            return {}
        from sparsex_tpu_torch import solvers
        n = mat.nrows
        label = f"cg {lab}"
        b = torch.as_tensor(_oracle_spmv(n, rows, cols, vals, np.ones(n)),
                            dtype=x.dtype, device=x.device)
        f64 = dtype_name == "float64"
        tol, maxiter = (1e-8, 2000) if f64 else (0.0, CG_ITERS)
        out, it, res, st, _counted = graph_vs_eager(
            lambda **kw: solvers.cg(mat.csx.matvec, b, tol=tol,
                                    maxiter=maxiter, **kw), label,
            dtype_name)
        rel = float(np.linalg.norm(
            b.double().cpu().numpy() - _oracle_spmv(n, rows, cols, vals, out))
            / np.linalg.norm(b.double().cpu().numpy()))
        err1 = float((out.double() - 1).abs().max())
        say(f"[{label}] tol {tol:g}: {it} iterations, residual "
            f"{float(res):.3e}; true residual ||b - Ax|| / ||b|| {rel:.3e} "
            f"(float64 COO oracle); max |x - 1| {err1:.3e}")
        if f64 and not (rel <= CG_BAR[dtype_name] and it < maxiter):
            fail(f"[{label}] true residual {rel:.3e} after {it} iterations, "
                 f"bar {CG_BAR[dtype_name]:g}")
        del out, st
        summary = cg_timing(spx, mat, b, label, x)
        summary.update(iterations=it, true_residual=rel, tol=tol,
                       kernels_of=lab)
        torch.cuda.empty_cache()
        return {label: summary}
    return solve


def spd_solver_phase(spx, rows, cols, vals, dtype_name, timed):
    """``solve`` for ``run_path`` on the CSX-Sym matrix made s.p.d.
    (``spd_symmetric_matrix``): CG (tol 1e-8 in float64, 1e-5 in float32)
    graph against eager solve and its true residual; block CG of
    ``SOLVER_K`` seeded columns through the kb kernels, each column
    against that column's cg; when ``timed``, µs per CG and per block-CG
    iteration beside the SpMV and SpMM graph times."""
    def solve(mat, x, lab):
        import torch
        from sparsex_tpu_torch import solvers
        n = mat.nrows
        f64 = dtype_name == "float64"
        tol = 1e-8 if f64 else 1e-5
        b = torch.as_tensor(np.random.default_rng(21).standard_normal(n),
                            dtype=x.dtype, device=x.device)
        label = f"cg {lab}"
        out, it, res, st, counted = graph_vs_eager(
            lambda **kw: solvers.cg(mat.csx.matvec, b, tol=tol, **kw),
            label, dtype_name)
        rel = float(np.linalg.norm(
            b.double().cpu().numpy() - _oracle_spmv(n, rows, cols, vals, out))
            / np.linalg.norm(b.double().cpu().numpy()))
        say(f"[{label}] tol {tol:g}: {it} iterations, residual "
            f"{float(res):.3e}; true residual {rel:.3e}")
        if not (rel <= CG_BAR[dtype_name] and it < 1000):
            fail(f"[{label}] true residual {rel:.3e} after {it} "
                 f"iterations, bar {CG_BAR[dtype_name]:g}")
        cg_launches = block_launches(st, counted, matrix_counts(mat.csx),
                                     label)
        out_summary = {label: {"iterations": it, "true_residual": rel,
                               "tol": tol, "kernels_of": lab,
                               "launches_per_iteration": cg_launches}}
        del out, st

        blabel = f"block-cg k={SOLVER_K} {lab}"
        B = torch.as_tensor(
            np.random.default_rng(22).standard_normal((n, SOLVER_K)),
            dtype=x.dtype, device=x.device)
        bst = {}
        (X, bit, bres), counted = counted_solve(
            solvers.block_cg, matmat=mat.csx.matmat, B=B, tol=tol,
            stats=bst)
        launches = block_launches(bst, counted,
                                  matrix_counts(mat.csx, SOLVER_K), blabel,
                                  kb=True)
        worst, counts = 0.0, []
        for j in range(SOLVER_K):
            xj, itj, _ = solvers.cg(mat.csx.matvec, B[:, j].contiguous(),
                                    tol=tol)
            worst = max(worst, _rel(X[:, j], xj))
            counts.append(itj)
        R = B.double().cpu().numpy() - _oracle_spmv(n, rows, cols, vals, X)
        brel = float(np.abs(R).max() / B.abs().max())
        say(f"[{blabel}] {bit} iterations ({bst['blocks']} blocks, "
            f"{bst['seconds'] * 1e3:.2f} ms; per column cg {counts}); "
            f"max residual {float(bres.max()):.3e}; max |B - AX| / max |B| "
            f"{brel:.3e}; columns against cg within {worst:.3e}; the "
            f"block's graph {bst['graph_bytes'] / 2**20:.2f} MiB; launches "
            f"per iteration {launches}")
        if not (worst <= COLUMN_BAR[dtype_name]
                and brel <= CG_BAR[dtype_name]):
            fail(f"[{blabel}] block CG against cg per column: {worst:.3e} "
                 f"(bar {COLUMN_BAR[dtype_name]:g}), {bit} iterations "
                 f"against {counts}, residual {brel:.3e}")
        out_summary[blabel] = {"iterations": bit, "column_counts": counts,
                               "columns_within": worst, "residual": brel,
                               "kernels_of": f"{lab} spmm k={SOLVER_K}",
                               "launches_per_iteration": launches}
        if timed:
            cg_us = us_per_iteration(solvers_stats(
                mat.csx.matvec, b, solvers.cg))
            bcg_us = us_per_iteration(solvers_stats(
                mat.csx.matmat, B, solvers.block_cg))
            spmv_us = graph_time_ms(
                lambda: spx.matvec_kernel(1.0, mat, x, 0.0, None)) * 1e3
            spmm_us = graph_time_ms(
                lambda: spx.matmat_kernel(1.0, mat, B, 0.0, None),
                2 * MM_LOOPS) * 1e3
            say(f"[{lab}] CG {cg_us:.2f} us per iteration = "
                f"{cg_us / spmv_us:.3f} x the SpMV graph {spmv_us:.2f} us; "
                f"block CG k={SOLVER_K} {bcg_us:.2f} us per iteration = "
                f"{bcg_us / spmm_us:.3f} x the SpMM graph {spmm_us:.2f} us "
                f"({bcg_us / (SOLVER_K * cg_us):.3f} x {SOLVER_K} CG "
                "iterations)")
            out_summary[label].update(us_per_iteration=cg_us,
                                      spmv_graph_us=spmv_us)
            out_summary[blabel].update(us_per_iteration=bcg_us,
                                       spmm_graph_us=spmm_us)
        del X, B, bst
        torch.cuda.empty_cache()
        return out_summary
    return solve


def solvers_stats(fn, b, solver):
    """The stats of a solve of ``CG_ITERS`` iterations at tol = 0 (its
    block kept, for :func:`us_per_iteration`)."""
    st = {}
    solver(fn, b, tol=0.0, maxiter=CG_ITERS, stats=st)
    return st


def solver_entries(kernels, summary):
    """The ``kernels`` JSON entries of the solver paths: the kernel entries
    of the path each solve ran on (``kernels_of``), named by the solve and
    with its launches per iteration, read from its block's graph."""
    out = []
    for label, s in summary.items():
        if "launches_per_iteration" not in s or "kernels_of" not in s:
            continue
        tag = f"[{s['kernels_of']}]"
        for e in kernels:
            if not e["name"].endswith(tag):
                continue
            key = e["name"][:-len(tag)]
            out.append(dict(e, name=f"{key}[{label}]",
                            launches=s["launches_per_iteration"].get(key, 0),
                            launches_per="iteration"))
    return out


def spgemm_phase(spx, summary):
    """SpGEMM on the card.  ``spgemm_matrix`` (bench.py's bench_spgemm:
    2^13 rows, 16 a row, seed 11, f32): C = A A on the host
    (``spgemm_coo``, its MFLOPS a host number) and through ``spx.spgemm``
    (C tuned onto the card), C's SpMV against A (A x) through the float64
    COO oracle.  Then ``spgemm_panel`` of the headline 2^20 f32 matrix and
    ``panel_operand`` (2^20 x 256) in panels of 64 columns, each panel's
    columns j0, j0 + 1, j0 + 31, j0 + 63 against the oracle; µs per panel
    (its SpMM from Python), the stream's wall time and the k = 64 graph's
    MiB."""
    import torch
    from sparsex_tpu_torch.ops import spgemm as tsp
    t0 = time.perf_counter()
    n, rows, cols, vals, flops = spgemm_matrix()
    t1 = time.perf_counter()
    tsp.spgemm_coo(rows, cols, vals, rows, cols, vals, n, n, n)
    host_s = time.perf_counter() - t1
    A = tune(spx, rows, cols, vals, n, "float32", "spgemm A")
    C = spx.spgemm(A, A)
    x = np.random.default_rng(23).standard_normal(n).astype(np.float32)
    y = spx.matvec_kernel(1.0, C, x, 0.0, None)
    want = _oracle_spmv(n, rows, cols, vals,
                        _oracle_spmv(n, rows, cols, vals, x))
    err = _mixed_rel_err(y.double().cpu().numpy(), want)
    say(f"[spgemm] {n}x{n} nnz={rows.size}: spgemm_coo {flops / 1e6:.1f} "
        f"MFLOP in {host_s:.3f} s = {flops / host_s / 1e6:.1f} MFLOPS "
        f"(host NumPy, not the card); C = A A: {C.nnz} nnz on {C.device}; "
        f"C x against A (A x): {err:.3e} (bar {CHECK_TOL:g})")
    if not err < CHECK_TOL:
        fail(f"[spgemm] C x differs from A (A x) by {err:.3e}")
    del A, C
    out = {"spgemm": {"host_mflops": flops / host_s / 1e6, "c_nnz_err": err}}

    hrows, hcols, hvals = build_matrix(N)
    A = tune(spx, hrows, hcols, hvals, N, "float32", "spgemm panel A")
    brows, bcols, bvals = panel_operand(N)
    cfg = spx.Config.instance()
    B = spx.mat_tune(spx.input_load_csr(
        np.concatenate([[0], np.cumsum(np.bincount(brows, minlength=N))]),
        bcols, bvals, N, PANEL_COLS))
    say(f"[spgemm panel] B: {N}x{PANEL_COLS}, nnz={B.nnz}, value type "
        f"{cfg.value_type}")
    order = np.lexsort((brows, bcols))
    br, bc, bv = brows[order], bcols[order], bvals[order].astype(np.float64)
    worst, widths, t1 = 0.0, [], time.perf_counter()
    for j0, panel in tsp.spgemm_panel(A.csx, B.csx, panel=PANEL):
        widths.append(panel.shape[1])
        for j in (j0, j0 + 1, j0 + 31, j0 + PANEL - 1):
            m = bc == j
            col = np.bincount(br[m], weights=bv[m], minlength=N)
            want = _oracle_spmv(N, hrows, hcols, hvals, col)
            worst = max(worst, _mixed_rel_err(
                panel[:, j - j0].double().cpu().numpy(), want))
    stream_s = time.perf_counter() - t1
    Bp = torch.zeros((N, PANEL), dtype=torch.float32, device=A.device)
    Bp[torch.as_tensor(br[bc < PANEL], device=A.device),
       torch.as_tensor(bc[bc < PANEL], device=A.device)] = torch.as_tensor(
        bv[bc < PANEL], dtype=torch.float32, device=A.device)
    panel_us = cuda_time_ms(lambda: A.csx.matmat(Bp), loops=8,
                            outer=3) * 1e3
    mib = A.csx._executor().graph_bytes()[("mm", PANEL)] / 2**20
    say(f"[spgemm panel] headline 2^20 f32 x B in {len(widths)} panels of "
        f"{PANEL}: columns against the oracle within {worst:.3e} (bar "
        f"{CHECK_TOL:g}); {panel_us:.2f} us per panel's SpMM called from "
        f"Python; the stream {stream_s:.3f} s (densify, SpMM and the "
        f"oracle checks); the ("
        f"'mm', {PANEL}) graph {mib:.2f} MiB")
    if not (worst < CHECK_TOL and widths == [PANEL] * (PANEL_COLS // PANEL)):
        fail(f"[spgemm panel] panels {widths} within {worst:.3e}")
    out["spgemm panel"] = {"us_per_panel": panel_us, "graph_mib": mib,
                           "oracle_rel_err": worst, "panels": len(widths)}
    del A, B, Bp
    torch.cuda.empty_cache()
    say(f"[spgemm] phase done in {time.perf_counter() - t0:.1f} s")
    summary.update(out)


def _script(folder, name):
    """The module ``<folder>/<name>.py`` (the examples and the tools are
    scripts, not packages)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, folder, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(spx, summary):
    """Each ``examples/*_torch.py``'s ``main`` in this process on the card
    at its default size (the caching pair through a temporary directory);
    each must return 0 after its own check."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp()
    names = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "examples"))
                   if f.endswith("_torch.py"))
    if len(names) != 9:
        fail(f"examples: found {names}")
    secs = {}
    try:
        for name in names:
            mod = _script("examples", name)
            argv = (["--cache", os.path.join(tmp, "cache.npz")]
                    if "caching" in name else [])
            spx.Config.reset()
            t0 = time.perf_counter()
            rc = mod.main(argv)
            secs[name] = time.perf_counter() - t0
            say(f"[examples] {name}: rc {rc}, {secs[name]:.2f} s")
            if rc != 0:
                fail(f"[examples] {name} failed its check")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        spx.Config.reset()
    summary["examples_s"] = secs


def _tool_main(spx, label, name, argv):
    """``tools/<name>.py``'s ``main(argv)`` in this process; its output
    is printed with ``label`` before each line.  Returns (its output, its
    seconds); fails the run unless it returns 0."""
    import contextlib
    import io
    buf = io.StringIO()
    spx.Config.reset()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = _script("tools", name).main(argv)
    finally:
        spx.Config.reset()
        secs = time.perf_counter() - t0
        for line in buf.getvalue().splitlines():
            say(f"[{label}] {line}")
    say(f"[{label}] rc {rc}, {secs:.2f} s")
    if rc != 0:
        fail(f"[{label}] exited {rc}")
    return buf.getvalue(), secs


def _tool_process(label, name, argv, timeout=600):
    """``python3 tools/<name>.py argv`` as a process of its own (the tools
    whose spawned ranks import them by path), its output printed with
    ``label`` before each line.  Returns (its output, its seconds); fails
    the run unless it exits 0."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", name + ".py")] + argv,
        capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    secs = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        say(f"[{label}] {line}")
    say(f"[{label}] rc {proc.returncode}, {secs:.2f} s")
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        fail(f"[{label}] exited {proc.returncode}")
    return proc.stdout, secs


def tools_phase(spx, summary):
    """Each ``tools/*_torch.py`` on the card, as a user runs it: the diagc
    matrix at 2^19 written once as an MMF (``io.mmf.save_mmf``), through
    ``test_sparsex_torch`` (``-t``, then ``-r``) and ``bench_spmv_torch``
    (``-l sparsex,csr,native,scipy --json``, float64: the four adapters'
    MFLOPS, cross-checked); ``profile_fused_torch`` on each of bench.py's
    four workloads at bench.py's sizes and on blocky's SpMM at k = 8 (the
    per-kernel budget beside the chain's CUDA-event time); then as
    processes of their own ``weak_scaling_torch --devices 1 2 --base-n
    262144`` in both x modes and ``soak_torch`` at its default sizes on 2
    ranks (gloo, both on the card: its sharded checks pass x round a ring
    and gather the rows as the rank paths do).  Every
    tool must exit 0; each one's seconds go into the summary."""
    import shutil
    import tempfile

    from sparsex_tpu_torch.io.mmf import save_mmf
    tmp = tempfile.mkdtemp(prefix="spx_tools_")
    secs, out = {}, {}
    try:
        t0 = time.perf_counter()
        path = os.path.join(tmp, "diagc_2^19.mtx")
        rows, cols, vals = build_diagc_matrix(N_DIAGC)
        save_mmf(path, N_DIAGC, N_DIAGC, rows, cols, vals)
        secs["save_mmf"] = time.perf_counter() - t0
        del rows, cols, vals
        say(f"[tools] diagc 2^19 written as an MMF in {secs['save_mmf']:.2f}"
            " s")
        xform = ["-o", "spx.preproc.xform=all"]
        for flag in ("-t", "-r"):
            label = f"test_sparsex {flag}"
            _, secs[label] = _tool_main(spx, label, "test_sparsex_torch",
                                        [path, flag] + xform)
        text, secs["bench_spmv"] = _tool_main(
            spx, "bench_spmv", "bench_spmv_torch",
            ["-f", path, "-l", "sparsex,csr,native,scipy", "--json"])
        out["bench_spmv"] = json.loads(text.splitlines()[-1])
        if ("FAILED" in text or "SKIPPED" in text
                or text.count("[OK]") != 3):
            fail("[bench_spmv] a cross-check failed or an adapter skipped")
        prof_json = os.path.join(tmp, "profile.json")
        for work, spmm in (("headline", 0), ("blocky", 0),
                           ("symmetric", 0), ("diagc", 0), ("blocky", 8)):
            label = f"profile_fused {work}" + (f" spmm {spmm}" if spmm
                                               else "")
            _, secs[label] = _tool_main(
                spx, label, "profile_fused_torch",
                ["--workload", work, "--spmm", str(spmm), "--json",
                 prof_json])
        with open(prof_json) as fp:
            out["profile_fused"] = {
                k: {kk: v[kk] for kk in ("nnz", "total_us_per_iter",
                                         "chain_us_per_iter")}
                for k, v in json.load(fp).items()}
        out["weak_scaling"] = {}
        for mode in ("replicated", "halo"):
            label = f"weak_scaling {mode}"
            wjson = os.path.join(tmp, f"weak_{mode}.json")
            _, secs[label] = _tool_process(
                label, "weak_scaling_torch",
                ["--devices", "1", "2", "--base-n", "262144", "--mode", mode,
                 "--json", wjson])
            with open(wjson) as fp:
                out["weak_scaling"][mode] = json.load(fp)
        _, secs["soak"] = _tool_process("soak", "soak_torch",
                                        ["--ranks", "2"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        spx.Config.reset()
    out["seconds"] = secs
    summary["tools"] = out


# ---------------------------------------------------------------------------
# the matrices (bench.py's builders and its oracle bar, copied so that this
# script imports nothing of the JAX benchmark)
# ---------------------------------------------------------------------------

# f32 accumulation-order tolerance of the oracle check (bench.py:49)
CHECK_TOL = 2e-4
# a bf16 result against the oracle (max |y - ref| / max |ref|), the
# reference's bar for bf16 matrices (tests/test_route.py:246)
BF16_TOL = 2e-2
# the paths that also run a bf16 matrix (bf16_phase)
BF16_PATHS = ("", "blocky ")


def _mixed_rel_err(a, b) -> float:
    """bench.py's mixed relative error (bench.py:72), the port's
    ``ops.oracle.mixed_rel_err``."""
    from sparsex_tpu_torch.ops.oracle import mixed_rel_err
    return mixed_rel_err(a, b)


def _dedup_sort(rows, cols, n, seed=1):
    """Unique (row, col) pairs sorted row-major, with f32 values 0.1 * N(0,
    1) from ``seed`` (bench.py:242)."""
    key = rows * n + cols
    _, uniq = np.unique(key, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = np.random.default_rng(seed).standard_normal(
        rows.size).astype(np.float32) * 0.1
    return rows, cols, vals


def build_matrix(n):
    """Headline: 5 dense diagonals + n/2 random singles (bench.py:141)."""
    rng = np.random.default_rng(0)
    rows, cols = [], []
    for b in (0, 1, -1, 8, -13):
        r = np.arange(max(0, -b), min(n, n - b), dtype=np.int64)
        rows.append(r)
        cols.append(r + b)
    m = n // 2
    rows.append(rng.integers(0, n, size=m))
    cols.append(rng.integers(0, n, size=m))
    return _dedup_sort(np.concatenate(rows), np.concatenate(cols), n)


def urand_matrix(n, degree=16, seed=3):
    """GAP's urand graph (``-u log2(n) -k degree``, undirected) as
    PageRank's transition matrix, the benchmark's ``gap-urand19-f32`` made
    with NumPy: n * degree edges with both ends uniform, self loops and
    duplicates dropped, both directions stored, sorted by row; the values
    1 / degree of the column (float64).  About 2 * degree random entries a
    row: a paged delta stream whose scatter route the planner rejects."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, n * degree)
    dst = rng.integers(0, n, src.size)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = np.sort(np.concatenate([dst * n + src, src * n + dst]))
    key = key[np.r_[True, key[1:] != key[:-1]]]
    rows, cols = key // n, key % n
    return rows, cols, 1.0 / np.bincount(cols, minlength=n)[cols]


def build_blocky_matrix(n):
    """Blocky: 4x2 dense blocks + horizontal runs (w=8) + singles
    (bench.py:155)."""
    rng = np.random.default_rng(7)
    rows, cols = [], []
    nb = n // 8
    br0 = rng.integers(0, (n - 4) // 4, size=nb) * 4
    bc0 = rng.integers(0, (n - 2) // 2, size=nb) * 2
    ii, jj = np.meshgrid(np.arange(4), np.arange(2), indexing="ij")
    rows.append((br0[:, None, None] + ii[None]).ravel())
    cols.append((bc0[:, None, None] + jj[None]).ravel())
    nh = n // 4
    hr = rng.integers(0, n, size=nh)
    hc = rng.integers(0, n - 8, size=nh)
    rows.append(np.repeat(hr, 8))
    cols.append((hc[:, None] + np.arange(8)[None]).ravel())
    m = n // 4
    rows.append(rng.integers(0, n, size=m))
    cols.append(rng.integers(0, n, size=m))
    return _dedup_sort(np.concatenate(rows), np.concatenate(cols), n)


def build_diagc_matrix(n):
    """Diag-class: partial diagonal runs, anti-diagonal runs and vertical
    runs + singles (bench.py:209), the diag / rdiag / vert classes that the
    other workloads never touch."""
    rng = np.random.default_rng(9)
    rows, cols = [], []
    j16 = np.arange(16)
    # partial diagonal segments (length 16, scattered offsets)
    nd = n // 24
    dr = rng.integers(0, n - 16, size=nd)
    dc = rng.integers(0, n - 16, size=nd)
    rows.append((dr[:, None] + j16[None]).ravel())
    cols.append((dc[:, None] + j16[None]).ravel())
    # anti-diagonal segments (length 16)
    ar = rng.integers(0, n - 16, size=nd)
    ac = rng.integers(16, n, size=nd)
    rows.append((ar[:, None] + j16[None]).ravel())
    cols.append((ac[:, None] - j16[None]).ravel())
    # vertical runs (length 8)
    j8 = np.arange(8)
    nv = n // 12
    vr = rng.integers(0, n - 8, size=nv)
    vc = rng.integers(0, n, size=nv)
    rows.append((vr[:, None] + j8[None]).ravel())
    cols.append(np.repeat(vc, 8))
    # singles
    m = n // 8
    rows.append(rng.integers(0, n, size=m))
    cols.append(rng.integers(0, n, size=m))
    return _dedup_sort(np.concatenate(rows), np.concatenate(cols), n)


def wide_run_matrix(n, W, seed=0):
    """n/4 horizontal runs of width W at random (row, col), plus n random
    singles: rows with dense segments of W columns, as FEM matrices with
    many unknowns per node and LP or power-flow matrices have.  Width 16
    plans the dense-tile K1 style ``run16`` (lane placement takes W <= 8
    only), width 128 ``run128``."""
    rng = np.random.default_rng(seed)
    nh = n // 4
    hr = rng.integers(0, n, size=nh)
    hc = rng.integers(0, n - W + 1, size=nh)
    rows = np.concatenate([np.repeat(hr, W), rng.integers(0, n, size=n)])
    cols = np.concatenate([(hc[:, None] + np.arange(W)[None]).ravel(),
                           rng.integers(0, n, size=n)])
    return _dedup_sort(rows, cols, n, seed + 1)


def lane_skew_matrix(n, seed=0):
    """2n random singles whose columns fall on the coarse grid 128*j +
    {0, 1}: every element would sit in lane 0 or 1 of a lane-placed tile,
    so lane placement fails its fill gate and the delta pipeline takes the
    dense-tile K1 style ``sl``."""
    rng = np.random.default_rng(seed)
    m = 2 * n
    rows = rng.integers(0, n, size=m)
    cols = rng.integers(0, n // 128, size=m) * 128 + rng.integers(0, 2, m)
    return _dedup_sort(rows, cols, n, seed + 1)


def block3_matrix(n, seed=0):
    """n/3 block rows of 3x3 dense blocks: one on the diagonal and one at a
    random block column, as a FEM matrix with 3 unknowns per node (3-D
    elasticity) has.  bc = 3 does not divide 128, so the planner sends the
    block table through a partial segment (``fs``)."""
    rng = np.random.default_rng(seed)
    nb = n // 3
    r0 = np.arange(nb, dtype=np.int64)[:, None] * 3
    c0 = np.concatenate([r0, rng.integers(0, nb, (nb, 1)) * 3], axis=1)
    ii, jj = np.meshgrid(np.arange(3), np.arange(3), indexing="ij")
    rows = np.broadcast_to(r0[:, :, None, None] + ii, (nb, 2, 3, 3))
    cols = c0[:, :, None, None] + jj
    return _dedup_sort(rows.ravel(), cols.ravel(), n, seed + 1)


def overlap_run_matrix(n, W=16, per_row=3, seed=0):
    """``per_row`` horizontal runs of width W in every row at random start
    columns, deduplicated.  At n = 2^16, W = 16 and 3 a row (3,145,041
    nonzeros) the width-16 run table's one-fold route plan is rejected and
    the multi-fold fallback plans route instances over the same source
    rows, which no merged plan takes; K1's one G1 grid kept only the last
    fold's wires (a max relative error of 0.87 before the port re-planned
    such a table).  W = 8, 4 a row at 2^17 overlaps inside a merged plan,
    which runs it right."""
    rng = np.random.default_rng(seed)
    c0 = rng.integers(0, n - W, (n, per_row))
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row * W)
    cols = (c0[:, :, None] + np.arange(W)).ravel()
    return _dedup_sort(rows, cols, n, seed + 1)


def build_symmetric_matrix(n):
    """Symmetric: banded diagonals (0, +-1, +-8, +-13) + n/4 mirrored
    singles, the CSX-Sym configuration (bench.py:179); the full COO, its
    values symmetric."""
    rng = np.random.default_rng(5)
    rows, cols = [], []
    for b in (0, 1, 8, 13):     # lower half; mirror below
        r = np.arange(b, n, dtype=np.int64)
        rows.append(r)
        cols.append(r - b)
    m = n // 4
    sr = rng.integers(0, n, size=m)
    sc = rng.integers(0, n, size=m)
    lo, hi = np.minimum(sr, sc), np.maximum(sr, sc)
    rows.append(hi)
    cols.append(lo)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    # mirror the strict lower triangle to build the full COO
    strict = rows > cols
    rows_f = np.concatenate([rows, cols[strict]])
    cols_f = np.concatenate([cols, rows[strict]])
    rows_f, cols_f, _ = _dedup_sort(rows_f, cols_f, n)
    # VALUE symmetry: derive v from the unordered pair so v(r,c) == v(c,r)
    lo = np.minimum(rows_f, cols_f).astype(np.uint64)
    hi = np.maximum(rows_f, cols_f).astype(np.uint64)
    key = lo * np.uint64(n) + hi
    h = (key * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(40)
    vals = (h.astype(np.float32) / np.float32(1 << 24) - 0.5) * 0.2
    return rows_f, cols_f, vals


def hpcg_matrix(nx):
    """HPCG's problem matrix: the 27-point stencil on an nx^3 grid, 26 on the
    diagonal and -1 for each neighbour in the 3x3x3 cube, rows in
    lexicographic order (x fastest).  Returns (n, rows, cols, vals) sorted
    by (row, col): a row's neighbours, taken in (dz, dy, dx) order, have
    increasing columns."""
    n = nx ** 3
    r = np.arange(n, dtype=np.int64)
    i, j, k = r % nx, (r // nx) % nx, r // (nx * nx)
    cols = np.empty((n, 27), dtype=np.int64)
    ok = np.empty((n, 27), dtype=bool)
    t = 0
    for dk in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                ok[:, t] = ((i + di >= 0) & (i + di < nx) & (j + dj >= 0)
                            & (j + dj < nx) & (k + dk >= 0) & (k + dk < nx))
                cols[:, t] = r + di + nx * (dj + nx * dk)
                t += 1
    rows = np.broadcast_to(r[:, None], (n, 27))[ok]
    cols = cols[ok]
    return n, rows, cols, np.where(rows == cols, 26.0, -1.0)


def spd_symmetric_matrix(n):
    """``build_symmetric_matrix(n)`` with 2.0 on its diagonal: the same
    structure (so the same plans) made s.p.d., since its off-diagonal
    values lie in [-0.1, 0.1) and no row holds 20 of them (Gershgorin:
    ``offdiag_row_sum_max`` < 2)."""
    rows, cols, vals = build_symmetric_matrix(n)
    vals = vals.copy()
    vals[rows == cols] = 2.0
    return rows, cols, vals


def offdiag_row_sum_max(n, rows, cols, vals):
    """The largest sum of |a_ij| over j != i in a row."""
    off = rows != cols
    return float(np.bincount(rows[off], weights=np.abs(vals[off]),
                             minlength=n).max())


def spgemm_matrix(n=1 << 13, nnz_per_row=16):
    """bench.py's bench_spgemm operand (bench.py:611-637): ``nnz_per_row``
    random columns a row (duplicates merged), f32 values, seed 11.  Returns
    (n, rows, cols, vals, flops of A A)."""
    rng = np.random.default_rng(11)
    rows = np.repeat(np.arange(n), nnz_per_row)
    cols = rng.integers(0, n, rows.size)
    key = rows * n + cols
    _, u = np.unique(key, return_index=True)
    rows, cols = rows[u], cols[u]
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = rng.standard_normal(rows.size).astype(np.float32)
    row_nnz = np.bincount(rows, minlength=n)
    return n, rows, cols, vals, 2 * int(row_nnz[cols].sum())


def panel_operand(n, ncols=256, per_col=4096, seed=17):
    """A seeded sparse n x ``ncols`` matrix, ``per_col`` random rows a
    column (f32 N(0, 1) values): the tall thin operand of the SpGEMM
    panel stream.  Sorted row-major."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, ncols * per_col)
    cols = np.repeat(np.arange(ncols), per_col)
    key, u = np.unique(rows * ncols + cols, return_index=True)
    return (key // ncols, key % ncols,
            rng.standard_normal(u.size).astype(np.float32))


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for)"
                    r" .*?\d((?:k[123]|t1|lane_gather|dia|delta_pages|"
                    r"paged_gather|paged_units)\w*?_kernel)I([fd])")


def ptxas_report(log):
    """nvcc's ``-Xptxas -v`` lines of registers, spills and static shared
    memory, each named by its kernel and value type (``k3_kb_kernel<f>``).
    Dynamic shared memory, such as the K3 kernels' ring
    (``fused.cu:k3_smem_bytes``), is not in it."""
    out, kernel = [], "?"
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            kernel = f"{m.group(1)}<{m.group(2)}>"
        elif "registers" in line or "spill" in line or "smem" in line:
            out.append(f"{kernel}: {line.split(' : ')[-1].strip()}")
    return out


def run_shard_paths(spx, tf, summary):
    """The paths of matrices of several shards on the card, after the
    one-shard paths (whose summaries, in ``summary``, they are compared
    with): each tuned with ``spx.rt.nr_threads`` and run as ``run_path``
    runs a path, its kernels checked on each shard and timed in float32;
    returns their kernel entries."""
    entries_out = []
    # (label, the one-shard path's label, rows, builder, plan check,
    # shards, value types (type, bar, timed), SpMMs, whether the entries
    # and archive phase runs, symmetric modes)
    tols = (("float32", CHECK_TOL), ("float64", 1e-6))
    f32 = ("float32",)
    sym = SYMMETRIC + (("spx.tpu.sym_full", "on"),)
    ntimed = ((tols[0] + (True,)), (tols[1] + (True,)))
    shard_paths = (
        ("headline 2^20 x2 ", "", N, lambda: build_matrix(N),
         check_shards("headline"), 2, ntimed, ((8, True, f32),), True, ()),
        ("headline 2^20 x4 ", "", N, lambda: build_matrix(N),
         check_shards("headline"), 4, ntimed, (), False, ()),
        ("blocky 2^21 x2 ", "blocky ", N_BLOCKY,
         lambda: build_blocky_matrix(N_BLOCKY), check_shards("blocky"), 2,
         ntimed, ((8, False, f32),), False, ()),
        ("symmetric 2^20 x2 ", "symmetric 2^20 ", N_SYM,
         lambda: build_symmetric_matrix(N_SYM), check_shards("symmetric"),
         2, ((tols[0] + (True,)), (tols[1] + (False,))), (), False,
         tuple(SYM_MODES)),
    )
    for (prefix, one, n, build, check, nshards, types, mms, entries,
         modes) in shard_paths:
        rows, cols, vals = build()
        options = (("spx.rt.nr_threads", str(nshards)),) + (
            sym if modes else ())
        for dtype_name, tol, timed in types:
            label = prefix + dtype_name
            after = (entries_phase(spx, tf, rows, cols, vals, tol)
                     if entries and dtype_name == "float32" else None)
            s, k = run_path(spx, tf, label, n, rows, cols, vals, dtype_name,
                            tol, check, options, timed,
                            [(kk, t) for kk, t, dts in mms
                             if dtype_name in dts], modes,
                            kernels_timed=dtype_name == "float32",
                            after=after)
            summary.update(s)
            entries_out += k
            for mode in modes or ("",):
                lab = (label + " " + mode).strip()
                base = (one + dtype_name + " " + mode).strip()
                if lab in summary and base in summary:
                    summary[lab]["one_shard"] = shard_cost(
                        summary[lab], summary[base], nshards, lab)
        del rows, cols, vals

    return entries_out


# ---------------------------------------------------------------------------
# several ranks (sparsex_tpu_torch.parallel.shard.ShardedCsx)
# ---------------------------------------------------------------------------

# the timing label of every number of the ranks' paths on one card
ONE_CARD = ("one H100, ranks sharing it, gloo through the host: not a "
            "multi-GPU time")
RANK_REPS = 10          # host-clock repeats of the exchanges and the SpMV
HPCG_CG_TOL, HPCG_CG_MAXITER = 1e-8, 2000


def _tensor_bytes(tree):
    """Bytes of the tensors in an executor's ``arrays`` tree."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def _tensor_devices(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return {str(tree.device)}
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_tensor_devices(v) for v in tree)) if tree \
            else set()
    return set()


def _host_time_us(fn, reps=RANK_REPS):
    """Host-clock µs per call of ``fn`` (a collective every rank makes in
    step), median of 3 runs of ``reps`` calls, synchronised."""
    import torch
    import torch.distributed as dist
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / reps * 1e6)
    return statistics.median(times)


def rank_path_body(rank, case_path, out_dir):
    """One rank of a path of ``run_rank_paths`` (spawned; the module of
    this function is imported afresh): each case of ``case_path`` (the
    path in each value type) in turn, its record to
    ``out_dir/rank<rank>.<case>.pkl`` (:func:`_rank_case`).  What fails
    here raises and fails the run."""
    import pickle

    import torch
    torch.set_num_threads(2)
    with open(case_path, "rb") as fp:
        cases = pickle.load(fp)
    for j, case in enumerate(cases):
        out = _rank_case(rank, case)
        with open(os.path.join(out_dir, f"rank{rank}.{j}.pkl"), "wb") as fp:
            pickle.dump(out, fp)
        del out
        torch.cuda.empty_cache()


def _rank_case(rank, case):
    """One rank's run of one case: build ``ShardedCsx`` from the matrix's
    host tables on its device, run the SpMV (and SpMM, CG) and record its
    y, launch counts against its executors' plans, plan bytes and device
    placement; on rank 0 every kernel of its executors against its plain
    version at its shapes; when timed, each rank's executors alone (in
    turns), each exchange and the whole SpMV (all ranks together)."""
    import torch
    import torch.distributed as dist

    import sparsex_tpu_torch as spx
    from sparsex_tpu_torch import solvers
    from sparsex_tpu_torch.ops import fused as tf
    from sparsex_tpu_torch.parallel.shard import ShardedCsx, host_matrix
    cfg = spx.Config.reset()
    for key, value in case["options"]:
        cfg.set(key, value)
    dev = torch.device(case["devices"][rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    label = case["label"]
    mat = host_matrix(case["host"])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    sh = ShardedCsx(mat, device=dev)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0,
           "allocated": torch.cuda.memory_allocated(dev) - base,
           "plan_bytes": sum(_tensor_bytes(ex.arrays)
                             for ex in sh.executors),
           "devices": sorted(set().union(*(_tensor_devices(ex.arrays)
                                           for ex in sh.executors))),
           "layout": (sh.x_mode, sh.halo_k, sh.chunk),
           "plans": [(ex.variant, sorted(extras_of(ex.meta)),
                      [(a, len(o)) for a, o, _n in ex.meta[4]],
                      _fused_desc(ex.meta)) for ex in sh.executors]}
    x = torch.as_tensor(case["x"], device=dev)
    tf.launches.clear()
    y = sh.matvec(x)
    torch.cuda.synchronize()
    out["counts"] = tf.launch_counts()
    want = dict.fromkeys(tf.KERNELS, 0)
    for ex in sh.executors:     # warm-up and capture of each executor
        for key, v in expected_counts(ex.meta).items():
            want[key] += 2 * v
    out["want"] = want
    tf.launches.clear()
    y2 = sh.matvec(x, 2.0, 0.5, y)      # replays: nothing from Python
    torch.cuda.synchronize()
    out["replay_counts"] = {k: v for k, v in tf.launch_counts().items() if v}
    out["y"], out["y2"] = y.cpu().numpy(), y2.cpu().numpy()
    if case["X"] is not None:
        X = torch.as_tensor(case["X"], device=dev)
        k = X.shape[1]
        tf.launches.clear()
        Y = sh.matmat(X)
        torch.cuda.synchronize()
        out["mm_counts"] = tf.launch_counts()
        want = dict.fromkeys(tf.KERNELS, 0)
        for ex in sh.executors:
            for key, v in expected_counts(ex.meta, k).items():
                want[key] += 2 * v
        out["mm_want"], out["Y"] = want, Y.cpu().numpy()
    # each executor's input: x, the own chunk, the halo window
    lay = sh.layout
    if lay.x_mode == "halo":
        xloc = sh.x_chunk(x)
        xwin = sh.comm.ring_window(xloc, lay.halo_k).wait()
        xs = [xwin] if sh.symmetric else [xloc, xwin][:len(sh.executors)]
    else:
        xs = [x]
    dist.barrier()
    if rank == 0:
        out["kernels"] = shards_kernel_phase(
            sh.executors, xs, f"{label} rank 0", case["kernels_timed"])
    dist.barrier()
    if case["timed"]:
        for r in range(dist.get_world_size()):   # one rank at a time
            dist.barrier()
            if r == rank:
                out["executor_us"] = [
                    cuda_time_ms(lambda ex=ex, xi=xi: ex(xi)) * 1e3
                    for ex, xi in zip(sh.executors, xs)]
        dist.barrier()
        comm = sh.comm
        ex_us = {}
        if lay.x_mode == "halo":
            ex_us["ring"] = _host_time_us(
                lambda: comm.ring_window(xloc, lay.halo_k).wait())
        if sh.symmetric:
            z = sh.executors[0](xs[0])
            ex_us["reduce_scatter"] = _host_time_us(
                lambda: comm.reduce_scatter_rows(z, lay.row_start,
                                                 lay.nrows_loc))
        rows = sh.own_rows(x)
        ex_us["all_gather"] = _host_time_us(
            lambda: comm.all_gather_rows(rows, sh.gather_idx))
        out["exchange_us"] = ex_us
        out["matvec_us"] = _host_time_us(lambda: sh.matvec(x))
        comm.reset()
        sh.matvec(x)
        out["bytes_per_spmv"] = dict(comm.bytes)
        out["host_bytes_per_spmv"] = dict(comm.host_bytes)
    if case["cg"] is not None:
        b = torch.as_tensor(case["cg"], device=dev)
        t0 = time.perf_counter()
        xc, it, res = solvers.cg(lambda v: sh.matvec(v), b, tol=HPCG_CG_TOL,
                                 maxiter=HPCG_CG_MAXITER, graph=False)
        torch.cuda.synchronize()
        out["cg"] = (xc.cpu().numpy(), it, float(res),
                     time.perf_counter() - t0)
    out["allocated_end"] = torch.cuda.memory_allocated(dev)
    return out


def rank_case(spx, label, nranks, n, rows, cols, vals, dtype_name, tol,
              options, timed, mm_k=0, cg=False, backend="gloo"):
    """One value type of a path on ``nranks`` ranks, made ready here: the
    matrix tuned in ``nranks`` shards on cuda:0 (its one-device executor,
    per shard for a symmetric matrix: its plan bytes and y, and for ``cg``
    its CG are what the ranks are held against).  Returns (the case the
    ranks run, what its checks need)."""
    import torch
    from sparsex_tpu_torch import solvers
    from sparsex_tpu_torch.parallel.shard import host_side
    opts = tuple(options) + (("spx.rt.nr_threads", str(nranks)),)
    sym = ("spx.matrix.symmetric", "true") in opts
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    mat = tune(spx, rows, cols, vals, n, dtype_name, label + " one device",
               opts + ((("spx.tpu.sym_full", "off"),) if sym else ()))
    csx = mat.csx
    csx._executor()
    torch.cuda.synchronize()
    ref = {"label": label, "dtype": dtype_name, "tol": tol, "timed": timed,
           "mm_k": mm_k, "one_alloc": torch.cuda.memory_allocated() - m0,
           "one_bytes": sum(_tensor_bytes(ex.arrays)
                            for ex in csx.executors)}
    x = x_for(mat, n, dtype_name)
    ref["y_one"] = csx.matvec(x).double().cpu().numpy()
    ref["want"] = _oracle_spmv(n, rows, cols, vals, x)
    xh = x.cpu().numpy()
    X = (np.random.default_rng(3).standard_normal((n, mm_k)).astype(
        xh.dtype) if mm_k else None)
    b = None
    if cg:
        b = _oracle_spmv(n, rows, cols, vals, np.ones(n)).astype(xh.dtype)
        t1 = time.perf_counter()
        xo, ito, _res = solvers.cg(csx.matvec,
                                   torch.as_tensor(b, device=x.device),
                                   tol=HPCG_CG_TOL, maxiter=HPCG_CG_MAXITER)
        torch.cuda.synchronize()
        ref["cg_one"] = (xo.double().cpu().numpy(), ito,
                         time.perf_counter() - t1)
    ref["X"], ref["b"] = X, b
    ref["devices"] = [str(x.device) if backend == "gloo" else f"cuda:{r}"
                      for r in range(nranks)]
    case = {"label": label, "options": opts, "x": xh, "X": X, "cg": b,
            "timed": timed, "kernels_timed": timed, "backend": backend,
            "devices": ref["devices"], "host": host_side(csx)}
    del mat, csx, x
    torch.cuda.empty_cache()
    return case, ref


def check_rank_case(ref, outs, nranks, n, rows, cols, vals, mode, backend,
                    ranks_s):
    """The ranks' records ``outs`` of one case against ``ref``
    (:func:`rank_case`): every rank's y equal, within the bar of the
    float64 COO oracle and of the one-device y; x mode ``mode``; each
    rank's launches those of its executors' plans and a replay launching
    nothing from Python, the SpMM likewise; each rank's plan on its device
    and under (1 + 1/N) / 2 of the whole matrix's bytes; the sharded CG's
    count within one of the one-device CG's with a true residual under
    ``CG_BAR``.  Prints the timings.  Returns ({label: summary}, kernel
    entries)."""
    label, tol, mm_k, devices = (ref["label"], ref["tol"], ref["mm_k"],
                                 ref["devices"])
    one_bytes, want = ref["one_bytes"], ref["want"]
    o0 = outs[0]
    x_mode, k, chunk = o0["layout"]
    if x_mode != mode:
        fail(f"[{label}] x mode {x_mode}, expected {mode}")
    for r, o in enumerate(outs):
        for i, (variant, extras, dias, fused) in enumerate(o["plans"]):
            say(f"[{label}] rank {r} executor {i}: {variant} variant; "
                f"extras {extras}; DIA tables {dias}; {fused}")
        if not np.array_equal(o["y"], o0["y"]):
            fail(f"[{label}] rank {r}'s y differs from rank 0's")
        got = {kk: v for kk, v in o["counts"].items() if v}
        exp = {kk: v for kk, v in o["want"].items() if v}
        if got != exp or not exp:
            fail(f"[{label}] rank {r} launched {got}, its plans {exp}")
        if o["replay_counts"]:
            fail(f"[{label}] rank {r}'s replay launched "
                 f"{o['replay_counts']} from Python")
        if mm_k:
            got = {kk: v for kk, v in o["mm_counts"].items() if v}
            exp = {kk: v for kk, v in o["mm_want"].items() if v}
            if got != exp:
                fail(f"[{label}] rank {r}'s SpMM launched {got}, its "
                     f"plans {exp}")
        if o["devices"] != [devices[r]]:
            fail(f"[{label}] rank {r}'s tensors on {o['devices']}")
        if not o["plan_bytes"] < (1 + 1 / nranks) / 2 * one_bytes:
            fail(f"[{label}] rank {r} holds {o['plan_bytes']} plan bytes "
                 f"of the whole matrix's {one_bytes}")
    y = o0["y"]
    err = _mixed_rel_err(y, want)
    err_one = _mixed_rel_err(y, ref["y_one"])
    err2 = _mixed_rel_err(o0["y2"], 2.0 * want + 0.5 * y)
    say(f"[{label}] {nranks} ranks ({backend}) on "
        + ", ".join(sorted(set(devices))) + f": x_mode {x_mode}, halo_k "
        f"{k}, chunk {chunk}; ranks' build "
        + ", ".join(f"{o['build_s']:.2f}" for o in outs) + " s; plan MiB "
        + ", ".join(f"{o['plan_bytes'] / 2**20:.2f}" for o in outs)
        + f" against the whole matrix's {one_bytes / 2**20:.2f} on one "
        f"device (allocated: "
        + ", ".join(f"{o['allocated'] / 2**20:.2f}" for o in outs)
        + f" against {ref['one_alloc'] / 2**20:.2f} MiB); the ranks' run "
        f"of the path's cases {ranks_s:.1f} s")
    say(f"[{label}] y against the float64 COO oracle {err:.3e}, against "
        f"the one-device executor {err_one:.3e}, alpha=2/beta=0.5 "
        f"{err2:.3e} (bar {tol:g}); each rank's first call launched its "
        f"plans' kernels (warm-up and capture), its replay none")
    if not (err <= tol and err_one <= tol and err2 <= tol):
        fail(f"[{label}] y off: oracle {err:.3e}, one device {err_one:.3e}"
             f", alpha/beta {err2:.3e}, bar {tol:g}")
    summary = {"x_mode": x_mode, "halo_k": k, "chunk": chunk,
               "backend": backend, "ranks": nranks,
               "oracle_rel_err": err, "one_device_rel_err": err_one,
               "plan_mib": [o["plan_bytes"] / 2**20 for o in outs],
               "one_device_plan_mib": one_bytes / 2**20,
               "launches_first_spmv": [
                   {kk: v for kk, v in o["counts"].items() if v}
                   for o in outs]}
    if mm_k:
        errm = _mixed_rel_err(o0["Y"],
                              _oracle_spmv(n, rows, cols, vals, ref["X"]))
        say(f"[{label}] SpMM k={mm_k}: against the oracle {errm:.3e}; "
            "launches as the plans' SpMM")
        if not errm <= tol:
            fail(f"[{label}] SpMM off: {errm:.3e}")
        summary["spmm_rel_err"] = errm
    if ref["timed"]:
        summary.update(
            timing=ONE_CARD,
            executor_us=[o["executor_us"] for o in outs],
            exchange_us=[o["exchange_us"] for o in outs],
            matvec_us=[o["matvec_us"] for o in outs],
            bytes_per_spmv=o0["bytes_per_spmv"],
            host_bytes_per_spmv=o0["host_bytes_per_spmv"])
        say(f"[{label}] {ONE_CARD}: each rank's executors alone (CUDA "
            "events, graph replays, one rank at a time) "
            + "; ".join(", ".join(f"{u:.2f}" for u in o["executor_us"])
                        for o in outs)
            + " us; exchanges (host clock, all ranks) "
            + "; ".join(f"{op} {us:.1f} us" for op, us in
                        o0["exchange_us"].items())
            + "; the whole SpMV from Python "
            + ", ".join(f"{o['matvec_us']:.1f}" for o in outs)
            + " us a rank; rank 0 hands the transport "
            + ", ".join(f"{op} {v / 2**20:.2f} MiB" for op, v in
                        o0["bytes_per_spmv"].items())
            + " an SpMV, host copies "
            + ", ".join(f"{op} {v / 2**20:.2f} MiB" for op, v in
                        o0["host_bytes_per_spmv"].items()))
    if ref["b"] is not None:
        b = ref["b"]
        xc, it, _res, secs = o0["cg"]
        xo, ito, secs_one = ref["cg_one"]
        rel = float(np.linalg.norm(b - _oracle_spmv(n, rows, cols, vals, xc))
                    / np.linalg.norm(b))
        dx = float(np.abs(xc - xo).max() / np.abs(xo).max())
        say(f"[cg {label}] tol {HPCG_CG_TOL:g}, graph=False: {it} "
            f"iterations ({ito} on one device), x within {dx:.3e} of the "
            f"one-device x, true residual ||b - Ax|| / ||b|| {rel:.3e} "
            f"(float64 COO oracle); {secs:.2f} s ({secs_one:.2f} s on one "
            f"device with its graph; {ONE_CARD})")
        if abs(it - ito) > 1 or not rel <= CG_BAR[ref["dtype"]]:
            fail(f"[cg {label}] {it} iterations against {ito}, true "
                 f"residual {rel:.3e}")
        summary["cg"] = {"iterations": it, "one_device_iterations": ito,
                         "true_residual": rel, "x_rel_to_one_device": dx,
                         "seconds": secs, "one_device_seconds": secs_one}
    entries = []
    if ref["timed"]:
        entries = kernel_entries(o0["kernels"], o0["counts"], None,
                                 f"{label} rank 0")
    return {label: summary}, entries


def rank_path(spx, prefix, nranks, n, rows, cols, vals, options, mode,
              mm_k=0, cg=False, backend="gloo"):
    """One path on ``nranks`` spawned ranks (``rank_path_body``), float32
    timed (with the SpMM of ``mm_k`` columns) and float64 checked (with
    ``cg``), both cases in one spawn of the ranks: each made ready by
    :func:`rank_case`, run, and checked by :func:`check_rank_case`.
    Returns ({label: summary}, kernel entries)."""
    import pickle
    import tempfile

    from sparsex_tpu_torch.parallel.comm import run_ranks
    t0 = time.perf_counter()
    cases, refs = [], []
    for dtype_name, tol in (("float32", CHECK_TOL), ("float64", 1e-6)):
        f32 = dtype_name == "float32"
        case, ref = rank_case(
            spx, prefix + dtype_name + ("" if backend == "gloo" else
                                        " nccl"),
            nranks, n, rows, cols, vals, dtype_name, tol, options,
            f32 and backend == "gloo", mm_k=mm_k if f32 else 0,
            cg=cg and not f32, backend=backend)
        cases.append(case)
        refs.append(ref)
    with tempfile.TemporaryDirectory(prefix="spx_rank_path_") as d:
        with open(os.path.join(d, "cases.pkl"), "wb") as fp:
            pickle.dump(cases, fp)
        del cases
        t1 = time.perf_counter()
        run_ranks(rank_path_body, nranks, (os.path.join(d, "cases.pkl"), d),
                  backend=backend, timeout_s=900)
        ranks_s = time.perf_counter() - t1
        outs = []
        for j in range(len(refs)):
            outs.append([])
            for r in range(nranks):
                with open(os.path.join(d, f"rank{r}.{j}.pkl"), "rb") as fp:
                    outs[j].append(pickle.load(fp))
    summary, entries = {}, []
    for ref, outs_j in zip(refs, outs):
        s, e = check_rank_case(ref, outs_j, nranks, n, rows, cols, vals,
                               mode, backend, ranks_s)
        summary.update(s)
        entries += e
    say(f"[{prefix.strip()}] path done in {time.perf_counter() - t0:.1f} s")
    return summary, entries


def run_rank_paths(spx, summary):
    """The paths of several ranks, one process each, on the card
    (``ShardedCsx``, the counterpart of ``dryrun_multichip``): headline
    2^20 on 2 ranks (replicated x; SpMM k = 8 in float32), HPCG 128^3 on
    4 (halo x), the CSX-Sym matrix at 2^20 on 2 (symmetric, replicated)
    and symmetric HPCG 128^3 on 4 (symmetric halo; in float64 CG to
    1e-8), float32 timed and float64 checked, all ranks on cuda:0 with
    gloo.  With several GPUs the same paths also run on NCCL, a GPU a
    rank.  Returns their kernel entries."""
    import torch
    entries = []
    hpcg = lambda: hpcg_matrix(HPCG_NX)[1:]   # noqa: E731
    paths = (
        ("headline 2^20 ranks x2 ", 2, N, lambda: build_matrix(N), (),
         "replicated", 8, False),
        ("hpcg 128^3 ranks x4 ", 4, HPCG_NX ** 3, hpcg, (), "halo", 0,
         False),
        ("symmetric 2^20 ranks x2 ", 2, N_SYM,
         lambda: build_symmetric_matrix(N_SYM), SYMMETRIC, "replicated", 0,
         False),
        ("symmetric hpcg 128^3 ranks x4 ", 4, HPCG_NX ** 3, hpcg, SYMMETRIC,
         "halo", 0, True),
    )
    ngpu = torch.cuda.device_count()
    backends = ["gloo"] + (["nccl"] if ngpu >= 2 else [])
    if ngpu < 2:
        say(f"[ranks] the NCCL form (a GPU a rank) not run: "
            f"torch.cuda.device_count() = {ngpu}, and NCCL refuses two "
            "ranks on one device; the gloo form runs every rank on cuda:0")
    for prefix, nranks, n, build, options, mode, mm_k, cg in paths:
        rows, cols, vals = build()
        for backend in backends:
            if backend == "nccl" and nranks > ngpu:
                say(f"[{prefix.strip()}] NCCL not run: {nranks} ranks, "
                    f"{ngpu} GPUs")
                continue
            s, e = rank_path(spx, prefix, nranks, n, rows, cols, vals,
                             options, mode, mm_k=mm_k, cg=cg,
                             backend=backend)
            summary.update(s)
            entries += e
        del rows, cols, vals
    return entries


def run_solver_paths(spx, tf, summary):
    """CG and block CG on the CSX-Sym matrix made s.p.d.
    (``spd_symmetric_matrix(1 << 20)``, Gershgorin checked on the host),
    tuned as a symmetric matrix and run as its full mirror: the path of
    ``run_path`` (timed in float32 with its SpMM at k = ``SOLVER_K``,
    checked in float64), then ``spd_solver_phase``.  Returns the path's
    kernel entries."""
    rows, cols, vals = spd_symmetric_matrix(N_SYM)
    margin = offdiag_row_sum_max(N_SYM, rows, cols, vals)
    say(f"[spd symmetric 2^20] {N_SYM}x{N_SYM}, nnz_full={rows.size}; "
        f"largest off-diagonal row sum {margin:.4f} against the diagonal "
        "2.0 (Gershgorin)")
    if not margin < 2.0:
        fail(f"[spd symmetric 2^20] an off-diagonal row sum {margin:.4f} "
             "reaches the diagonal: not shown s.p.d.")
    sym = SYMMETRIC + (("spx.tpu.sym_full", "on"),)
    entries = []
    for dtype_name, tol, timed in (("float32", CHECK_TOL, True),
                                   ("float64", 1e-6, False)):
        s, k = run_path(spx, tf, "spd symmetric 2^20 " + dtype_name, N_SYM,
                        rows, cols, vals, dtype_name, tol,
                        check_sym_plan("symmetric"), sym, timed,
                        [(SOLVER_K, timed)], ("full",),
                        solve=spd_solver_phase(spx, rows, cols, vals,
                                               dtype_name, timed))
        summary.update(s)
        entries += k
    return entries


def main():
    """All the phases; ``--paths LABEL ...`` runs only the one-card paths
    of those labels (``"urand 2^19"``, ``"headline 2^22"``, ...), all their
    value types, and none of the phases after them."""
    import torch
    only = (sys.argv[sys.argv.index("--paths") + 1:]
            if "--paths" in sys.argv else None)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    try:
        import sparsex_tpu_torch as spx
        from sparsex_tpu_torch.ops import _build
        from sparsex_tpu_torch.ops import fused as tf
    except ImportError as e:
        fail(f"cannot import the repository ({e}); run from its root")
    banned = [m for m in sys.modules if m.split(".")[0] in
              ("jax", "sparsex_tpu", "bench")]
    if banned:
        fail(f"imported {sorted(banned)}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    say(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f"; CUDA {torch.version.cuda}; python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.library()
    say(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds or 0:.1f} s)")
    for line in ptxas_report(_build.build_log):
        print("  ptxas: " + line, file=sys.stderr)

    tols = (("float32", CHECK_TOL), ("float64", 1e-6))
    kernels_out, summary = [], {}
    warm_up()
    # the SpMMs of a path: (k, timed, value types); k = 8 is one full
    # k-batched chunk (bench.py's SpMM figure), k = 11 two chunks (8 + 3)
    both, f32 = ("float32", "float64"), ("float32",)
    mm8 = ((8, True, both),)
    sym = SYMMETRIC + (("spx.tpu.sym_full", "on"),)
    # (label, rows of the matrix, its builder, plan check, extra tune
    # options, value types to run, timed (all of them, or the types
    # named), SpMMs, symmetric modes)
    paths = (
        ("", N, lambda: build_matrix(N), check_plan, (), tols, True,
         mm8 + ((11, False, f32),)),
        # (blocky 2^21 is timed in f32; its f64 is checked untimed at
        # 2^19, the same plan classes and styles)
        ("blocky ", N_BLOCKY, lambda: build_blocky_matrix(N_BLOCKY),
         check_blocky_plan, (), tols[:1], True, ((8, True, f32),)),
        ("blocky 2^19 ", N_BLOCKY_CHECK,
         lambda: build_blocky_matrix(N_BLOCKY_CHECK),
         check_masked_blocky_plan, (), tols, f32,
         ((8, True, f32), (3, False, f32), (8, False, ("float64",)))),
        # bench.py's fourth workload: the delta pipeline with the vertical
        # runs demoted into it, 4 route instances (the fourth of its own
        # shape); f32 timed, f64 and a k = 8 SpMM checked
        ("diagc 2^19 ", N_DIAGC, lambda: build_diagc_matrix(N_DIAGC),
         check_diagc_plan(4), (), tols, f32, ((8, False, f32),)),
        # (the paths timed in f32 check f64 untimed, and at a quarter of
        # the rows, which keeps the script with the shard and rank paths
        # well inside its time limit: the same plan classes and K1 styles,
        # a quarter of the host's tuning)
        ("wide-run 2^21 W=16 ", N_DENSE, lambda: wide_run_matrix(N_DENSE, 16),
         check_dense_plan("run16"), (), tols[:1], True, ((8, True, f32),)),
        ("wide-run 2^19 W=16 ", N_DENSE_CHECK,
         lambda: wide_run_matrix(N_DENSE_CHECK, 16),
         check_dense_plan("run16"), (), tols[1:], False,
         ((8, False, ("float64",)),)),
        ("lane-skew 2^21 ", N_DENSE, lambda: lane_skew_matrix(N_DENSE),
         check_dense_plan("sl"), (), tols[:1], True, ((8, True, f32),)),
        ("lane-skew 2^19 ", N_DENSE_CHECK,
         lambda: lane_skew_matrix(N_DENSE_CHECK), check_dense_plan("sl"),
         (), tols[1:], False, ((8, False, ("float64",)),)),
        ("fs-run 2^21 W=5 ", N_DENSE, lambda: wide_run_matrix(N_DENSE, 5),
         check_fs_plan("runs"), (), tols[:1], True, ((8, True, f32),)),
        ("fs-run 2^19 W=5 ", N_DENSE_CHECK,
         lambda: wide_run_matrix(N_DENSE_CHECK, 5), check_fs_plan("runs"),
         (), tols[1:], False, ()),
        ("fs-block 3x2^19 ", N_FS_BLOCK, lambda: block3_matrix(N_FS_BLOCK),
         check_fs_plan("blocks"), (), tols[:1], True, ((8, False, f32),)),
        ("fs-block 3x2^17 ", N_FS_BLOCK_CHECK,
         lambda: block3_matrix(N_FS_BLOCK_CHECK), check_fs_plan("blocks"),
         (), tols[1:], False, ()),
        ("overlap-run 2^16 W=16 ", N_OVERLAP,
         lambda: overlap_run_matrix(N_OVERLAP), check_overlap_plan, (),
         tols, False, ()),
        ("wide-run 2^19 W=128 ", N_RUN128,
         lambda: wide_run_matrix(N_RUN128, 128), check_dense_plan("run128"),
         (), tols[:1], False, ()),
        ("headline-nofuse 2^20 ", N, lambda: build_matrix(N),
         check_nofuse_plan("headline"), NO_FUSE, tols, True,
         ((2, False, f32),)),
        ("blocky-nofuse 2^20 ", N, lambda: build_blocky_matrix(N),
         check_nofuse_plan("blocky"), NO_FUSE, tols, True,
         ((2, False, f32),)),
        ("hpcg 128^3 ", HPCG_NX ** 3, lambda: hpcg_matrix(HPCG_NX)[1:],
         lambda m, lb: check_pages_plan(m, "hpcg", lb), (), tols, True,
         ((2, False, f32),)),
        ("headline 2^22 ", N_BIG, lambda: build_matrix(N_BIG),
         lambda m, lb: check_pages_plan(m, "headline", lb), (), tols, True,
         ((2, False, f32),)),
        ("blocky 2^22 ", N_BIG, lambda: build_blocky_matrix(N_BIG),
         lambda m, lb: check_pages_plan(m, "blocky", lb), (), tols, True,
         ()),
        # the benchmark's graph: the row-blocked delta-pages epilogue
        ("urand 2^19 ", N_URAND, lambda: urand_matrix(N_URAND),
         lambda m, lb: check_pages_plan(m, "urand", lb), (), tols, True,
         ((2, False, f32),)),
        ("symmetric 2^20 ", N_SYM, lambda: build_symmetric_matrix(N_SYM),
         check_sym_plan("symmetric"), sym, tols, f32, ((2, False, f32),),
         tuple(SYM_MODES)),
        ("symmetric hpcg 128^3 ", HPCG_NX ** 3,
         lambda: hpcg_matrix(HPCG_NX)[1:], check_sym_plan("hpcg"), sym,
         tols, f32, ((2, False, f32),), tuple(SYM_MODES)),
    )
    # the paths whose tuned matrix a solver phase runs on (``solve``)
    solves = {"symmetric hpcg 128^3 ": hpcg_cg_phase}
    if only is not None:
        paths = [p for p in paths if p[0].strip() in only]
        if len(paths) != len(only):
            fail(f"--paths {only}: {len(paths)} of them are paths")
    for prefix, n, build, check, options, types, timed, mms, *modes in paths:
        rows, cols, vals = build()
        if modes:
            say(f"[{prefix.strip()}] symmetric matrix: {n}x{n}, "
                f"nnz_full={rows.size}")
        for dtype_name, tol in types:
            label = prefix + dtype_name
            s, k = run_path(spx, tf, label, n, rows, cols, vals, dtype_name,
                            tol, check, options,
                            (timed if isinstance(timed, bool)
                             else dtype_name in timed),
                            [(kk, t) for kk, t, dts in mms
                             if dtype_name in dts], *modes,
                            solve=(solves[prefix](spx, rows, cols, vals,
                                                  dtype_name)
                                   if prefix in solves else None))
            summary.update(s)
            kernels_out += k
        if prefix in BF16_PATHS:
            summary.update(bf16_phase(spx, tf, prefix + "bfloat16", n, rows,
                                      cols, vals))
        del rows, cols, vals

    if only is not None:
        say("summary: " + json.dumps(summary))
        say(card)
        say(json.dumps({"kernels": kernels_out}))
        return
    t0 = time.perf_counter()
    kernels_out += run_solver_paths(spx, tf, summary)
    say(f"[spd symmetric 2^20] solver paths done in "
        f"{time.perf_counter() - t0:.1f} s")
    kernels_out += run_shard_paths(spx, tf, summary)
    t0 = time.perf_counter()
    kernels_out += run_rank_paths(spx, summary)
    say(f"[ranks] paths done in {time.perf_counter() - t0:.1f} s")
    spgemm_phase(spx, summary)
    t0 = time.perf_counter()
    examples_phase(spx, summary)
    say(f"[examples] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tools_phase(spx, summary)
    say(f"[tools] done in {time.perf_counter() - t0:.1f} s")
    kernels_out += solver_entries(kernels_out, summary)

    say("summary: " + json.dumps(summary))
    say(card)
    say(json.dumps({"kernels": kernels_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
