"""Smoke test of sparsex_tpu_torch on one CUDA GPU (written for an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``sparsex_tpu_torch/csrc`` (one nvcc per
source, run together) and drives the port's paths on the card at full
width, each tuned with ``sparsex_tpu_torch.mat_tune`` and multiplied with
``matvec_kernel`` in float32 and float64:

- the headline bench matrix (``bench.build_matrix(1 << 20)``: 2^20 rows,
  5.77M nonzeros): the fused delta pipeline (K1 style lp, T1, K2, K3) with
  the DIA tables riding K3;
- the blocky bench matrix (``bench.build_blocky_matrix(1 << 21)``: 2^21
  rows, 6.82M nonzeros of 4x2 blocks, width-8 runs and singles): the
  delta pipeline plus two fused run tables (K1 styles rlp8 and rlp2) in
  one merged route plan (per instance: the G1 lane gather, T1, K2), one
  K3; then one untimed float32 check at bench.py's own 2^19, whose merged
  plan has a masked instance;
- the non-fused variants, which the fused planners refuse (more than 2^21
  rows, or nothing to fuse):
  - HPCG's 27-point stencil on a 128^3 grid (``hpcg_matrix``: 2^21 rows,
    55.7M nonzeros): the plain-table variant, one DIA kernel launch of 27
    diagonals;
  - ``bench.build_matrix(1 << 22)`` (23.1M nonzeros): the legacy paged
    variant, the delta-pages product with its scatter-add and the DIA
    kernel on the 5 diagonals;
  - ``bench.build_blocky_matrix(1 << 22)`` (13.6M nonzeros): the paged
    delta stream and the unit-page gathers of the paged run and block
    tables.

Every phase is fatal on failure:

1. the device, torch / CUDA versions and the kernel build time;
2. tuning, with the plan checked to hold the expected execution classes;
3. each kernel of the path against its plain PyTorch version on that
   plan's arrays, at every shape the path gives it (on the blocky path
   every merged instance, the 2^19 check's unmasked-K2 / masked-K3
   instance included): K1 (lp and rlp), T1, K2, the lane gather, the DIA
   kernel, the delta-pages product and the unit-page gather bit-equal, K3
   within 1e-6 of the largest value (its sums are ordered as the plain
   version's, but the bar leaves room for the order to change);
4. the SpMV end to end against a float64 COO oracle (``bench.CHECK_TOL``
   in float32, 1e-6 in float64) at alpha=1/beta=0 and alpha=2/beta=0.5,
   with the launch counts, derived from the plan, showing that each
   kernel ran on that path;
5. CUDA-event times, median over 5 runs of 128 calls after a warm-up:
   the SpMV end to end as a Python caller gets it, the host's time to
   enqueue one, and the SpMV replayed from a CUDA graph (device time);
   each kernel and its plain version replayed from CUDA graphs, in the
   order plain, kernel, kernel, plain (one kernel alone, 128 times in a
   row: its inputs stay warm in L2); not for the untimed 2^19 check;
6. a torch.profiler trace of 50 SpMVs: each kernel's device time inside
   the real SpMV, the PyTorch glue kernels around them (the four largest
   by name), and the share of the called-from-Python time the device is
   busy.

The card's name and power limit (nvidia-smi) come two lines before the
last; the line before the last is a JSON object ``{"kernels": [...]}``
(per timed path and value type, each kernel that path runs with that
path's launch counts: K1, T1, K2, K3 on the headline, the six fused-path
kernels on the blocky path, the DIA kernel, the delta-pages product and
the unit-page gather on the non-fused paths); the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside the repository, it exits non-zero and prints no result.
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
N_BIG = 1 << 22         # past the fused planners' 2^21-row cap
HPCG_NX = 128           # the HPCG stencil's grid edge: 2^21 rows
SOURCE = {"lane_gather": "sparsex_tpu_torch/csrc/route.cu",
          "dia": "sparsex_tpu_torch/csrc/dia.cu",
          "delta_pages": "sparsex_tpu_torch/csrc/pages.cu",
          "paged_gather": "sparsex_tpu_torch/csrc/pages.cu"}
FUSED_SOURCE = "sparsex_tpu_torch/csrc/fused.cu"
REPLACES = {
    "k1": "sparsex_tpu/ops/fused.py:962",
    "k1_rlp": "sparsex_tpu/ops/fused.py:962",
    "t1": "sparsex_tpu/ops/fused.py:1317",
    "k2": "sparsex_tpu/ops/fused.py:1143",
    "k3": "sparsex_tpu/ops/fused.py:1372",
    "lane_gather": "sparsex_tpu/ops/route.py:425",
    "dia": "sparsex_tpu/ops/pallas_kernels.py:40",
    "delta_pages": "sparsex_tpu/ops/pallas_kernels.py:233",
    "paged_gather": "sparsex_tpu/ops/pallas_kernels.py:389",
}


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


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


def paired_ms(kernel, plain):
    """(kernel ms, plain ms) of device time per call, timed in the order
    plain, kernel, kernel, plain and averaged, so a clock that drifts
    during the run weighs on both alike."""
    p1, k1, k2, p2 = (graph_time_ms(f) for f in (plain, kernel, kernel,
                                                  plain))
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


def expected_counts(meta):
    """Kernel launches of one SpMV, derived from the plan: K1 lp once per
    delta part, K1 rlp once per fused run table, per route instance one
    T1 and one K2 (and one lane gather for a merged plan's G1), one K3 per
    8 instances; one DIA kernel per standalone DIA table, one delta-pages
    product for the paged delta stream, one unit-page gather per paged
    table."""
    ex = extras_of(meta)
    dfused, fall = ex.get("dfused"), ex.get("fall")
    n_k1 = 0
    if dfused is not None:
        fmeta = dfused[0]
        n_k1 = 2 if len(fmeta) > 7 and fmeta[7] is not None else 1
    runs = fused_runs(meta)
    if fall is not None:
        n_inst = len(fall[1])
    else:
        n_inst = (len(dfused[0][3]) if dfused is not None else 0) + sum(
            len(m[3]) for _, m in runs)
    n_dia = (0 if "k3dias" in ex
             else sum(1 for _a, offs, _n in meta[4] if offs))
    return {"k1": n_k1, "k1_rlp": len(runs),
            "t1": n_inst, "k2": n_inst, "k3": -(-n_inst // 8),
            "lane_gather": n_inst if fall is not None else 0,
            "dia": n_dia, "delta_pages": int("dpages" in ex),
            "paged_gather": len(paged_tables(meta))}


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


def tune(spx, rows, cols, vals, n, dtype_name, label):
    import torch
    cfg = spx.Config.reset()
    cfg.set("spx.tpu.value_dtype", dtype_name)
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "portion")
    t0 = time.perf_counter()
    mat = spx.mat_tune(csr_input(spx, rows, cols, vals, n))
    torch.cuda.synchronize()
    say(f"[{label}] mat_tune: {time.perf_counter() - t0:.2f} s, {n}x{n}, "
        f"nnz={mat.nnz}, on {mat.device}")
    return mat


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


def check_plan(mat):
    ex = mat.csx.executors[0]
    extras = extras_of(ex.meta)
    if "dfused" not in extras or "k3dias" not in extras:
        fail(f"plan holds {sorted(extras)}, expected dfused + k3dias")
    fmeta = extras["dfused"][0]
    if len(fmeta) < 8 or fmeta[7] is None:
        fail("plan has no hybrid tail part")
    say(f"plan: bulk T={fmeta[0]} q={fmeta[1]} style={fmeta[6]}; tail "
        f"T={fmeta[7][0][0]} q={fmeta[7][0][1]}; instances="
        f"{[m[:7] for m in fmeta[3]]}; residuals={fmeta[4]} "
        f"left={fmeta[5]}; k3dias={extras['k3dias']}")
    return ex, fmeta, extras["k3dias"]


def kernel_phase(ex, fmeta, k3dias, x, dtype_name):
    """Each kernel against its plain version on the plan's arrays, at the
    shapes of the main path; returns {name: (max_abs_err, ms, plain_ms)}."""
    import torch
    from sparsex_tpu_torch.ops import fused as tf

    far = ex.arrays["fused"]
    ncols, nrows = ex.ncols, ex.nrows
    D2R = tf._d2r(nrows)
    x2 = x.reshape(-1, 8, 128)          # 2^20 = 1024 whole pages
    (_T2, q2, _np2, _s2), _inter = fmeta[7]
    q = fmeta[1]
    res = {}

    k1_args = [(far["plo"], far["mg"], far["vals"], x2, q),
               (far["plo2"], far["mg2"], far["vals2"], x2, q2)]
    errs = []
    for args in k1_args:
        got = tf.k1(*args)
        torch.cuda.synchronize()
        errs.append(cmp("k1", dtype_name, got, tf.k1_plain(*args), True))
    pairs = [paired_ms(lambda a=a: tf.k1(*a), lambda a=a: tf.k1_plain(*a))
             for a in k1_args]
    res["k1"] = (max(errs), sum(k for k, _ in pairs),
                 sum(p for _, p in pairs))
    A1 = tf.fused_delta_a1(fmeta, far, x, ncols, x2=x2)
    e1s = []
    t1_err, k2_err, t1_t, k2_t = 0.0, 0.0, (0, 0), (0, 0)
    for i, m in enumerate(fmeta[3]):
        S1c, S1p, A2R, _D, _Dp, _K, W2, a0, a1 = m[:9]
        Ai = torch.nn.functional.pad(A1[a0:a1], (0, 0, 0, S1p - S1c))
        got = tf.t1(Ai, A2R)
        torch.cuda.synchronize()
        t1_err = max(t1_err, cmp("t1", dtype_name, got,
                                 tf.t1_plain(Ai, A2R), True))
        kp = paired_ms(lambda: tf.t1(Ai, A2R), lambda: tf.t1_plain(Ai, A2R))
        t1_t = (t1_t[0] + kp[0], t1_t[1] + kp[1])
        wires = (far[f"g2a_{i}"], far[f"g2b_{i}"], far[f"g2c_{i}"], W2, D2R)
        e1 = tf.k2(got, *wires)
        torch.cuda.synchronize()
        k2_err = max(k2_err, cmp("k2", dtype_name, e1,
                                 tf.k2_plain(got, *wires), True))
        kp = paired_ms(lambda: tf.k2(got, *wires),
                       lambda: tf.k2_plain(got, *wires))
        k2_t = (k2_t[0] + kp[0], k2_t[1] + kp[1])
        e1s.append(e1)
    res["t1"] = (t1_err,) + t1_t
    res["k2"] = (k2_err,) + k2_t
    g3s = [far[f"g3_{i}"] for i in range(len(fmeta[3]))]
    dia_offs, anti_offs = k3dias
    if anti_offs:
        fail("the headline plan is expected to hold no anti-diagonals")
    xb = tf._to_blocks(x)[0]
    k3_args = (e1s, g3s, ex.arrays.get("dias_fused_dv"), tuple(dia_offs),
               None, (), xb, None, ncols, D2R)
    got = tf.k3(*k3_args)
    torch.cuda.synchronize()
    res["k3"] = (cmp("k3", dtype_name, got, tf.k3_plain(*k3_args),
                         False),) + paired_ms(
        lambda: tf.k3(*k3_args), lambda: tf.k3_plain(*k3_args))
    say_kernels(res, dtype_name)
    return res


def say_kernels(res, label):
    for name, (err, ms, pms) in res.items():
        say(f"kernel {name} [{label}]: max abs err {err:.3e}"
            + ("" if ms is None else
               f"; {ms * 1e3:.2f} us vs plain {pms * 1e3:.2f} us per SpMV, "
               "each replayed alone (inputs warm in L2)"))


def check_blocky_plan(mat, label):
    """The blocky plan: the delta pipeline and the rlp8 and rlp2 fused run
    tables in one merged route plan."""
    ex = mat.csx.executors[0]
    extras = extras_of(ex.meta)
    runs = fused_runs(ex.meta)
    styles = {m[5] for _, m in runs}
    if ("dfused" not in extras or "fall" not in extras
            or not {"rlp2", "rlp8"} <= styles):
        fail(f"[{label}] plan holds {sorted(extras)} and fused run styles "
             f"{sorted(styles)}, expected dfused + fall with rlp8 and rlp2")
    fmeta = extras["dfused"][0]
    segs, inst, _bounds, res_desc = extras["fall"]
    say(f"[{label}] plan: delta T={fmeta[0]} q={fmeta[1]} style={fmeta[6]}"
        f" tail={fmeta[7][0] if len(fmeta) > 7 and fmeta[7] else None}; "
        "fused runs "
        f"{[(ri, m[0], m[1], m[5], m[4]) for ri, m in runs]}; merged "
        f"segments {segs}; instances {[m[:10] for m in inst]}; residuals "
        f"{res_desc}")
    return ex, fmeta, runs, extras["fall"]


def check_kernel(res, label, timed, name, fn, plain, args, exact=True):
    """``fn`` (a kernel wrapper) against ``plain`` on each argument tuple in
    ``args``; ``res[name]`` = (max abs err, kernel ms, plain ms) summed over
    the calls, the times None when not ``timed``.  Returns the kernel's
    outputs."""
    outs = [fn(*a) for a in args]
    errs = [cmp(name, label, o, plain(*a), exact)
            for o, a in zip(outs, args)]
    if not timed:
        res[name] = (max(errs), None, None)
        return outs
    pairs = [paired_ms(lambda a=a: fn(*a), lambda a=a: plain(*a))
             for a in args]
    res[name] = (max(errs), sum(k for k, _ in pairs),
                 sum(p for _, p in pairs))
    return outs


def blocky_kernel_phase(ex, fmeta, runs, fall, x, label, timed=True):
    """Every kernel of the blocky path against its plain version, on the
    plan's arrays at the main path's shapes: K1 lp on the delta bulk and
    tail, K1 rlp on each fused run table, then per merged instance the lane
    gather, T1 and K2 (raw g2b wires where um & 1), and the one K3 over all
    instances (masked g3 where um & 2 is 0).  Each stage takes the previous
    kernel's output.  Returns {name: (max_abs_err, ms, plain_ms)}, the
    times None when not ``timed``."""
    import torch.nn.functional as F
    from sparsex_tpu_torch.ops import fused as tf
    from sparsex_tpu_torch.ops import kernels as tk
    from sparsex_tpu_torch.ops import route as troute

    ncols = ex.ncols
    D2R = tf._d2r(ex.nrows)
    x2f = tk.shared_page_grid(ex.meta, x, ncols)
    res = {}

    def run(name, fn, plain, args, exact=True):
        return check_kernel(res, label, timed, name, fn, plain, args, exact)

    far = ex.arrays["fused"]
    parts = [("", fmeta[1], fmeta[2], fmeta[6])]          # bulk (and tail)
    if len(fmeta) > 7 and fmeta[7] is not None:
        parts.append(("2",) + tuple(fmeta[7][0][1:4]))
    # one page grid for both parts, as fused_delta_a1 shares it
    x2 = tf._k1_x2(x, ncols, max(p[1] for p in parts),
                   max(p[2] for p in parts), x2f)
    run("k1", tf.k1, tf.k1_plain,
        [(far["plo" + s], far["mg" + s], far["vals" + s], x2, q, style)
         for s, q, _np, style in parts])
    k1_args = []
    for ri, m in runs:
        fr = ex.arrays["runs"][ri]["frun"]
        k1_args.append((fr["plo"], fr["mg"], fr["vals"],
                        tf._k1_x2(x, ncols, m[1], m[2], x2f), m[1], m[5]))
    run("k1_rlp", tf.k1, tf.k1_plain, k1_args)

    # the merged plan's source grid, built as local_contrib builds it
    A1g = tk.merged_source(ex.meta, ex.arrays, x, ncols, x2f)
    fa, inst = ex.arrays["fall"], fall[1]
    a1s = run("lane_gather", troute.lane_gather, troute.lane_gather_plain,
              [(F.pad(A1g[m[7]:m[8]], (0, 0, 0, m[1] - m[0])).contiguous(),
                fa[f"g1_{i}"][None]) for i, m in enumerate(inst)])
    a1ts = run("t1", tf.t1, tf.t1_plain,
               [(a1, m[2]) for a1, m in zip(a1s, inst)])
    e1s = run("k2", tf.k2, tf.k2_plain,
              [(a1t, fa[f"g2a_{i}"], fa[f"g2b_{i}"], fa[f"g2c_{i}"], m[6],
                D2R) for i, (a1t, m) in enumerate(zip(a1ts, inst))])
    if "k3dias" in extras_of(ex.meta):
        fail(f"[{label}] the blocky plan is expected to hold no DIA tables")
    step = tf.MAX_INSTANCES
    run("k3", tf.k3, tf.k3_plain,
        [(e1s[s:s + step], [fa[f"g3_{i}"] for i in range(s, min(
            s + step, len(inst)))], None, (), None, (), None, None, ncols,
          D2R) for s in range(0, len(inst), step)], exact=False)
    say_kernels(res, label)
    return res


def check_pages_plan(mat, kind, label):
    """The plans of the non-fused variants, as the reference planner makes
    them: ``hpcg`` the plain-table variant, one DIA table of 27 diagonals
    and nothing else; ``headline`` the paged delta stream (``dpages``, no
    scatter route) and one standalone DIA table of 5; ``blocky`` the paged
    delta stream with paged run and block tables."""
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


def pages_kernel_phase(ex, x, label, timed=True):
    """Each kernel of a non-fused path against its plain version, on the
    plan's arrays at the main path's shapes: the DIA kernel per standalone
    DIA table (in its zero-padded x frame), the delta-pages product over
    the shared page grid, the unit-page gather per paged table.  All three
    must be bit-equal.  Returns {name: (max_abs_err, ms, plain_ms)}."""
    from sparsex_tpu_torch.ops import kernels as tk
    from sparsex_tpu_torch.ops import pallas_kernels as tpk

    meta, arrs = ex.meta, ex.arrays
    nrows, ncols = ex.nrows, ex.ncols
    extras = extras_of(meta)
    res = {}
    if meta[4] and "k3dias" not in extras:
        args = []
        for offs, dv, xs in tk.dia_tables(meta[4], arrs["dias"], x, ncols):
            xp, pad_lo = tpk.dia_frame(offs, xs, nrows, ncols)
            args.append((dv, xp, offs, pad_lo))
        check_kernel(res, label, timed, "dia", tpk.dia, tpk.dia_plain, args)
    x2 = tk.paged_grid(meta, x, ncols)
    if "dpages" in extras:
        rep = arrs["delta_pages"]
        check_kernel(res, label, timed, "delta_pages", tpk.delta_pages,
                     tpk.delta_pages_plain, [(rep["plo"], rep["sl"],
                                              rep["vals"], x2,
                                              extras["dpages"][1])])
    args = [(arrs[kind][i]["plan"]["plo"], arrs[kind][i]["plan"]["sl"], x2,
             e[3][1]) for kind, i, e in paged_tables(meta)]
    if args:
        check_kernel(res, label, timed, "paged_gather", tpk.gather,
                     tpk.gather_plain, args)
    say_kernels(res, label)
    return res


def e2e_phase(spx, tf, mat, rows, cols, vals, x, tol, dtype_name,
              timed=True):
    """Two SpMVs through matvec_kernel against the float64 COO oracle, with
    the launch counts of that run; returns (counts, ms per SpMV called
    from Python, host ms to enqueue one, ms per SpMV replayed from a CUDA
    graph, oracle errors, the timed SpMV call); the times are None when
    not ``timed``."""
    import torch
    import bench

    n = mat.nrows
    xh = x.double().cpu().numpy()
    # float64 COO oracle
    want = np.bincount(rows, weights=vals.astype(np.float64) * xh[cols],
                       minlength=n)
    y0 = np.random.default_rng(2).standard_normal(n)
    y0d = torch.as_tensor(y0, dtype=x.dtype, device=x.device)
    want2 = 2.0 * want + 0.5 * y0d.double().cpu().numpy()
    tf.launches.clear()
    y = spx.matvec_kernel(1.0, mat, x, 0.0, None)
    y2 = spx.matvec_kernel(2.0, mat, x, 0.5, y0d)
    torch.cuda.synchronize()
    counts = tf.launch_counts()
    expect = {k: 2 * v for k, v in expected_counts(
        mat.csx.executors[0].meta).items()}
    if counts != expect:
        fail(f"[{dtype_name}] launch counts {counts} over two SpMVs, "
             f"expected {expect}")
    errs = []
    for got, ref in ((y, want), (y2, want2)):
        g = got.double().cpu().numpy()
        if g.shape != (n,) or not np.isfinite(g).all():
            fail(f"[{dtype_name}] SpMV result has shape {g.shape} or "
                 "non-finite values")
        errs.append(bench._mixed_rel_err(g, ref))
    say(f"spmv [{dtype_name}]: oracle rel err {errs[0]:.3e} (alpha=1, "
        f"beta=0), {errs[1]:.3e} (alpha=2, beta=0.5); bar {tol:g}; "
        f"launches per 2 SpMVs {counts}")
    if not max(errs) < tol:
        fail(f"[{dtype_name}] SpMV diverges from the oracle: {errs} vs "
             f"{tol:g}")
    def spmv():
        return spx.matvec_kernel(1.0, mat, x, 0.0, None)

    if not timed:
        return counts, None, None, None, errs, spmv
    ms = cuda_time_ms(spmv)
    # host time to enqueue one SpMV (no synchronisation inside the loop):
    # when it is close to ``ms`` the end-to-end time is set by the host
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LOOPS):
        spmv()
    host_ms = (time.perf_counter() - t0) * 1e3 / LOOPS
    torch.cuda.synchronize()
    return counts, ms, host_ms, graph_time_ms(spmv), errs, spmv


_KERNEL_NAME = re.compile(r"\b(k1_lp|k1_rlp|t1|k2|k3|lane_gather|dia|"
                          r"delta_pages|paged_gather)_kernel\b")


def profile_phase(spmv, reps=50):
    """Device microseconds per SpMV of each kernel and of the PyTorch glue
    kernels (pads, the hybrid interleave, the residual adds), from a
    torch.profiler trace of ``reps`` SpMVs: the kernels as the main path
    runs them, each finding in L2 what the previous one left.  Returns
    ``(us, glue)``, ``glue`` the four largest glue kernels by name, or
    ``(None, None)`` when the trace holds no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    spmv()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            spmv()
        torch.cuda.synchronize()
    from sparsex_tpu_torch.ops.fused import KERNELS
    us = dict.fromkeys(KERNELS + ("glue",), 0.0)
    glue = {}
    seen = False
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        seen = True
        m = _KERNEL_NAME.search(ev.name)
        key = ("k1" if m.group(1) == "k1_lp" else m.group(1)) if m else "glue"
        us[key] += ev.time_range.elapsed_us() / reps
        if not m:
            name = ev.name[:70]
            glue[name] = (glue.get(name, 0.0)
                          + ev.time_range.elapsed_us() / reps)
    if not seen:
        return None, None
    return us, sorted(glue.items(), key=lambda kv: -kv[1])[:4]


def report(label, mat, res, timing, profiled):
    """Print the profile and end-to-end lines of one timed path; returns
    its summary."""
    counts, ms, host_ms, graph_ms, errs, _spmv = timing
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
    gnnz = mat.nnz / (ms * 1e-3) / 1e9
    dev_ms = sum(r[1] for r in res.values())
    say(f"[{label}] SpMV end to end: {ms * 1e3:.2f} us ({gnnz:.2f} Gnnz/s) "
        f"called from Python, host enqueue {host_ms * 1e3:.2f} us; "
        f"{graph_ms * 1e3:.2f} us "
        f"({mat.nnz / (graph_ms * 1e-3) / 1e9:.2f} Gnnz/s) replayed from a "
        f"CUDA graph; the checked kernels alone {dev_ms * 1e3:.2f} us")
    return {"us_per_spmv": ms * 1e3, "gnnz_per_s": gnnz,
            "host_enqueue_us": host_ms * 1e3,
            "graph_us_per_spmv": graph_ms * 1e3,
            "kernel_us": dev_ms * 1e3, "oracle_rel_err": errs,
            "launches_per_2_spmv": counts, "profile_device_us": prof,
            "profile_glue_us": glue}


def kernel_entries(res, counts, prof, label):
    return [{"name": f"{name}[{label}]", "route": "cuda",
             "source": SOURCE.get(name, FUSED_SOURCE),
             "replaces": REPLACES[name], "launches": counts[name],
             "max_abs_err": err, "ms": kms, "plain_ms": pms,
             "ms_in_spmv": None if prof is None else prof[name] * 1e-3}
            for name, (err, kms, pms) in res.items()]


def x_for(mat, n, dtype_name):
    import torch
    return torch.as_tensor(
        np.random.default_rng(1).standard_normal(n),
        dtype=torch.float32 if dtype_name == "float32" else torch.float64,
        device=mat.device)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    try:
        import bench
        import sparsex_tpu_torch as spx
        from sparsex_tpu_torch.ops import _build
        from sparsex_tpu_torch.ops import fused as tf
    except ImportError as e:
        fail(f"cannot import the repository ({e}); run from its root")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        fail("jax was imported")

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
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas: " + line.strip(), file=sys.stderr)

    tols = (("float32", bench.CHECK_TOL), ("float64", 1e-6))
    kernels_out, summary = [], {}
    # --- the headline path: fused delta pipeline + DIA in K3 ---
    rows, cols, vals = bench.build_matrix(N)
    warm_up()
    for dtype_name, tol in tols:
        mat = tune(spx, rows, cols, vals, N, dtype_name, dtype_name)
        ex, fmeta, k3dias = check_plan(mat)
        x = x_for(mat, N, dtype_name)
        res = kernel_phase(ex, fmeta, k3dias, x, dtype_name)
        timing = e2e_phase(spx, tf, mat, rows, cols, vals, x, tol,
                           dtype_name)
        profiled = profile_phase(timing[-1])
        summary[dtype_name] = report(dtype_name, mat, res, timing, profiled)
        kernels_out += kernel_entries(res, timing[0], profiled[0],
                                      dtype_name)
        del mat, ex, x, timing
        torch.cuda.empty_cache()

    # --- the blocky path: fused runs (K1 rlp) + the merged route plan ---
    rows, cols, vals = bench.build_blocky_matrix(N_BLOCKY)
    for dtype_name, tol in tols:
        label = f"blocky {dtype_name}"
        mat = tune(spx, rows, cols, vals, N_BLOCKY, dtype_name, label)
        ex, fmeta, runs, fall = check_blocky_plan(mat, label)
        x = x_for(mat, N_BLOCKY, dtype_name)
        res = blocky_kernel_phase(ex, fmeta, runs, fall, x, label)
        timing = e2e_phase(spx, tf, mat, rows, cols, vals, x, tol, label)
        profiled = profile_phase(timing[-1])
        summary[label] = report(label, mat, res, timing, profiled)
        kernels_out += kernel_entries(res, timing[0], profiled[0], label)
        del mat, ex, x, timing
        torch.cuda.empty_cache()
    # bench.py's own size, untimed: its merged plan has a masked instance
    rows, cols, vals = bench.build_blocky_matrix(N_BLOCKY_CHECK)
    label = "blocky 2^19 float32"
    mat = tune(spx, rows, cols, vals, N_BLOCKY_CHECK, "float32", label)
    ex, fmeta, runs, fall = check_blocky_plan(mat, label)
    if all(m[9] & 2 for m in fall[1]):
        fail(f"[{label}] no merged instance with a masked g3 (um & 2 == 0)")
    x = x_for(mat, N_BLOCKY_CHECK, "float32")
    blocky_kernel_phase(ex, fmeta, runs, fall, x, label, timed=False)
    e2e_phase(spx, tf, mat, rows, cols, vals, x, bench.CHECK_TOL, label,
              timed=False)

    # --- the non-fused variants: the HPCG stencil (plain tables, one DIA
    # table) and the two bench matrices past the fused planners' 2^21-row
    # cap (legacy paged variant: delta pages, DIA, paged gathers) ---
    for kind, label0, build in (
            ("hpcg", "hpcg 128^3", lambda: hpcg_matrix(HPCG_NX)),
            ("headline", "headline 2^22",
             lambda: (N_BIG,) + tuple(bench.build_matrix(N_BIG))),
            ("blocky", "blocky 2^22",
             lambda: (N_BIG,) + tuple(bench.build_blocky_matrix(N_BIG)))):
        n, rows, cols, vals = build()
        for dtype_name, tol in tols:
            label = f"{label0} {dtype_name}"
            mat = tune(spx, rows, cols, vals, n, dtype_name, label)
            ex = check_pages_plan(mat, kind, label)
            x = x_for(mat, n, dtype_name)
            res = pages_kernel_phase(ex, x, label)
            timing = e2e_phase(spx, tf, mat, rows, cols, vals, x, tol,
                               label)
            profiled = profile_phase(timing[-1])
            summary[label] = report(label, mat, res, timing, profiled)
            kernels_out += kernel_entries(res, timing[0], profiled[0],
                                          label)
            del mat, ex, x, timing
            torch.cuda.empty_cache()
        del rows, cols, vals

    say("summary: " + json.dumps(summary))
    say(card)
    say(json.dumps({"kernels": kernels_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
