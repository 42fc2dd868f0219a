"""Smoke test of sparsex_tpu_torch on one CUDA GPU (written for an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``sparsex_tpu_torch/csrc`` and drives the
port's main path on the card at full width: the headline bench matrix
(``bench.build_matrix(1 << 20)``: 2^20 rows, 5.77M nonzeros) tuned with
``sparsex_tpu_torch.mat_tune`` and multiplied with ``matvec_kernel``, in
float32 and float64.  Every phase is fatal on failure:

1. the device, torch / CUDA versions and the kernel build time;
2. tuning, with the plan checked to hold the fused delta pipeline with a
   hybrid tail and the DIA tables riding K3;
3. each kernel (K1 bulk and tail, T1, K2, K3) against its plain PyTorch
   version on that plan's arrays: K1, T1 and K2 bit-equal, K3 within 1e-6
   of the largest value (its sums are ordered as the plain version's, but
   the bar leaves room for the order to change);
4. the SpMV end to end against a float64 COO oracle (``bench.CHECK_TOL``
   in float32, 1e-6 in float64), with the launch counts showing that each
   kernel ran on that path;
5. CUDA-event times, median over 5 runs of 128 calls after a warm-up:
   the SpMV end to end as a Python caller gets it, the host's time to
   enqueue one, and the SpMV replayed from a CUDA graph (device time);
   each kernel and its plain version replayed from CUDA graphs, in the
   order plain, kernel, kernel, plain (one kernel alone, 128 times in a
   row: its inputs stay warm in L2);
6. a torch.profiler trace of 50 SpMVs: each kernel's device time inside
   the real SpMV, the PyTorch glue kernels around them, and the share of
   the called-from-Python time the device is busy.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
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
SOURCE = "sparsex_tpu_torch/csrc/fused.cu"
REPLACES = {
    "k1": "sparsex_tpu/ops/fused.py:962",
    "t1": "sparsex_tpu/ops/fused.py:1317",
    "k2": "sparsex_tpu/ops/fused.py:1143",
    "k3": "sparsex_tpu/ops/fused.py:1372",
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


def check_plan(mat):
    ex = mat.csx.executors[0]
    extras = {e[0]: e[1:] for e in ex.meta[5:] if e}
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

    def cmp(name, got, want, exact):
        err = (got.double() - want.double()).abs().max().item()
        scale = want.double().abs().max().item()
        if exact and not torch.equal(got, want):
            fail(f"{name} [{dtype_name}]: not bit-equal to its plain "
                 f"version (max abs err {err:.3e})")
        if not exact and not err <= 1e-6 * scale:
            fail(f"{name} [{dtype_name}]: max abs err {err:.3e} > 1e-6 x "
                 f"{scale:.3e}")
        return err

    k1_args = [(far["plo"], far["mg"], far["vals"], x2, q),
               (far["plo2"], far["mg2"], far["vals2"], x2, q2)]
    errs = []
    for args in k1_args:
        got = tf.k1(*args)
        torch.cuda.synchronize()
        errs.append(cmp("k1", got, tf.k1_plain(*args), True))
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
        t1_err = max(t1_err, cmp("t1", got, tf.t1_plain(Ai, A2R), True))
        kp = paired_ms(lambda: tf.t1(Ai, A2R), lambda: tf.t1_plain(Ai, A2R))
        t1_t = (t1_t[0] + kp[0], t1_t[1] + kp[1])
        wires = (far[f"g2a_{i}"], far[f"g2b_{i}"], far[f"g2c_{i}"], W2, D2R)
        e1 = tf.k2(got, *wires)
        torch.cuda.synchronize()
        k2_err = max(k2_err, cmp("k2", e1, tf.k2_plain(got, *wires), True))
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
    res["k3"] = (cmp("k3", got, tf.k3_plain(*k3_args), False),) + paired_ms(
        lambda: tf.k3(*k3_args), lambda: tf.k3_plain(*k3_args))
    for name, (err, ms, pms) in res.items():
        say(f"kernel {name} [{dtype_name}]: max abs err {err:.3e}; "
            f"{ms * 1e3:.2f} us vs plain {pms * 1e3:.2f} us per SpMV, each "
            "replayed alone (inputs warm in L2)")
    return res


def e2e_phase(spx, tf, mat, rows, cols, vals, x, fmeta, tol, dtype_name):
    """Two SpMVs through matvec_kernel against the float64 COO oracle, with
    the launch counts of that run; returns (counts, ms per SpMV called
    from Python, host ms to enqueue one, ms per SpMV replayed from a CUDA
    graph, oracle errors, the timed SpMV call)."""
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
    n_inst = len(fmeta[3])
    expect = {"k1": 4, "t1": 2 * n_inst, "k2": 2 * n_inst, "k3": 2}
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


_KERNEL_NAME = re.compile(r"\b(k1_lp|t1|k2|k3)_kernel\b")


def profile_phase(spmv, reps=50):
    """Device microseconds per SpMV of each kernel and of the PyTorch glue
    kernels (pads, the hybrid interleave, the residual adds), from a
    torch.profiler trace of ``reps`` SpMVs: the kernels as the main path
    runs them, each finding in L2 what the previous one left.  Returns
    None when the trace holds no device events."""
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
    us = {"k1": 0.0, "t1": 0.0, "k2": 0.0, "k3": 0.0, "glue": 0.0}
    seen = False
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        seen = True
        m = _KERNEL_NAME.search(ev.name)
        key = m.group(1)[:2] if m else "glue"
        us[key] += ev.time_range.elapsed_us() / reps
    return us if seen else None


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

    rows, cols, vals = bench.build_matrix(N)
    warm_up()
    kernels_out, summary = [], {}
    for dtype_name, tol in (("float32", bench.CHECK_TOL), ("float64", 1e-6)):
        cfg = spx.Config.reset()
        cfg.set("spx.tpu.value_dtype", dtype_name)
        cfg.set("spx.preproc.xform", "all")
        cfg.set("spx.preproc.sampling", "portion")
        t0 = time.perf_counter()
        mat = spx.mat_tune(csr_input(spx, rows, cols, vals, N))
        torch.cuda.synchronize()
        say(f"[{dtype_name}] mat_tune: {time.perf_counter() - t0:.2f} s, "
            f"{N}x{N}, nnz={mat.nnz}, on {mat.device}")
        ex, fmeta, k3dias = check_plan(mat)
        tdt = torch.float32 if dtype_name == "float32" else torch.float64
        x = torch.as_tensor(
            np.random.default_rng(1).standard_normal(N), dtype=tdt,
            device=mat.device)
        res = kernel_phase(ex, fmeta, k3dias, x, dtype_name)
        counts, ms, host_ms, graph_ms, errs, spmv = e2e_phase(
            spx, tf, mat, rows, cols, vals, x, fmeta, tol, dtype_name)
        prof = profile_phase(spmv)
        if prof is None:
            say(f"[{dtype_name}] profile: the trace holds no device events;"
                " in-SpMV kernel times not measured")
        else:
            dev_us = sum(prof.values())
            say(f"[{dtype_name}] profile (50 SpMVs): device "
                f"{dev_us:.2f} us per SpMV = "
                + ", ".join(f"{k} {v:.2f}" for k, v in prof.items())
                + f"; busy {100 * dev_us / (ms * 1e3):.1f}% of the "
                f"{ms * 1e3:.2f} us called from Python")
        gnnz = mat.nnz / (ms * 1e-3) / 1e9
        dev_ms = sum(r[1] for r in res.values())
        say(f"[{dtype_name}] SpMV end to end: {ms * 1e3:.2f} us "
            f"({gnnz:.2f} Gnnz/s) called from Python, host enqueue "
            f"{host_ms * 1e3:.2f} us; {graph_ms * 1e3:.2f} us "
            f"({mat.nnz / (graph_ms * 1e-3) / 1e9:.2f} Gnnz/s) replayed "
            f"from a CUDA graph; the four kernels alone "
            f"{dev_ms * 1e3:.2f} us")
        summary[dtype_name] = {"us_per_spmv": ms * 1e3, "gnnz_per_s": gnnz,
                               "host_enqueue_us": host_ms * 1e3,
                               "graph_us_per_spmv": graph_ms * 1e3,
                               "kernel_us": dev_ms * 1e3,
                               "oracle_rel_err": errs,
                               "profile_device_us": prof}
        for name, (err, kms, pms) in res.items():
            kernels_out.append({
                "name": f"{name}[{dtype_name}]", "route": "cuda",
                "source": SOURCE, "replaces": REPLACES[name],
                "launches": counts[name], "max_abs_err": err,
                "ms": kms, "plain_ms": pms,
                "ms_in_spmv": None if prof is None else prof[name] * 1e-3})
        del mat, ex, x
        torch.cuda.empty_cache()

    say("summary: " + json.dumps(summary))
    say(card)
    say(json.dumps({"kernels": kernels_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
