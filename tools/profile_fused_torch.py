#!/usr/bin/env python3
"""Per-kernel device-time budget of a bench workload, on sparsex_tpu_torch.

The counterpart of ``tools/profile_fused.py`` on the PyTorch port: tunes
one of bench.py's four workloads (builders copied in ``chip_smoke.py``,
sizes from ``BENCH_N`` / ``BENCH_N_BLOCKY`` / ``BENCH_N_SYM`` /
``BENCH_N_DIAGC`` with bench.py's defaults, 2^20 / 2^19 / 2^20 / 2^19
rows) under bench.py's config (float32, ``xform=all``,
``sampling=portion``), runs ``--iters`` chained renormed SpMVs (or SpMMs of
width ``--spmm K``) under torch.profiler and sums the device events per
name per iteration, the best of ``--reps`` traces: each of our kernels
under its launch-count key (``k1``, ``t1``, ``k2``, ``k3``, ...; the
executor's CUDA graph replays show their kernels), every other kernel or
copy (the PyTorch glue) under its own name.  Beside that total it prints
the chain's µs per iteration from CUDA events, so a reader sees how much
of the time the budget covers (the rest: gaps while the host enqueues).

    python3 tools/profile_fused_torch.py --workload blocky --json P.json
    python3 tools/profile_fused_torch.py --workload diagc --device cpu

``symmetric`` is bench.py's CSX-Sym matrix through
``symmetric.build_symmetric_csx`` (``spx.tpu.sym_full=auto``: the full
mirror on the card).  With ``--device cpu`` the budget is the CPU ops'
self times and the chain is on the host clock, and the output says
``cpu``.  ``--json`` adds ``{workload: {nnz, total_us_per_iter, kernels,
chain_us_per_iter, platform}}`` to the file (``PROFILE_r05.json``'s
format plus the last two keys; an SpMM under ``"<workload> spmm k=K"``).
Exits 1 when the trace holds no events, 2 without the CUDA device asked
for or on a malformed ``--device``.
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

WORKLOADS = ("headline", "blocky", "symmetric", "diagc")


def sizes():
    """Each workload's builder and rows, from bench.py's environment
    variables and defaults (bench.py:38-41)."""
    env = os.environ.get
    return {
        "headline": (cs.build_matrix, int(env("BENCH_N", str(1 << 20)))),
        "blocky": (cs.build_blocky_matrix,
                   int(env("BENCH_N_BLOCKY", str(1 << 19)))),
        "symmetric": (cs.build_symmetric_matrix,
                      int(env("BENCH_N_SYM", str(1 << 20)))),
        "diagc": (cs.build_diagc_matrix,
                  int(env("BENCH_N_DIAGC", str(1 << 19)))),
    }


def build(workload, iters, device, spmm_k=0):
    """(chain, nnz): ``chain()`` runs ``iters`` renormed SpMVs (SpMMs of
    ``spmm_k`` columns) of the tuned workload from a seeded x."""
    import torch

    import sparsex_tpu_torch as spx
    from sparsex_tpu_torch.csx import CsxMatrix
    from sparsex_tpu_torch.symmetric import build_symmetric_csx

    cfg = spx.Config.reset()
    cfg.set("spx.tpu.value_dtype", "float32")
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "portion")
    if os.environ.get("SPX_SB_PAGES"):
        cfg.set("spx.tpu.sb_pages", os.environ["SPX_SB_PAGES"])
    builder, n = sizes()[workload]
    rows, cols, vals = builder(n)
    make = build_symmetric_csx if workload == "symmetric" else \
        CsxMatrix.from_coo
    mat = make(n, n, rows, cols, vals, config=cfg, device=device)
    shape = (n, spmm_k) if spmm_k else (n,)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(shape)
                        .astype(np.float32), device=mat.device)
    op = mat.matmat if spmm_k else mat.matvec

    def chain():
        c = x
        for _ in range(iters):
            y = op(c)
            c = y * torch.rsqrt(torch.mean(y * y) + 1e-20)
        return c

    return chain, rows.size


def chain_us(chain, iters, reps, cuda):
    """The median over ``reps`` of one chain's µs per iteration: CUDA
    events around it on the card, the host clock on the CPU."""
    import torch
    ts = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            chain()
            ts.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(ts) / iters


def cpu_self_us(fn):
    """{CPU op: self µs} of one call of ``fn`` (after one outside the
    trace): ops nest, their self times do not overlap.  None when the
    trace holds no op."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {ev.key: ev.self_cpu_time_total for ev in prof.key_averages()
            if ev.self_cpu_time_total > 0} or None


def trace_budget(chain, iters, reps, cuda, kb=False):
    """{name: µs per iteration}, the trace of least total of ``reps``
    (each of one chain; the device's events, ``chip_smoke.trace_us``, or
    on the CPU each op's self time): our kernels under their launch-count
    keys (``chip_smoke.kernel_key``), every other event under its name."""
    best_total, best = None, None
    for _ in range(reps):
        agg = cs.trace_us(chain, 1) if cuda else cpu_self_us(chain)
        if not agg:
            continue
        budget = {}
        for name, us in agg.items():
            key = cs.kernel_key(name, kb) or name[:90]
            budget[key] = budget.get(key, 0.0) + us / iters
        total = sum(budget.values())
        if best_total is None or total < best_total:
            best_total, best = total, budget
    return best


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", default="headline", choices=WORKLOADS)
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=24)
    ap.add_argument("--spmm", type=int, default=0, metavar="K",
                    help="profile the SpMM (matmat) chain at width K")
    ap.add_argument("--json", default=None,
                    help="add {workload: budget} into this JSON file")
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:N (default cuda:0) or cpu")
    args = ap.parse_args(argv)

    import torch

    from sparsex_tpu_torch.device import resolve_device
    from sparsex_tpu_torch.errors import SparsexError
    try:
        dev = resolve_device(args.device)
    except (SparsexError, RuntimeError) as e:   # no CUDA; a bad --device
        print(f"ERROR: --device {args.device}: {e}", file=sys.stderr)
        return 2
    cuda = dev.type == "cuda"
    plat = "cuda" if cuda else "cpu"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    print(f"device: {dev} ({name}) platform={plat}")

    t0 = time.perf_counter()
    chain, nnz = build(args.workload, args.iters, dev, spmm_k=args.spmm)
    chain()   # kernel build, the executor's graph capture
    if cuda:
        torch.cuda.synchronize(dev)
    key = args.workload + (f" spmm k={args.spmm}" if args.spmm else "")
    print(f"[{args.workload}] nnz={nnz} built+compiled "
          f"in {time.perf_counter() - t0:.1f}s"
          + (f" (spmm k={args.spmm})" if args.spmm else ""))
    budget = trace_budget(chain, args.iters, args.reps, cuda,
                          kb=bool(args.spmm))
    if budget is None:
        print("no trace events captured", file=sys.stderr)
        return 1
    total = sum(budget.values())
    per_iter = chain_us(chain, args.iters, args.reps, cuda)
    print(f"[{key}] {'device' if cuda else 'cpu'} total: {total:.1f} "
          f"us/iter; the chain {per_iter:.1f} us/iter "
          f"({'CUDA events' if cuda else 'host clock'}): the budget covers "
          f"{100 * total / per_iter:.1f}%")
    for name, us in sorted(budget.items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"  {us:9.2f} us  {100 * us / total:5.1f}%  {name}")
    if args.json:
        data = {}
        if os.path.exists(args.json):
            with open(args.json) as fh:
                data = json.load(fh)
        data[key] = {
            "nnz": int(nnz), "total_us_per_iter": round(total, 2),
            "kernels": {k: round(v, 2) for k, v in
                        sorted(budget.items(), key=lambda kv: -kv[1])},
            "chain_us_per_iter": round(per_iter, 2), "platform": plat,
        }
        with open(args.json, "w") as fh:
            json.dump(data, fh, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
