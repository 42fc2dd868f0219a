#!/usr/bin/env python3
"""Weak-scaling harness of sparsex_tpu_torch: nnz grows with the ranks.

The counterpart of ``tools/weak_scaling.py`` on the PyTorch port.  For each
N of ``--devices`` the matrix of ``--base-n`` * N rows (the reference's
``build``: 4 diagonals and n/2 random singles) is tuned on the host in N
shards (``spx.rt.nr_threads`` = N, ``spx.tpu.x_mode`` = ``--mode``) and run
by ``parallel.shard.ShardedCsx`` on N ranks (``parallel.comm.run_ranks``,
one process a rank): its y against the float64 COO oracle (the mixed
relative error ``ops.oracle.mixed_rel_err`` under 2e-4, else exit 1),
then ``--loops`` chained renormed SpMVs on the host clock with every rank
barrier-synchronised before and after.

    python3 tools/weak_scaling_torch.py --devices 1 2 4 --mode halo
    python3 tools/weak_scaling_torch.py --devices 1 2 --device cpu

Efficiency = t(first N) / t(N).  One backend serves the whole run, so that
the points compare: NCCL, a GPU a rank, when the machine has at least the
largest N GPUs; else gloo for every N, every rank on ``--device`` (default
``cuda:0``; ``cpu`` for the CPU), each exchange through host memory.  gloo
on one card validates the sharded build, run and numerics at every N; its
efficiency is NOT a scaling result (the JSON's ``note`` says so), as the
reference's CPU mesh is not TPU performance.  ``--mesh DxI`` is accepted
for the reference's flag list and changes nothing: the port has no 2-D
axis, and the ranks keep the launcher's order.  Run it as a script: the spawned ranks import it by its path.
Exits 2 without the CUDA device asked for or on a malformed
``--device``.
"""

import argparse
import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(n, seed=0):
    """The reference's weak-scaling matrix (tools/weak_scaling.py:30)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for b in (0, 1, -1, 8):
        r = np.arange(max(0, -b), min(n, n - b), dtype=np.int64)
        rows.append(r)
        cols.append(r + b)
    rows.append(rng.integers(0, n, n // 2))
    cols.append(rng.integers(0, n, n // 2))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    _, u = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = (rng.standard_normal(rows.size) * 0.1).astype(np.float32)
    return rows, cols, vals


def rank_body(rank, case_path, out_path):
    """One rank (spawned): its ``ShardedCsx``, one SpMV (rank 0 keeps y),
    a warm chain, then a chain of ``loops`` timed between barriers."""
    import torch
    import torch.distributed as dist

    import sparsex_tpu_torch as spx
    from sparsex_tpu_torch.parallel.shard import ShardedCsx, host_matrix
    with open(case_path, "rb") as fp:
        case = pickle.load(fp)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2
                              // dist.get_world_size()))
    cfg = spx.Config.reset()
    for key, value in case["options"]:
        cfg.set(key, value)
    dev = torch.device(case["devices"][rank])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sh = ShardedCsx(host_matrix(case["host"]), device=dev)
    x = torch.as_tensor(case["x"], device=dev)
    y = sh.matvec(x)

    def chain():
        c = x
        for _ in range(case["loops"]):
            v = sh.matvec(c)
            c = v * torch.rsqrt(torch.mean(v * v) + 1e-20)
        return c

    chain()
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    chain()
    sync()
    dist.barrier()
    dt = (time.perf_counter() - t0) / case["loops"]
    if rank == 0:
        with open(out_path, "wb") as fp:
            pickle.dump({"y": y.double().cpu().numpy(), "dt": dt,
                         "x_mode": sh.x_mode, "halo_k": sh.halo_k}, fp)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--base-n", type=int, default=1 << 15,
                    help="rows per rank (weak scaling)")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "replicated", "halo"])
    ap.add_argument("--mesh", default="",
                    help="DxI: accepted and ignored (the port has no 2-D "
                         "axis)")
    ap.add_argument("--loops", type=int, default=16)
    ap.add_argument("--json", default="",
                    help="write structured results to this path")
    ap.add_argument("--device", default="cuda:0",
                    help="gloo's device for every rank: cuda:N (default "
                         "cuda:0) or cpu")
    args = ap.parse_args(argv)

    import torch

    import sparsex_tpu_torch as spx
    from sparsex_tpu_torch.device import resolve_device
    from sparsex_tpu_torch.errors import SparsexError
    from sparsex_tpu_torch.ops.oracle import coo_spmv, mixed_rel_err
    from sparsex_tpu_torch.parallel.comm import run_ranks
    from sparsex_tpu_torch.parallel.shard import host_from_coo
    try:
        dev = resolve_device(args.device)
    except (SparsexError, RuntimeError) as e:   # no CUDA; a bad --device
        print(f"ERROR: --device {args.device}: {e}", file=sys.stderr)
        return 2
    want_n = max(args.devices)
    nccl = dev.type == "cuda" and torch.cuda.device_count() >= want_n
    backend = "nccl" if nccl else "gloo"
    plat = dev.type
    if nccl:
        note = "NCCL, a GPU a rank"
    else:
        note = (f"gloo, every rank on {dev} "
                + ("(one GPU shared by the ranks)" if plat == "cuda"
                   else "(the host's cores shared by the ranks)")
                + ", each exchange through host memory: validates the "
                "sharded build, run and numerics; the efficiency is NOT a "
                "scaling result")
    print(f"backend: {backend} on {dev}; {note}")
    if args.mesh:
        print(f"--mesh {args.mesh}: ignored (no 2-D axis; the ranks keep "
              "the launcher's order)")

    results = []
    for nd in args.devices:
        cfg = spx.Config.reset()
        cfg.set("spx.tpu.value_dtype", "float32")
        cfg.set("spx.preproc.xform", "all")
        cfg.set("spx.rt.nr_threads", str(nd))
        cfg.set("spx.tpu.x_mode", args.mode)
        options = [(k, cfg.get(k)) for k in
                   ("spx.tpu.value_dtype", "spx.preproc.xform",
                    "spx.rt.nr_threads", "spx.tpu.x_mode")]
        n = args.base_n * nd
        rows, cols, vals = build(n)
        x_np = np.random.default_rng(1).standard_normal(n).astype(
            np.float32)
        case = {"options": options, "x": x_np, "loops": args.loops,
                "host": host_from_coo(n, n, rows, cols, vals, cfg, nd),
                "devices": [f"cuda:{r}" if nccl else str(dev)
                            for r in range(nd)]}
        with tempfile.TemporaryDirectory(prefix="spx_weak_") as td:
            case_path = os.path.join(td, "case.pkl")
            with open(case_path, "wb") as fp:
                pickle.dump(case, fp)
            del case
            out_path = os.path.join(td, "out.pkl")
            run_ranks(rank_body, nd, (case_path, out_path), backend=backend)
            with open(out_path, "rb") as fp:
                out = pickle.load(fp)

        # correctness at every N vs the float64 COO oracle
        y_ref = coo_spmv(n, rows, cols, vals.astype(np.float64),
                         x_np.astype(np.float64))
        rel = mixed_rel_err(out["y"], y_ref)
        if not rel < 2e-4:
            print(f"ERROR: devices={nd} rel err {rel:.3e}", file=sys.stderr)
            return 1
        dt = out["dt"]
        results.append((nd, int(rows.size), dt, out["x_mode"], rel))
        print(f"devices={nd:2d} nnz={rows.size:>9d} "
              f"x_mode={out['x_mode']:10s} {dt * 1e6:9.1f} us/SpMV "
              f"rel={rel:.1e}")

    t1 = results[0][2]
    for nd, _nnz, dt, _mode, _rel in results[1:]:
        print(f"weak-scaling efficiency @ {nd} devices: {100 * t1 / dt:.0f}%")

    if args.json:
        out = {
            "platform": plat, "backend": backend, "note": note,
            "mode": args.mode, "base_n": args.base_n,
            "points": [
                {"devices": nd, "nnz": nnz, "us_per_spmv": dt * 1e6,
                 "x_mode": mode, "rel_err": rel,
                 "efficiency_vs_1dev": t1 / dt}
                for nd, nnz, dt, mode, rel in results
            ],
        }
        with open(args.json, "w") as fp:
            json.dump(out, fp, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
