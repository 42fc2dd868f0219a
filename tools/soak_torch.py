#!/usr/bin/env python3
"""End-to-end soak of sparsex_tpu_torch: every major path on one device.

The counterpart of ``tools/soak.py`` on the PyTorch port: the same mixed
matrix (diagonals, width-8 runs, 4x2 blocks and random singles, float32)
through the single-device SpMV, the SpMM (k = 4), ``persist.save_csx`` /
``restore_csx`` with its layouts, ``parallel.shard.ShardedCsx`` with x
replicated and with a halo ring (``min(4, devices)`` ranks, one process a
rank, ``parallel.comm.run_ranks``), the symmetric SpMV, ``solvers.cg`` and
``block_cg`` on an s.p.d. tridiagonal system, and ``ops.spgemm.spgemm`` on
a 4096-row slice — each against a float64 oracle (the COO product; for
CG b, for SpGEMM A (A x)) within 5e-4 (max |got - want| / max |want|).  Prints ``SOAK PASSED`` and exits 0,
or ``SOAK FAILED`` and exits 1.

    python3 tools/soak_torch.py [--n 262144] [--nnz 2400000]
        [--device cuda:0] [--ranks R]

Everything runs on ``--device`` (default ``cuda:0``; ``cpu`` runs the
plain PyTorch versions).  The sharded checks take ``--ranks`` ranks,
default min(4, devices) as the reference counts its shards: the GPUs this
machine has on CUDA, 1 on the CPU.  NCCL, a GPU a rank, serves them where
the machine has that many GPUs, else gloo with every rank on ``--device``.
Run it as a script: the spawned ranks import it by its path.  Exits 2
without the CUDA device asked for or on a malformed ``--device``.
"""

import argparse
import os
import pickle
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TOL = 5e-4   # f32 accumulation across millions of terms


def check(tag, got, want, tol=TOL):
    import torch
    if isinstance(got, torch.Tensor):
        got = got.double().cpu().numpy()
    err = np.abs(np.asarray(got, dtype=np.float64) - want).max() / (
        np.abs(want).max() + 1e-30)
    status = "ok" if err < tol else "FAIL"
    print(f"  {tag:34s} rel_err={err:.2e}  [{status}]")
    return err < tol


def rank_body(rank, case_path, out_path):
    """One rank (spawned): ``ShardedCsx`` with x replicated, then with a
    halo ring; rank 0 keeps both y and the halo depth."""
    import torch

    import sparsex_tpu_torch as spx
    from sparsex_tpu_torch.parallel.shard import ShardedCsx, host_matrix
    with open(case_path, "rb") as fp:
        case = pickle.load(fp)
    dev = torch.device(case["devices"][rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mat = host_matrix(case["host"])
    x = torch.as_tensor(case["x"], device=dev)
    out = {}
    for mode in ("replicated", "halo"):
        cfg = spx.Config.reset()
        cfg.set("spx.tpu.value_dtype", "float32")
        cfg.set("spx.preproc.xform", "all")
        cfg.set("spx.rt.nr_threads", str(len(case["devices"])))
        cfg.set("spx.tpu.x_mode", mode)
        sh = ShardedCsx(mat, device=dev)
        out[mode] = (sh.matvec(x).double().cpu().numpy(), sh.halo_k)
        del sh
    if rank == 0:
        with open(out_path, "wb") as fp:
            pickle.dump(out, fp)


def mixed_matrix(n, m, rng):
    """The reference's mixed structure: diagonals + h-runs + blocks +
    randoms (tools/soak.py:66-87)."""
    rows_l = [np.arange(n), np.arange(n - 1)]
    cols_l = [np.arange(n), np.arange(1, n)]
    hr = rng.integers(0, n, m // 40)
    hc = rng.integers(0, n - 8, m // 40)
    rows_l.append(np.repeat(hr, 8))
    cols_l.append((hc[:, None] + np.arange(8)[None]).ravel())
    br0 = rng.integers(0, (n - 4) // 4, m // 64) * 4
    bc0 = rng.integers(0, (n - 2) // 2, m // 64) * 2
    ii, jj = np.meshgrid(np.arange(4), np.arange(2), indexing="ij")
    rows_l.append((br0[:, None, None] + ii[None]).ravel())
    cols_l.append((bc0[:, None, None] + jj[None]).ravel())
    rows_l.append(rng.integers(0, n, m // 4))
    cols_l.append(rng.integers(0, n, m // 4))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    _, u = np.unique(rows.astype(np.int64) * n + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = (rng.standard_normal(rows.size) * 0.1).astype(np.float32)
    return rows, cols, vals


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=1 << 18)
    ap.add_argument("--nnz", type=int, default=2_400_000)
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the sharded checks (default min(4, "
                         "devices))")
    args = ap.parse_args(argv)

    import torch

    from sparsex_tpu_torch.config import Config
    from sparsex_tpu_torch.csx import CsxMatrix
    from sparsex_tpu_torch.device import resolve_device
    from sparsex_tpu_torch.errors import SparsexError
    from sparsex_tpu_torch.ops.spgemm import spgemm
    from sparsex_tpu_torch.parallel.comm import run_ranks
    from sparsex_tpu_torch.parallel.shard import host_from_coo
    from sparsex_tpu_torch.persist import restore_csx, save_csx
    from sparsex_tpu_torch.solvers import block_cg, cg
    from sparsex_tpu_torch.symmetric import build_symmetric_csx

    try:
        dev = resolve_device(args.device)
    except (SparsexError, RuntimeError) as e:   # no CUDA; a bad --device
        print(f"ERROR: --device {args.device}: {e}", file=sys.stderr)
        return 2
    ngpu = torch.cuda.device_count() if dev.type == "cuda" else 0
    print(f"backend: {dev.type}  devices: {ngpu if ngpu else 1}")
    cfg = Config.reset()
    cfg.set("spx.tpu.value_dtype", "float32")
    cfg.set("spx.preproc.xform", "all")
    ok = True
    n, m = args.n, args.nnz
    rng = np.random.default_rng(0)

    rows, cols, vals = mixed_matrix(n, m, rng)
    x = rng.standard_normal(n).astype(np.float32)
    ref = np.zeros(n, np.float64)
    np.add.at(ref, rows, vals.astype(np.float64) * x[cols])
    xd = torch.as_tensor(x, device=dev)

    t0 = time.perf_counter()
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals, device=dev)
    print(f"mixed matrix {n}x{n} nnz={rows.size} "
          f"pt={time.perf_counter()-t0:.1f}s")
    ok &= check("single-device SpMV", mat.matvec(xd), ref)

    # SpMM
    X = rng.standard_normal((n, 4)).astype(np.float32)
    refM = np.zeros((n, 4))
    np.add.at(refM, rows, vals[:, None].astype(np.float64) * X[cols])
    ok &= check("SpMM k=4", mat.matmat(torch.as_tensor(X, device=dev)),
                refM)

    # save/restore with layouts
    with tempfile.TemporaryDirectory(prefix="spx_soak_") as td:
        save_csx(mat, os.path.join(td, "soak_cache.npz"))
        mat2, _ = restore_csx(os.path.join(td, "soak_cache.npz"),
                              device=dev)
        ok &= check("restore(+layouts) SpMV", mat2.matvec(xd), ref)
        del mat, mat2

        # sharded: replicated + halo (as many ranks as devices, max 4)
        nr = args.ranks or min(4, ngpu or 1)
        nccl = dev.type == "cuda" and ngpu >= nr >= 2
        cfg.set("spx.rt.nr_threads", str(nr))
        case = {"x": x, "devices": [f"cuda:{r}" if nccl else str(dev)
                                    for r in range(nr)],
                "host": host_from_coo(n, n, rows, cols, vals, cfg, nr)}
        with open(os.path.join(td, "case.pkl"), "wb") as fp:
            pickle.dump(case, fp)
        del case
        run_ranks(rank_body, nr, (os.path.join(td, "case.pkl"),
                                  os.path.join(td, "out.pkl")),
                  backend="nccl" if nccl else "gloo")
        with open(os.path.join(td, "out.pkl"), "rb") as fp:
            out = pickle.load(fp)
    ok &= check(f"sharded x{nr} replicated", out["replicated"][0], ref)
    ok &= check(f"sharded x{nr} halo(k={out['halo'][1]})", out["halo"][0],
                ref)
    cfg.set("spx.rt.nr_threads", "1")

    # symmetric
    r2 = rng.integers(0, n, m // 4)
    c2 = rng.integers(0, n, m // 4)
    sr, sc = np.maximum(r2, c2), np.minimum(r2, c2)
    sr = np.concatenate([sr, np.arange(n)])
    sc = np.concatenate([sc, np.arange(n)])
    _, u = np.unique(sr.astype(np.int64) * n + sc, return_index=True)
    sr, sc = sr[u], sc[u]
    o = np.lexsort((sc, sr))
    sr, sc = sr[o], sc[o]
    sv = (rng.standard_normal(sr.size) * 0.1).astype(np.float32)
    sym = build_symmetric_csx(n, n, sr, sc, sv, already_lower=True,
                              device=dev)
    refS = np.zeros(n, np.float64)
    np.add.at(refS, sr, sv.astype(np.float64) * x[sc])
    low = sr != sc
    np.add.at(refS, sc[low], sv[low].astype(np.float64) * x[sr[low]])
    ok &= check("symmetric SpMV", sym.matvec(xd), refS)
    del sym

    # CG on an s.p.d. system
    nn = 1 << 14
    rr = np.concatenate([np.arange(nn), np.arange(nn - 1), np.arange(1, nn)])
    cc = np.concatenate([np.arange(nn), np.arange(1, nn), np.arange(nn - 1)])
    vv = np.concatenate([np.full(nn, 4.0), np.full(nn - 1, -1.0),
                         np.full(nn - 1, -1.0)]).astype(np.float32)
    o = np.lexsort((cc, rr))
    spd = CsxMatrix.from_coo(nn, nn, rr[o], cc[o], vv[o], device=dev)
    b = rng.standard_normal(nn).astype(np.float32)
    bd = torch.as_tensor(b, device=dev)
    xs, iters, res = cg(spd.matvec, bd, tol=1e-6, device=dev)
    ok &= check(f"CG ({int(iters)} iters)", spd.matvec(xs),
                b.astype(np.float64))
    Xb, itb, _ = block_cg(spd.matmat, bd[:, None].repeat(1, 3), tol=1e-6,
                          device=dev)
    ok &= check(f"block-CG ({int(itb)} iters)", spd.matmat(Xb)[:, 0],
                b.astype(np.float64))

    # SpGEMM on a small slice
    ns = 4096
    sel = (rows < ns) & (cols < ns)
    A = CsxMatrix.from_coo(ns, ns, rows[sel], cols[sel], vals[sel],
                           device=dev)
    C = spgemm(A, A)
    xs2 = torch.as_tensor(rng.standard_normal(ns).astype(np.float32),
                          device=dev)
    ok &= check("SpGEMM (C x vs A(A x))", C.matvec(xs2),
                A.matvec(A.matvec(xs2)).double().cpu().numpy())

    print("SOAK", "PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
