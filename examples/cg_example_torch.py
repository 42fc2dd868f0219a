#!/usr/bin/env python
"""Conjugate-gradient solve on symmetric CSX, on the PyTorch port.

The counterpart of ``examples/cg_example.py``, the BASELINE
configuration's flagship flow: tune a symmetric matrix (CSX-Sym: lower
triangle + diagonal), then run CG on the device (``solvers.cg``: blocks of
``solvers.BLOCK`` iterations, each block one CUDA graph replay on the
card, the host reading the residual once a block).  The first solve builds
the kernels and captures the graphs; the second, timed, is the warm solve
(the JAX example's second ``jax.jit`` call): its capture of the solver's
block, once a solve, is printed apart.  Ends with a check of the true
residual ``||b - A x|| / ||b||`` through the float64 COO oracle.

    python examples/cg_example_torch.py [--n N] [--device cuda:0]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import sparsex_tpu_torch as spx  # noqa: E402
from sparsex_tpu_torch.ops.oracle import coo_spmv  # noqa: E402
from sparsex_tpu_torch.solvers import cg  # noqa: E402
from sparsex_tpu_torch.symmetric import build_symmetric_csx  # noqa: E402

TOL = 1e-8
BAR = 1e-7      # the true residual of a solve to TOL


def main(argv=None):
    ap = argparse.ArgumentParser(description="CG on symmetric CSX")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    n = args.n
    spx.init()
    spx.option_set("spx.preproc.xform", "all")

    # s.p.d.: diagonally dominant symmetric banded matrix (lower triangle)
    rng = np.random.default_rng(0)
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    vals = [np.full(n, 8.0)]
    for b in (1, 5, 64):
        r = np.arange(b, n)
        rows.append(r)
        cols.append(r - b)
        vals.append(rng.random(r.size))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    o = np.lexsort((cols, rows))
    rows, cols, vals = rows[o], cols[o], vals[o]

    t0 = time.perf_counter()
    A = build_symmetric_csx(n, n, rows, cols, vals, already_lower=True,
                            device=args.device)
    print(f"tuned {n}x{n} (lower nnz={rows.size}) on {A.device} "
          f"in {time.perf_counter() - t0:.2f}s")

    b = rng.standard_normal(n)

    def matvec(v):
        return A.matvec(v)

    first, warm = {}, {}
    cg(matvec, b, tol=TOL, maxiter=2000, device=args.device, stats=first)
    x, iters, res = cg(matvec, b, tol=TOL, maxiter=2000, device=args.device,
                       stats=warm)
    dt = warm["seconds"]
    print(f"CG converged in {iters} iterations, residual {float(res):.2e}, "
          f"{dt:.4f}s warm ({iters / max(dt, 1e-9):.0f} it/s; capture of "
          f"the block {warm['capture_s']:.4f}s, {warm['blocks']} blocks); "
          f"first solve {first['seconds']:.3f}s (kernel build and graph "
          "captures)")

    # verify against the full matrix (the lower triangle mirrored)
    strict = rows != cols
    fr = np.concatenate([rows, cols[strict]])
    fc = np.concatenate([cols, rows[strict]])
    fv = np.concatenate([vals, vals[strict]])
    r = b - coo_spmv(n, fr, fc, fv, x.cpu().numpy())
    rel = float(np.linalg.norm(r) / np.linalg.norm(b))
    ok = rel <= BAR and iters < 2000
    print(f"check: ||b - Ax|| / ||b|| = {rel:.2e} (bar {BAR:g}): "
          f"{'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
