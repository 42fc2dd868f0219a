#!/usr/bin/env python
"""SpMM + block CG, on the PyTorch port.

The counterpart of ``examples/spmm_block_cg_example.py``: the multi-RHS
extension of the CG workflow, one SpMM per iteration for all right-hand
sides (``solvers.block_cg``; on the card the k-batched kernels, a block of
iterations one CUDA graph replay).  Ends with a check of ``B - A X``
through the float64 COO oracle.

    python examples/spmm_block_cg_example_torch.py [--n N] [--k K]
        [--device cuda:0]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import sparsex_tpu_torch as spx  # noqa: E402
from sparsex_tpu_torch.csx import CsxMatrix  # noqa: E402
from sparsex_tpu_torch.ops.oracle import coo_spmv  # noqa: E402
from sparsex_tpu_torch.solvers import block_cg  # noqa: E402

BAR = 1e-7      # max |B - A X| / max |B| of a solve to tol 1e-8


def main(argv=None):
    ap = argparse.ArgumentParser(description="block CG example")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    n, k = args.n, args.k
    # s.p.d. 2-D Poisson-like pentadiagonal system
    rows, cols, vals = [], [], []
    for off, v in ((0, 4.0), (1, -1.0), (-1, -1.0), (64, -1.0),
                   (-64, -1.0)):
        r = np.arange(max(0, -off), min(n, n - off), dtype=np.int64)
        rows.append(r)
        cols.append(r + off)
        vals.append(np.full(r.size, v))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]

    spx.option_set("spx.preproc.xform", "all")
    A = CsxMatrix.from_coo(n, n, rows, cols, vals, device=args.device)
    B = np.random.default_rng(0).standard_normal((n, k))

    st = {}
    X, iters, res = block_cg(A.matmat, B, tol=1e-8, device=args.device,
                             stats=st)
    print(f"block-CG: {k} systems solved in {iters} iterations "
          f"({st['blocks']} blocks, {st['seconds']:.3f}s); max residual "
          f"{float(res.max()):.2e}")

    # verify: one oracle SpMV per column
    X = X.cpu().numpy()
    R = B - np.stack([coo_spmv(n, rows, cols, vals, X[:, j])
                      for j in range(k)], axis=1)
    err = np.abs(R).max() / np.abs(B).max()
    ok = err <= BAR
    print(f"check: max |B - A X| / max |B| = {err:.2e} (bar {BAR:g}): "
          f"{'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
