#!/usr/bin/env python
"""SpGEMM, C = A @ B as a new tuned matrix, on the PyTorch port.

The counterpart of ``examples/spgemm_example.py``: the product's structure
and values are computed once on the host (``ops/spgemm.spgemm``); the
result is a regular ``CsxMatrix`` tuned onto A's device, so its SpMV /
SpMM run on the CUDA kernels at once.  Ends with a check of ``C x``
against ``A (B x)`` through the float64 COO oracle.

    python examples/spgemm_example_torch.py [--n N] [--device cuda:0]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from sparsex_tpu_torch.csx import CsxMatrix  # noqa: E402
from sparsex_tpu_torch.ops.oracle import coo_spmv  # noqa: E402
from sparsex_tpu_torch.ops.spgemm import spgemm  # noqa: E402

BAR = 1e-10


def main(argv=None):
    ap = argparse.ArgumentParser(description="SpGEMM example")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--nnz", type=int, default=20000)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    n = args.n

    def random_coo(m):
        r = rng.integers(0, n, m)
        c = rng.integers(0, n, m)
        _, u = np.unique(r * n + c, return_index=True)
        r, c = r[u], c[u]
        o = np.lexsort((c, r))
        return r[o], c[o], rng.standard_normal(r.size)

    a, b = random_coo(args.nnz), random_coo(args.nnz)
    A = CsxMatrix.from_coo(n, n, *a, device=args.device)
    B = CsxMatrix.from_coo(n, n, *b, device=args.device)
    C = spgemm(A, B)
    print(f"A: {A.nnz} nnz, B: {B.nnz} nnz -> C = A@B: {C.nnz} nnz "
          f"({C.csx_size() / 1e3:.0f} kB compressed, on {C.device})")

    # C is a first-class tuned matrix: SpMV on it directly
    x = rng.standard_normal(n)
    y = C.matvec(x).cpu().numpy()
    want = coo_spmv(n, *a, coo_spmv(n, *b, x))
    err = np.abs(y - want).max() / np.abs(want).max()
    ok = err < BAR
    print(f"check: max |C x - A (B x)| / max |A (B x)| = {err:.2e} "
          f"(bar {BAR:g}): {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
