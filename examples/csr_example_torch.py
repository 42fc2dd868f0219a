#!/usr/bin/env python
"""The one-shot CSR kernel API and CSR partitioning, on the PyTorch port.

The counterpart of ``examples/csr_example.py`` (the reference's
``src/examples/csr_example.c``): ``matvec_kernel_csr`` tunes the CSR
buffers onto the device at its first call and reuses the tuned matrix at
the next; ``partition_csr`` splits the rows by nonzeros.  Ends with a
check of both products against a dense one.

    python examples/csr_example_torch.py [--device cuda:0]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import sparsex_tpu_torch as spx  # noqa: E402

BAR = 1e-12


def main(argv=None):
    ap = argparse.ArgumentParser(description="CSR kernel API example")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    # a small tridiagonal CSR matrix
    n = 12
    rowptr, colind, values = [0], [], []
    for i in range(n):
        for j in (i - 1, i, i + 1):
            if 0 <= j < n:
                colind.append(j)
                values.append(4.0 if i == j else -1.0)
        rowptr.append(len(colind))
    rowptr = np.array(rowptr)
    colind = np.array(colind)
    values = np.array(values)

    spx.init()
    x = np.arange(1.0, n + 1)
    y0 = np.ones(n)

    # one-shot: tunes lazily on the first call (ref matvec.c:622-673)
    y1 = spx.matvec_kernel_csr(rowptr, colind, values, n, n, alpha=2.0, x=x,
                               beta=0.5, y=y0, device=args.device)
    print("y =", y1.cpu().numpy())

    # the second call reuses the tuned matrix
    y2 = spx.matvec_kernel_csr(rowptr, colind, values, n, n, alpha=1.0, x=x,
                               beta=0.0, y=y1, device=args.device)
    print("y =", y2.cpu().numpy())

    # nnz-balanced partition of the CSR rows (ref matvec.c:689-737)
    parts = spx.partition_csr(rowptr, n, 4)
    for i in range(parts.parts.nparts):
        s, e = parts.parts.bounds(i)
        print(f"partition {i}: rows [{s}, {e})  "
              f"nnz={parts.parts.nnz_per_part[i]}")

    dense = np.zeros((n, n))
    for i in range(n):
        dense[i, colind[rowptr[i]:rowptr[i + 1]]] = \
            values[rowptr[i]:rowptr[i + 1]]
    err = max(np.abs(y1.cpu().numpy() - (2.0 * dense @ x + 0.5 * y0)).max(),
              np.abs(y2.cpu().numpy() - dense @ x).max()) / np.abs(
                  dense @ x).max()
    ok = err < BAR and sum(parts.parts.nnz_per_part) == values.size
    print(f"check: max rel error vs the dense product {err:.2e} "
          f"(bar {BAR:g}): {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
