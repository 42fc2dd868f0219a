#!/usr/bin/env python
"""Load a MatrixMarket file, tune, run an SpMV kernel loop, report MFLOPS,
on the PyTorch port.

The counterpart of ``examples/mmf_example.py`` (the reference's
``src/examples/mmf_example.c``): load -> tune -> ``--loops`` x
``matvec_kernel`` -> MFLOPS = 2*loops*nnz / (1e6*elapsed) (ref
``mmf_example.c:74-79``; elapsed ends with a device synchronisation).
Ends with a check of the last y against the float64 COO oracle.

    python examples/mmf_example_torch.py [--matrix M.mtx] [--device cuda:0]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import torch  # noqa: E402

import sparsex_tpu_torch as spx  # noqa: E402
from sparsex_tpu_torch.ops.oracle import coo_spmv  # noqa: E402

BAR = 1e-10


def main(argv=None):
    ap = argparse.ArgumentParser(description="MMF SpMV loop example")
    ap.add_argument("--matrix", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "tests",
        "matrices", "test3.mtx.sorted"))
    ap.add_argument("--loops", type=int, default=128)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    spx.init()
    spx.option_set("spx.preproc.xform", "all")

    inp = spx.input_load_mmf(args.matrix)
    print(f"loaded {args.matrix}: {inp.nrows}x{inp.ncols}")
    rows, cols, vals = inp.tocoo()

    t0 = time.perf_counter()
    A = spx.mat_tune(inp, device=args.device)
    print(f"tuned in {time.perf_counter() - t0:.3f}s "
          f"(csx size {A.csx.csx_size()} bytes)")

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.random(A.ncols), device=A.device)
    y = torch.zeros(A.nrows, dtype=x.dtype, device=A.device)
    spx.matvec_kernel(1.5, A, x, 0.0, y)    # the first call builds
    if A.device.type == "cuda":
        torch.cuda.synchronize(A.device)

    t0 = time.perf_counter()
    for _ in range(args.loops):
        y = spx.matvec_kernel(1.5, A, x, 0.0, y)
    if A.device.type == "cuda":
        torch.cuda.synchronize(A.device)
    elapsed = time.perf_counter() - t0
    mflops = 2.0 * args.loops * A.nnz / (1e6 * elapsed)
    print(f"{args.loops} kernels in {elapsed:.4f}s -> {mflops:.1f} MFLOPS")
    y = y.cpu().numpy()
    print("y[:5] =", y[:5])

    want = coo_spmv(A.nrows, rows, cols, np.asarray(vals, np.float64),
                    x.cpu().numpy(), alpha=1.5)
    err = np.abs(y - want).max() / np.abs(want).max()
    ok = err < BAR
    print(f"check: max error / max |y| vs the COO oracle {err:.2e} "
          f"(bar {BAR:g}): {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
