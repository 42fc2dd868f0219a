#!/usr/bin/env python
"""Matrix caching, part 2: restore and run, on the PyTorch port.

The counterpart of ``examples/matrix_caching_example_p2.py`` (the
reference's ``src/examples/matrix_caching_example_p2.c``): restore the
tuned matrix that part 1 saved onto the device (planned from the
archive's layouts, no preprocessing) and run kernels at once; entries can
be read and set on it.  Ends with a check of the SpMV against the float64
COO oracle of the restored matrix, before and after the write.

    python examples/matrix_caching_example_p2_torch.py [--cache PATH]
        [--device cuda:0]
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import sparsex_tpu_torch as spx  # noqa: E402
from sparsex_tpu_torch.ops.oracle import coo_spmv  # noqa: E402

CACHE = os.environ.get("SPX_CACHE_FILE", os.path.join(
    tempfile.gettempdir(), "sparsex_tpu_torch_cache.npz"))
BAR = 1e-12


def main(argv=None):
    ap = argparse.ArgumentParser(description="restore and run example")
    ap.add_argument("--cache", default=CACHE)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    if not os.path.exists(args.cache):
        print(f"run matrix_caching_example_p1_torch.py first "
              f"({args.cache} missing)")
        return 1
    spx.init()
    t0 = time.perf_counter()
    A = spx.mat_restore(args.cache, device=args.device)
    print(f"restored in {time.perf_counter() - t0:.3f}s "
          f"({A.nrows}x{A.ncols}, nnz={A.nnz}, on {A.device})")

    x = np.random.default_rng(0).random(A.ncols)
    y = spx.matvec_mult(1.0, A, x).cpu().numpy()
    print("y[:5] =", y[:5])
    rr, cc, vv = A.csx.tocoo()
    err = np.abs(y - coo_spmv(A.nrows, rr, cc, vv, x)).max()

    # entries can be inspected and updated on the restored matrix
    r, c = int(rr[0]), int(cc[0])
    print(f"entry ({r},{c}) =", spx.mat_get_entry(A, r, c))
    spx.mat_set_entry(A, r, c, 42.0)
    print(f"entry ({r},{c}) =", spx.mat_get_entry(A, r, c))
    y2 = spx.matvec_mult(1.0, A, x).cpu().numpy()
    vv = vv.copy()
    vv[0] = 42.0
    want = coo_spmv(A.nrows, rr, cc, vv, x)
    err = max(err, np.abs(y2 - want).max()) / np.abs(want).max()
    ok = err < BAR and spx.mat_get_entry(A, r, c) == 42.0
    print(f"check: max error / max |y| vs the COO oracle {err:.2e} "
          f"(bar {BAR:g}), before and after set_entry: "
          f"{'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
