#!/usr/bin/env python
"""Matrix caching, part 1: tune and save, on the PyTorch port.

The counterpart of ``examples/matrix_caching_example_p1.py`` (the
reference's ``src/examples/matrix_caching_example_p1.c``): tune a matrix
(the expensive preprocessing step) and save it, in the reference's
archive format, so that a later process can skip it
(``matrix_caching_example_p2_torch.py``).  Ends with a check that the
archive restores to the same product.

    python examples/matrix_caching_example_p1_torch.py [--cache PATH]
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

CACHE = os.environ.get("SPX_CACHE_FILE", os.path.join(
    tempfile.gettempdir(), "sparsex_tpu_torch_cache.npz"))
BAR = 1e-12


def main(argv=None):
    ap = argparse.ArgumentParser(description="tune and save example")
    ap.add_argument("--matrix", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "tests",
        "matrices", "test3.mtx.sorted"))
    ap.add_argument("--cache", default=CACHE)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    spx.init()
    spx.option_set("spx.preproc.xform", "all")

    t0 = time.perf_counter()
    A = spx.mat_tune(spx.input_load_mmf(args.matrix), device=args.device)
    print(f"tuned in {time.perf_counter() - t0:.3f}s")

    spx.mat_save(A, args.cache)
    print(f"saved tuned matrix to {args.cache} "
          f"({os.path.getsize(args.cache)} bytes)")

    x = np.random.default_rng(0).random(A.ncols)
    B = spx.mat_restore(args.cache, device=args.device)
    y, yr = spx.matvec_mult(1.0, A, x), spx.matvec_mult(1.0, B, x)
    # within rounding: atomic adds on the card reorder sums between runs
    err = float((yr - y).abs().max() / y.abs().max())
    ok = err < BAR
    print(f"check: the restored matrix's SpMV within {err:.2e} of the "
          f"tuned one's (bar {BAR:g}): {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
