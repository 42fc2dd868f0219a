#!/usr/bin/env python
"""Vector tuning and runtime options, on the PyTorch port.

The counterpart of ``examples/advanced_example.py`` (the reference's
``src/examples/advanced_example.c``): vectors made from user buffers as
they are (``create_from_buff(copy=False)``, SPX_VEC_AS_IS) or copied
(``copy=True``, SPX_VEC_TUNE) on the device, runtime options set by
mnemonic (two shards), a kernel call and the ``spx_vec_*`` algebra.  Ends
with a check of y against the float64 COO oracle.

    python examples/advanced_example_torch.py [--device cuda:0]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import sparsex_tpu_torch as spx  # noqa: E402
from sparsex_tpu_torch.ops import vector as vec  # noqa: E402
from sparsex_tpu_torch.ops.oracle import coo_spmv  # noqa: E402

BAR = 1e-12


def main(argv=None):
    ap = argparse.ArgumentParser(description="vectors and options example")
    ap.add_argument("--matrix", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "tests",
        "matrices", "test2.mtx.sorted"))
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    spx.init()
    # runtime options by mnemonic (ref spx_option_set, matvec.c:753-761)
    spx.option_set("spx.rt.nr_threads", "2")
    spx.option_set("spx.preproc.xform", "all")
    spx.option_set("spx.preproc.sampling", "none")

    inp = spx.input_load_mmf(args.matrix)
    rows, cols, vals = inp.tocoo()
    A = spx.mat_tune(inp, device=args.device)

    # user buffers wrapped AS_IS vs TUNE-copied (ref SPX_VEC_TUNE)
    xbuf = np.random.default_rng(0).random(A.ncols)
    ybuf = np.zeros(A.nrows)
    x = vec.create_from_buff(xbuf, copy=False, device=args.device)
    y = vec.create_from_buff(ybuf, copy=True, device=args.device)

    y = spx.matvec_kernel(0.7, A, x, 0.2, y)

    # vector algebra (spx_vec_*)
    norm = float(vec.mul(y, y)) ** 0.5
    y2 = vec.scale(y, 1.0 / norm)
    print(f"{len(A.csx.shards)} shards; ||y|| = {norm}")
    print("normalized y[:4] =", y2[:4].cpu().numpy())
    print("compare(y, y) ->", vec.compare(y, y))

    want = coo_spmv(A.nrows, rows, cols, np.asarray(vals, np.float64), xbuf,
                    y=ybuf, alpha=0.7, beta=0.2)
    err = np.abs(y.cpu().numpy() - want).max() / np.abs(want).max()
    unit = abs(float(vec.mul(y2, y2)) - 1.0)
    ok = err < BAR and unit < BAR
    print(f"check: max error / max |y| vs the COO oracle {err:.2e}, "
          f"| ||y/||y|| || - 1 | {unit:.2e} (bar {BAR:g}): "
          f"{'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
