#!/usr/bin/env python
"""RCM reordering of a symmetric matrix, on the PyTorch port.

The counterpart of ``examples/reordering_example.py`` (the reference's
``src/examples/reordering_example.c``): tune with ``OP_REORDER`` (RCM
bandwidth reduction) as a symmetric matrix, then run the kernel on the
permuted matrix, x and y permuted with ``vec.reorder`` /
``vec.inv_reorder``.  Ends with a check against the unpermuted matrix
through the port's host oracle (``ops/oracle.py``).

    python examples/reordering_example_torch.py [--device cuda:0]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import sparsex_tpu_torch as spx  # noqa: E402
from sparsex_tpu_torch.io.mmf import load_mmf  # noqa: E402
from sparsex_tpu_torch.ops import vector as vec  # noqa: E402
from sparsex_tpu_torch.ops.oracle import coo_spmv, max_rel_error  # noqa: E402

BAR = 1e-10


def main(argv=None):
    ap = argparse.ArgumentParser(description="RCM reordering example")
    ap.add_argument("--matrix", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "tests",
        "matrices", "symmetric.mtx.sorted"))
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    spx.init()
    spx.option_set("spx.matrix.symmetric", "true")
    spx.option_set("spx.preproc.xform", "all")
    spx.option_set("spx.log.level", "info")  # prints the bandwidth change

    A = spx.mat_tune(spx.input_load_mmf(args.matrix), spx.OP_REORDER,
                     device=args.device)

    x = np.random.default_rng(0).random(A.ncols)
    x_perm = vec.reorder(vec.create_from_buff(x, device=args.device),
                         A.permutation)
    y_perm = spx.matvec_mult(1.0, A, x_perm)
    y = vec.inv_reorder(y_perm, A.permutation).cpu().numpy()
    print("y[:5] =", y[:5])

    # check vs the unpermuted oracle (the full symmetric matrix)
    oracle = load_mmf(args.matrix)
    want = coo_spmv(oracle.nrows, *oracle.tocoo(), x)
    err = max_rel_error(y, want)
    ok = err < BAR
    print(f"check: max rel error vs the oracle {err:.2e} (bar {BAR:g}): "
          f"{'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
