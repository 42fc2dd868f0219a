#!/usr/bin/env python3
"""API integration test of sparsex_tpu_torch — ``test_sparsex`` parity.

The counterpart of ``tools/test_sparsex.py`` on the PyTorch port (the
reference integration test binary, ``test/src/sparsex_test.c``): load an
MMF, tune it on the device (optionally RCM-reordered), a random x, LOOPS x
``matvec_mult`` with alpha = 2, then compare against the COO oracle built
from the same file (``io.mmf.load_mmf(..., keep_lower=False)``, a
symmetric file mirrored; ``ops.oracle.coo_spmv``) at 1e-6 relative
tolerance (ref ``test/src/CsxCheck.cpp:28-53``,
``src/internals/Vector.cpp:51-56``).

    python3 tools/test_sparsex_torch.py MATRIX.mtx [-o key=value]... [-r]
        [-t] [--device cuda:0]

``-o`` sets runtime options by mnemonic (like ``spx_option_set``), ``-r``
enables RCM reordering (x and y go through ``vec.reorder`` /
``vec.inv_reorder``), ``-t`` prints timing/MFLOPS.  The matrix runs on
``--device`` (default ``cuda:0``; ``cpu`` runs the plain PyTorch versions
of the kernels).  Exit code 0 on PASS, 1 on numerical FAILURE, 2 on a
load/tune error (a ``SparsexError``: an unsorted MMF, a bad option) or
without the CUDA device asked for (or a malformed ``--device``) — never
a signal.
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LOOPS = int(os.environ.get("LOOPS", "128"))
TOLERANCE = 1e-6  # ref src/internals/Vector.cpp:51-56


def run(matrix, options=(), reorder=False, timing=False, device="cuda:0"):
    """One run of the test: ``{"rc": exit code, "err": rel error or None,
    "y": the result in the file's order as float64, or None}``."""
    import torch

    import sparsex_tpu_torch as spx
    from sparsex_tpu_torch.errors import SparsexError
    from sparsex_tpu_torch.io.mmf import load_mmf
    from sparsex_tpu_torch.ops import vector as vec
    from sparsex_tpu_torch.ops.oracle import coo_spmv, max_rel_error

    spx.Config.reset()
    spx.init()
    try:
        for opt in options:
            key, _, value = opt.partition("=")
            spx.option_set(key, value)

        inp = spx.input_load_mmf(matrix)
        # Oracle COO straight from the file (mirrored when symmetric).
        cfg = spx.Config.instance()
        oracle = load_mmf(matrix, keep_lower=False)
        nrows, ncols = oracle.nrows, oracle.ncols

        t0 = time.perf_counter()
        mat = spx.mat_tune(inp, *([spx.OP_REORDER] if reorder else []),
                           device=device)
        pt = time.perf_counter() - t0
    except SparsexError as e:
        print(f"LOAD/TUNE ERROR: {e}", file=sys.stderr)
        return {"rc": 2, "err": None, "y": None}

    rng = np.random.default_rng(0)
    x = rng.random(ncols).astype(cfg.value_dtype)
    perm = mat.permutation
    x_run = torch.as_tensor(x if perm is None else vec.reorder(x, perm),
                            device=mat.device)

    t0 = time.perf_counter()
    for _ in range(LOOPS):
        y = spx.matvec_mult(2.0, mat, x_run)
    y = y.double().cpu()
    secs = time.perf_counter() - t0
    if perm is not None:
        y = vec.inv_reorder(y, perm)
    y = y.numpy()

    want = coo_spmv(nrows, *oracle.tocoo(), x, alpha=2.0)
    err = max_rel_error(y, want)
    if timing:
        mflops = 2.0 * LOOPS * oracle.nnz / (1e6 * secs)
        print(f"m:{os.path.basename(matrix)} pt:{pt:.3f} t:{secs:.4f} "
              f"r:{mflops:.1f} MFLOPS")
    if err <= TOLERANCE:
        print(f"PASSED (rel_err={err:.2e})")
        return {"rc": 0, "err": err, "y": y}
    print(f"FAILED (rel_err={err:.2e} > {TOLERANCE})")
    return {"rc": 1, "err": err, "y": y}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("matrix")
    ap.add_argument("-o", "--option", action="append", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("-r", "--reorder", action="store_true")
    ap.add_argument("-t", "--timing", action="store_true")
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:N (default cuda:0) or cpu")
    args = ap.parse_args(argv)
    from sparsex_tpu_torch.device import resolve_device
    from sparsex_tpu_torch.errors import SparsexError
    try:
        dev = resolve_device(args.device)
    except (SparsexError, RuntimeError) as e:   # no CUDA; a bad --device
        print(f"ERROR: --device {args.device}: {e}", file=sys.stderr)
        return 2
    return run(args.matrix, args.option, args.reorder, args.timing,
               dev)["rc"]


if __name__ == "__main__":
    sys.exit(main())
