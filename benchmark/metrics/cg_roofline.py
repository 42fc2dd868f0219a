"""Kernels, glue and CG's vector updates: the least time of the traced
stretch's CG iterations at the HBM peak (``roofline.cg_iteration_bytes``),
over the device time of every operation launched inside the solves."""

from benchmark import roofline


def read(run):
    t = run.trace
    if not t or not t["port_us"]:
        return None
    n, rowptr, colind, values = run.csr
    iters = sum(r["iterations"] for r in run.traced)
    least = roofline.least_seconds(iters * roofline.cg_iteration_bytes(
        int(colind.size), n, run.dtype.itemsize))
    return 100.0 * least / (t["port_us"] * 1e-6)
