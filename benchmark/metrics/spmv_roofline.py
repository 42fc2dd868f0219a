"""Kernels and glue of one product: the least time of the traced
stretch's products at the HBM peak (``roofline.spmv_bytes``: each stored
value, x and y once, y read again as beta is 1), over the device time of
every operation launched inside the port's calls."""

from benchmark import roofline


def read(run):
    t = run.trace
    if not t or not t["port_us"]:
        return None
    n, rowptr, colind, values = run.csr
    products = sum(r["products"] for r in run.traced)
    least = roofline.least_seconds(products * roofline.spmv_bytes(
        int(colind.size), n, n, run.dtype.itemsize, beta_nonzero=True))
    return 100.0 * least / (t["port_us"] * 1e-6)
