"""Executor glue: the device time of the operations launched inside the
port's calls that are not the port's own kernels (``devtrace.PORT_KERNEL``),
as a share of all the device time launched there."""


def read(run):
    t = run.trace
    if not t or not t["port_us"]:
        return None
    return 100.0 * t["glue_us"] / t["port_us"]
