"""Device: the share of the traced stretch in which no device operation
runs while the innermost host event is one of the port's own spans
(``spx.*``; ``devtrace.summarize``'s idle gaps, by the innermost host
event at each gap), over the stretch."""


def read(run):
    import sparsex_tpu_torch as spx
    t = run.trace
    if not hasattr(spx, "trace_snapshot") or not t or not t["busy_us"]:
        return None      # a port without spans, or no device trace
    idle = sum(sec for name, sec in t["idle_gaps"]
               if name.startswith("spx."))
    return 100.0 * idle / (t["window_us"] * 1e-6)
