"""Reading a torch.profiler (Kineto) chrome trace into the numbers the
per-layer metrics take.

The harness wraps each call into the port in a ``record_function`` range
named ``port.<entry>`` and each closed-loop request in ``loop.solve``.  A
device operation (kernel, copy or fill) belongs to a port call when the
runtime call that launched it, found by the trace's correlation id, ran
inside a ``port.*`` range; the kernels of a replayed CUDA graph carry the
correlation id of its ``cudaGraphLaunch``.  ``PORT_KERNEL`` is a frozen
copy of ``chip_smoke.py``'s ``_KERNEL_NAME``: the names of the port's own
CUDA kernels; any other device operation inside a port call is glue.
"""

from __future__ import annotations

import bisect
import heapq
import json
import re
from collections import defaultdict

from benchmark.stats import merged

PORT_KERNEL = re.compile(r"\b(k1_lp|k1_rlp|k1_sl|k1_run|t1|k2|k3|"
                         r"lane_gather|dia|delta_pages_acc|delta_pages|"
                         r"paged_gather|paged_units)"
                         r"(_kb)?_kernel\b")

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
NAME_CHARS = 96   # a device operation's name as the breakdown keeps it


def load(path: str) -> list:
    """The complete ('X') events of a chrome trace file."""
    with open(path) as fp:
        data = json.load(fp)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _span(e):
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def summarize(events: list) -> dict:
    """Microsecond sums over the traced stretch, which runs from the first
    ``loop.solve`` range's start to the last one's end:

    - ``window_us``, ``busy_us``: the stretch, and the union of device
      operations inside it;
    - ``port_us``, ``glue_us``: device time of the operations launched
      inside ``port.*`` ranges, and of those among them that are not the
      port's own kernels;
    - ``port_calls``: the ``port.*`` ranges, ``attributed``: the device
      operations found inside them;
    - ``device_ops``: device seconds by operation name, largest first;
    - ``idle_gaps``: seconds of the stretch with no device operation, by
      the innermost host event running at each gap's midpoint.
    """
    solves = [_span(e) for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == "loop.solve"]
    if not solves:
        return {}
    w0, w1 = min(s for s, _ in solves), max(e for _, e in solves)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    ports = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("port.")]
    # the port's calls run one after another, on the loop's one thread
    port_spans = sorted(_span(e) for e in ports)
    port_starts = [p[0] for p in port_spans]
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = float(e["ts"])

    def in_port(ts):
        k = bisect.bisect_right(port_starts, ts) - 1
        return k >= 0 and ts <= port_spans[k][1]

    busy, ops = [], defaultdict(float)
    port_us = glue_us = 0.0
    attributed = 0
    for e in dev:
        s, t = _span(e)
        if t < w0 or s > w1:
            continue
        busy.append((max(s, w0), min(t, w1)))
        name = str(e.get("name", ""))
        ops[name[:NAME_CHARS]] += (t - s) * 1e-6
        src = launch.get(e.get("args", {}).get("correlation"))
        if src is not None and in_port(src):
            attributed += 1
            port_us += t - s
            if not PORT_KERNEL.search(name):
                glue_us += t - s
    runs = merged(busy)
    gaps = [(a[1], b[0]) for a, b in zip(runs, runs[1:])]
    if runs:
        gaps = [(w0, runs[0][0])] + gaps + [(runs[-1][1], w1)]
    else:
        gaps = [(w0, w1)]
    host = sorted(_span(e) + (str(e.get("name", "?")),) for e in events
                  if e.get("cat") in HOST_CATS)
    idle = defaultdict(float)
    active, k = [], 0      # a heap of (end, start, name) of open host events
    for a, b in sorted(gaps):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while k < len(host) and host[k][0] <= mid:
            heapq.heappush(active, (host[k][1], host[k][0], host[k][2]))
            k += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        name = (min(active, key=lambda h: h[0] - h[1])[2] if active
                else "host outside any traced call")
        idle[name[:NAME_CHARS]] += (b - a) * 1e-6
    return {
        "window_us": w1 - w0,
        "busy_us": sum(t - s for s, t in runs),
        "port_us": port_us,
        "glue_us": glue_us,
        "port_calls": len(ports),
        "attributed": attributed,
        "device_ops": sorted(ops.items(), key=lambda kv: -kv[1]),
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1]),
    }


def idle_pct(t: dict):
    """The share of the traced stretch in which no device operation runs,
    or None without a trace."""
    if not t or not t["window_us"] or not t["busy_us"]:
        return None
    return 100.0 * (1.0 - t["busy_us"] / t["window_us"])
