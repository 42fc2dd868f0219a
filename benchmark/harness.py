"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, loop or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` or the file before it gives:

- ``configs/<config>.json``: the deployment, with its ``generator``;
- ``gen/<generator>.py``: ``generate(config, seed, value_type, device)``
  -> CSR as NumPy arrays;
- ``traffic/<traffic>.json``: the mix's parameters, with its ``loop``;
- ``loops/<loop>.py``: ``Loop(run)``, the closed-loop caller;
- ``limits/<workload>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: ``read(run)``, one per-layer metric; a metric
  split by the cells' end-to-end metrics (``<quantity>.<part>``) with no
  file of its own is read by ``metrics/<quantity>.py``.

The port is reached only through ``sparsex_tpu_torch``'s public entry
points (the options, ``api.input_load_csr``, ``api.mat_tune`` and the
calls each loop makes).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from contextlib import nullcontext

import numpy as np
import torch

from benchmark import devtrace, stats

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "sparsex_tpu")
BREAKDOWN_ENTRIES = 10


def load_json(*parts):
    with open(os.path.join(*parts)) as fp:
        return json.load(fp)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    mod_name = f"benchmark_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(workload: str, spec=None) -> dict:
    """The cell's entry, configuration, mix, limits and metrics by name."""
    spec = spec or load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(ROOT, configs[cell["config"]]["file"])
    mix = load_json(HERE, "traffic", cell["traffic"] + ".json")
    limits = load_json(HERE, "limits", workload + ".json")

    def ours(metric):
        return workload in metric.get("workloads", [workload])

    return {"cell": cell, "config": config, "mix": mix, "limits": limits,
            "end_to_end": [m for m in spec["end_to_end"] if ours(m)],
            "per_layer": [m for m in spec["per_layer"] if ours(m)]}


def forbidden_modules() -> list:
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """The state one run shares with its loop and metric readers."""

    def __init__(self, cs: dict, seed: int, seconds: float, trace: bool,
                 device, port_value_type=None):
        self.cell, self.config, self.mix = cs["cell"], cs["config"], cs["mix"]
        self.limits = cs["limits"]
        self.seed = int(seed) % (1 << 64)
        self.seconds = float(seconds)
        self.tracing_run = bool(trace)
        self.device = torch.device(device)
        # the precision the port runs in: the configuration's, or a lower
        # one for the control
        self.value_type = port_value_type or self.config["value_type"]
        self.dtype = getattr(torch, self.value_type)
        self.tracing = False      # True inside the traced stretch
        self.records, self.traced = [], []
        self.trace = None

    def rng(self, stream: int) -> np.random.Generator:
        """A NumPy generator of the run's seed, one per use."""
        return np.random.default_rng([self.seed, stream])

    def annotate(self, name: str):
        """A profiler range inside the traced stretch, nothing outside."""
        if self.tracing:
            return torch.profiler.record_function(name)
        return nullcontext()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def set_options(config: dict, value_type: str) -> None:
    import sparsex_tpu_torch as spx
    spx.Config.reset()
    for key, val in config.get("options", {}).items():
        spx.option_set(key, str(val))
    spx.option_set("spx.tpu.value_dtype", value_type)


def metric_reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or,
    for ``<quantity>.<part>`` with no file of its own, the quantity's."""
    try:
        return load_module("metrics", name)
    except FileNotFoundError:
        if "." not in name:
            raise
        return metric_reader(name.rsplit(".", 1)[0])


def prepare(run: Run, t_start: float, phases: dict) -> None:
    """Set-up up to the loop: the inputs from the seed (``run.csr``), the
    options and the tune (``run.mat``, ``run.tune_s``,
    ``run.tune_preproc_s``); each step's seconds from ``t_start`` go into
    ``phases``."""
    from sparsex_tpu_torch import api
    gen = load_module("gen", run.config["generator"])
    n, ncols, rowptr, colind, values = gen.generate(
        run.config, run.seed, run.config["value_type"], run.device)
    run.csr = (n, rowptr, colind, values)
    if run.device.type == "cuda":   # the peak from here on: the port's
        torch.cuda.synchronize(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)   # and the loop's
    phases["inputs"] = time.perf_counter() - t_start
    set_options(run.config, run.value_type)
    inp = api.input_load_csr(rowptr, colind, values, n, ncols)
    t0 = time.perf_counter()
    run.mat = api.mat_tune(inp, device=run.device)
    run.sync()
    run.tune_s = time.perf_counter() - t0
    run.tune_preproc_s = run.mat.csx.timers.get_secs("preproc")
    phases["tune"] = time.perf_counter() - t_start


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start=None, port_value_type=None,
             config_override=None, mix_override=None) -> dict:
    """One run; returns the result line's object, with ``checks`` last.
    ``port_value_type`` runs the port in another precision (the control);
    ``config_override`` and ``mix_override`` change the configuration's
    sizes and the mix's parameters (the CPU tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cs = cell_spec(workload)
    if config_override:
        cs["config"] = {**cs["config"], **config_override}
    if mix_override:
        cs["mix"] = {**cs["mix"], **mix_override}
    run = Run(cs, seed, seconds, trace, device, port_value_type)
    on_card = run.device.type == "cuda"

    # set-up: the inputs, the tune, the warm-up
    phases = {"start": time.perf_counter() - t_start}
    prepare(run, t_start, phases)
    loop = load_module("loops", run.mix["loop"]).Loop(run)
    for k in range(1, int(run.mix["warm_solves"]) + 1):
        loop.solve(-k)     # negative indices: never sampled for the check
    run.sync()
    setup_s = time.perf_counter() - t_start
    phases["warm"] = setup_s
    print("set-up, seconds from the start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)

    # the window: one caller, each request after the previous one returned
    w0 = time.perf_counter()
    i = 0
    while time.perf_counter() - w0 < run.seconds:
        run.records.append(loop.solve(i))
        i += 1
    window_s = run.records[-1]["t1"] - w0
    ms = [(r["t1"] - r["t0"]) * 1e3 for r in run.records]
    print(f"window: {len(ms)} requests in {window_s:.3f} s, ms median "
          f"{stats.percentile(ms, 50):.3f} p95 {stats.percentile(ms, 95):.3f}"
          f" max {max(ms):.3f}, products a request "
          f"{sum(r['products'] for r in run.records) / len(ms):.3f}",
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(run.device) if on_card else None

    if run.tracing_run:
        run.trace = traced_stretch(run, loop, i)
        if on_card:
            peak = torch.cuda.max_memory_allocated(run.device)

    # the check, once the port's state is freed
    loop.release()
    run.mat = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = loop.check()

    result = {
        "correct": bool(checks) and all(c["value"] <= c["limit"]
                                        for c in checks.values()),
        "attempted": len(run.records),
        "failed": sum(1 for r in run.records if not r["ok"]),
        "metrics": {},
        "device": device_info(run, peak),
    }
    if run.tracing_run:
        for m in cs["per_layer"]:
            value = metric_reader(m["name"]).read(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        if run.trace:
            result["breakdown"] = {
                k: [[name, sec] for name, sec in run.trace[k][
                    :BREAKDOWN_ENTRIES]]
                for k in ("device_ops", "idle_gaps")}
    else:
        e2e = end_to_end(run, setup_s, window_s, peak)
        for m in cs["end_to_end"]:
            if e2e.get(m["name"]) is not None:
                result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                                "unit": m["unit"]}
    result["checks"] = checks
    return result


def end_to_end(run: Run, setup_s, window_s, peak) -> dict:
    nnz = int(run.csr[2].size)
    products = sum(r["products"] for r in run.records)
    gnnz_s = products * nnz / window_s / 1e9
    return {
        "setup_s": setup_s,
        "spmv_gnnz_s": gnnz_s,    # a CG iteration counts one product
        "solve_ms_p95": stats.percentile(
            [(r["t1"] - r["t0"]) * 1e3 for r in run.records], 95),
        "solve_ms_mean": window_s / len(run.records) * 1e3,
        "tune_s": run.tune_s,
        "device_mib": None if peak is None else peak / 2 ** 20,
    }


def device_info(run: Run, peak) -> dict:
    if run.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu",
            "kind": torch.cuda.get_device_name(run.device),
            "count": 1, "memory_peak_bytes": int(peak)}
    if run.tracing_run and run.trace:
        info["busy_s"] = run.trace["busy_us"] * 1e-6
        info["window_s"] = run.trace["window_us"] * 1e-6
    return info


def traced_stretch(run: Run, loop, start: int) -> dict:
    """``mix["trace_solves"]`` more requests under torch.profiler, read
    by :func:`devtrace.summarize` (an empty dict on a host without a
    card); their records go to ``run.traced``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    run.sync()
    run.tracing = True
    try:
        with profile(activities=acts) as prof:
            for i in range(start, start + int(run.mix["trace_solves"])):
                run.traced.append(loop.solve(i))
            run.sync()
    finally:
        run.tracing = False
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        del prof
        return devtrace.summarize(devtrace.load(path))
    finally:
        os.unlink(path)


def print_result(result: dict) -> None:
    """The result as the last line of standard output, its checks as the
    last lines of standard error."""
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr, flush=True)
