#!/usr/bin/env python3
"""SpMV benchmark harness of sparsex_tpu_torch — ``bench_spmv`` parity.

The counterpart of ``tools/bench_spmv.py`` on the PyTorch port (the
reference bench tool, ``src/bench/main.cpp``, ``Bench.cpp``,
``SparsexModule.cpp:66-88``):

    python3 tools/bench_spmv_torch.py -f MATRIX.mtx [-l sparsex,csr,native]
        [--device cuda:0] [--json]
    python3 tools/bench_spmv_torch.py -d DIRECTORY  [-l ...]

- ``-f`` benchmarks one MatrixMarket file, ``-d`` every ``.mtx``/``.mtx.*``
  file in a directory (ref ``Bench_Directory``);
- ``-l`` selects libraries/adapters: ``sparsex`` (the port's CSX executor,
  tuned onto ``--device``; each call replays the executor's CUDA graph on
  the card), ``csr`` (torch's own CSR product on the same device,
  ``torch.sparse_csr_tensor(...) @ x``: cuSPARSE on the card, the
  un-tuned CSR a PyTorch user has), ``native`` (the port's multithreaded
  C++ CSR on the host, ``native.csr_spmv``: the reference's MKL-adapter
  role), ``scipy`` (scipy.sparse CSR on the host);
- env ``OUTER_LOOPS`` (default 5) and ``LOOPS`` (default 128), like the
  reference; ``NUM_THREADS`` / ``XFORM_CONF`` etc. are honored through
  ``options_set_from_env`` (the default value type is float64);
- a timed step is the product and then the renorm ``y * rsqrt(mean(y*y) +
  1e-30)``, ``LOOPS`` steps chained (on the device adapters the renorm is
  three more small kernels a step; both pay them); the device adapters are
  timed with CUDA events around the chain, the host adapters with
  ``perf_counter``;
- throughput MFLOPS = 2*nnz*LOOPS / (1e6 * median(t)) over OUTER_LOOPS
  timings; ``pt`` is the tuning wall time (ref ``SparsexModule.cpp:45-50``);
- every adapter's result is cross-checked against the first one's at
  max(1e-7, 3e-7) relative tolerance (ref ``Bench.cpp:256-263``); a
  failed check gives exit code 1.

The device adapters run on ``--device`` (default ``cuda:0``; ``cpu`` runs
the port's plain PyTorch versions and torch's CPU CSR product); without
the CUDA device asked for, or on a malformed ``--device``, the tool exits
2.
"""

import argparse
import json
import os
import statistics
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LOOPS = int(os.environ.get("LOOPS", "128"))
OUTER_LOOPS = int(os.environ.get("OUTER_LOOPS", "5"))
CHECK_TOL = 1e-7  # ref src/bench/Bench.cpp:256-263


def _renorm(y):
    """The chained step's renorm (the reference's)."""
    import torch
    if isinstance(y, torch.Tensor):
        return y * torch.rsqrt(torch.mean(y * y) + 1e-30)
    return y / max(float(np.sqrt(np.mean(y * y))), 1e-30)


def time_loops(adapter, x, loops, outer):
    """median over ``outer`` of (seconds for ``loops`` chained calls):
    CUDA events around the chain on a CUDA adapter, else the host clock."""
    import torch
    cuda = adapter.device is not None and adapter.device.type == "cuda"
    adapter.result(adapter(x))  # warm up: kernel build, graph capture
    ts = []
    for _ in range(outer):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        v = x
        for _ in range(loops):
            v = adapter(v, renorm=True)
        if cuda:
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e-3)
        else:
            ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts))


class _TorchAdapter:
    """An adapter on a torch device: x and y are tensors there."""

    device = None

    def prepare(self, x):
        import torch
        return torch.as_tensor(x, device=self.device)

    def result(self, y):
        return y.double().cpu().numpy()


class _HostAdapter:
    """An adapter on the host: x and y are numpy arrays."""

    device = None

    def prepare(self, x):
        return np.asarray(x)

    def result(self, y):
        return np.asarray(y, dtype=np.float64)


class SparsexAdapter(_TorchAdapter):
    """The library under test (ref SparsexModule.cpp): ``mat_tune`` onto
    the device; a call is the executor's (a CUDA graph replay on the
    card)."""

    name = "sparsex"

    def __init__(self, mmf, device):
        import torch

        import sparsex_tpu_torch as spx
        t0 = time.perf_counter()
        inp = spx.api.Input(kind="mmf", mmf=mmf)
        self.mat = spx.mat_tune(inp, device=device)
        if self.mat.device.type == "cuda":
            torch.cuda.synchronize(self.mat.device)
        self.pt = time.perf_counter() - t0
        self.size = self.mat.csx.csx_size()
        self.device = self.mat.device
        self._mv = self.mat.csx.matvec

    def __call__(self, x, renorm=False):
        y = self._mv(x)
        return _renorm(y) if renorm else y


def _csr_arrays(mmf):
    """(rowptr int64, cols, vals) of the file's matrix, rows sorted."""
    rows, cols, vals = mmf.tocoo()
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    order = np.lexsort((cols, rows))
    rowptr = np.zeros(mmf.nrows + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(rows, minlength=mmf.nrows))
    return rowptr, cols[order], np.asarray(vals)[order]


class CsrAdapter(_TorchAdapter):
    """Un-tuned CSR on the same device: torch's own sparse CSR product
    (cuSPARSE on the card)."""

    name = "csr"

    def __init__(self, mmf, device):
        import torch
        rowptr, cols, vals = _csr_arrays(mmf)
        self.pt = 0.0
        self.device = torch.device(device)
        idx = torch.int32 if cols.size < 2 ** 31 else torch.int64
        ib = 4 if idx == torch.int32 else 8
        self.size = int(cols.size * (ib + vals.itemsize)
                        + ib * (mmf.nrows + 1))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # "CSR support is in beta"
            self._A = torch.sparse_csr_tensor(
                torch.as_tensor(rowptr, dtype=idx),
                torch.as_tensor(cols, dtype=idx), torch.as_tensor(vals),
                size=(mmf.nrows, mmf.ncols), device=self.device,
                check_invariants=False)

    def __call__(self, x, renorm=False):
        y = self._A @ x
        return _renorm(y) if renorm else y


class NativeAdapter(_HostAdapter):
    """Multithreaded C++ CSR on the host (the MKL-adapter role)."""

    name = "native"

    def __init__(self, mmf, device):
        from sparsex_tpu_torch import native
        if not native.available():
            raise RuntimeError("native library unavailable")
        rowptr, cols, vals = _csr_arrays(mmf)
        self.pt = 0.0
        self.size = int(cols.size * 12 + 8 * (mmf.nrows + 1))
        self._args = (mmf.nrows, rowptr, cols.astype(np.int32), vals)
        self._native = native

    def __call__(self, x, renorm=False):
        n, rowptr, cols, vals = self._args
        y = self._native.csr_spmv(n, rowptr, cols, vals,
                                  np.asarray(x, dtype=vals.dtype))
        return _renorm(y) if renorm else y


class ScipyAdapter(_HostAdapter):
    """scipy.sparse CSR on the host — a second independent implementation
    (the pOSKI-adapter role)."""

    name = "scipy"

    def __init__(self, mmf, device):
        import scipy.sparse as sp
        rows, cols, vals = mmf.tocoo()
        self.pt = 0.0
        self._A = sp.csr_matrix(
            (np.asarray(vals), (np.asarray(rows), np.asarray(cols))),
            shape=(mmf.nrows, mmf.ncols))
        self.size = int(self._A.data.nbytes + self._A.indices.nbytes
                        + self._A.indptr.nbytes)

    def __call__(self, x, renorm=False):
        y = self._A @ np.asarray(x)
        return _renorm(y) if renorm else y


ADAPTERS = {"sparsex": SparsexAdapter, "csr": CsrAdapter,
            "native": NativeAdapter, "scipy": ScipyAdapter}


def bench_matrix(path, libs, device="cuda:0"):
    import sparsex_tpu_torch as spx
    from sparsex_tpu_torch.io.mmf import load_mmf
    from sparsex_tpu_torch.ops.oracle import max_rel_error

    spx.Config.reset()
    spx.config.options_set_from_env()
    cfg = spx.config.Config.instance()
    mmf = load_mmf(path, index_dtype=cfg.index_dtype,
                   value_dtype=cfg.value_dtype)
    nnz = mmf.nnz
    print(f"Benchmarking matrix: {path} ({mmf.nrows}x{mmf.ncols}, "
          f"nnz={nnz})")
    rng = np.random.default_rng(0)
    x = rng.random(mmf.ncols).astype(cfg.value_dtype)

    results = {}
    ys = {}
    for lib in libs:
        try:
            adapter = ADAPTERS[lib](mmf, device)
        except Exception as e:
            print(f"  {lib}: SKIPPED ({e})")
            continue
        xa = adapter.prepare(x)
        mt = time_loops(adapter, xa, LOOPS, OUTER_LOOPS)
        mflops = 2.0 * nnz * LOOPS / (1e6 * mt)
        ys[lib] = adapter.result(adapter(xa))
        results[lib] = {"pt": adapter.pt, "mt": mt, "mflops": mflops,
                        "size": adapter.size}
        print(f"  {lib}: pt={adapter.pt:.3f}s mt(median)={mt:.4f}s "
              f"r={mflops:.1f} MFLOPS size={adapter.size}B")
        del adapter

    # cross-check all pairs (ref Bench.cpp:256-263)
    names = list(ys)
    for i in range(1, len(names)):
        err = max_rel_error(ys[names[i]], ys[names[0]])
        status = "OK" if err <= max(CHECK_TOL, 3e-7) else "FAILED"
        print(f"  check {names[i]} vs {names[0]}: rel_err={err:.2e} "
              f"[{status}]")
        if status == "FAILED":
            results["check_failed"] = True
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("-f", "--file", help="MatrixMarket file to benchmark")
    g.add_argument("-d", "--directory", help="benchmark every matrix in DIR")
    ap.add_argument("-l", "--libs", default="sparsex,csr",
                    help="comma-separated adapters: sparsex,csr,native,scipy")
    ap.add_argument("--json", action="store_true",
                    help="print one JSON line per matrix")
    ap.add_argument("--device", default="cuda:0",
                    help="the device adapters' device: cuda:N (default "
                         "cuda:0) or cpu")
    args = ap.parse_args(argv)

    libs = [l.strip() for l in args.libs.split(",") if l.strip()]
    for lib in libs:
        if lib not in ADAPTERS:
            ap.error(f"unknown library {lib!r} (have {sorted(ADAPTERS)})")
    from sparsex_tpu_torch.device import resolve_device
    from sparsex_tpu_torch.errors import SparsexError
    try:
        dev = resolve_device(args.device)
    except (SparsexError, RuntimeError) as e:   # no CUDA; a bad --device
        print(f"ERROR: --device {args.device}: {e}", file=sys.stderr)
        return 2

    if args.file:
        paths = [args.file]
    else:
        paths = sorted(
            os.path.join(args.directory, f)
            for f in os.listdir(args.directory)
            if ".mtx" in f)
    failed = False
    for p in paths:
        res = bench_matrix(p, libs, dev)
        failed |= bool(res.pop("check_failed", False))
        if args.json:
            print(json.dumps({"matrix": p, **res}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
