"""Native (C++) host kernels, loaded via ctypes.

The port's own copy of ``sparsex_tpu/native``: ``kernels.cpp`` is the
reference's source, built with the host C++ compiler (``$CXX``, default
``g++``) on first use into the gitignored ``sparsex_tpu_torch/_build/``
(never next to the reference's library), and each entry point keeps the
reference's pure-NumPy fallback, which gives the same results where no
compiler is found.  These are host kernels of the planners, not device
code.

Set ``SPARSEX_TPU_NO_NATIVE=1`` to force the NumPy fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "kernels.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_ABI_VERSION = 5
# Versioned filename: dlopen caches by path and never unmaps, so rebuilding
# over a loaded .so would hand back the stale mapping (or SIGBUS).  A new
# ABI gets a new path; old files just linger.
_LIB_PATH = os.path.join(_BUILD_DIR, f"libspx_host_v{_ABI_VERSION}.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    """Compile kernels.cpp into the build directory.  Returns True on success.

    Compiles to a process-unique tempfile and os.rename()s it over the
    target (atomic on POSIX), so a concurrent process that already mapped
    the .so never sees a truncated file and a racing builder loads either
    the old or the new complete library.
    """
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
    except OSError:
        return False
    cmd = [
        os.environ.get("CXX", "g++"), "-O3", "-shared", "-fPIC",
        "-std=c++17", "-pthread", "-o", tmp, _SRC,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.rename(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _bind(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_longlong)
    i32p = ctypes.POINTER(ctypes.c_int)
    f64p = ctypes.POINTER(ctypes.c_double)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_ubyte)

    lib.spx_native_abi_version.restype = ctypes.c_int
    lib.spx_parse_mmf_body.restype = ctypes.c_longlong
    lib.spx_parse_mmf_body.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        i64p, i64p, f64p]
    lib.spx_segment_runs.restype = ctypes.c_longlong
    lib.spx_segment_runs.argtypes = [i64p, i64p, ctypes.c_longlong,
                                     i64p, i64p, i64p, u8p]
    lib.spx_lexsort_rc.restype = None
    lib.spx_lexsort_rc.argtypes = [i64p, i64p, ctypes.c_longlong, i64p]
    lib.spx_csr_spmv_f64.restype = None
    lib.spx_csr_spmv_f64.argtypes = [
        ctypes.c_longlong, i64p, i32p, f64p, f64p,
        ctypes.c_double, ctypes.c_double, f64p, ctypes.c_int]
    lib.spx_csr_spmv_f32.restype = None
    lib.spx_csr_spmv_f32.argtypes = [
        ctypes.c_longlong, i64p, i32p, f32p, f32p,
        ctypes.c_float, ctypes.c_float, f32p, ctypes.c_int]
    lib.spx_mark_covered.restype = None
    lib.spx_mark_covered.argtypes = [i64p, i64p, ctypes.c_longlong,
                                     ctypes.c_longlong, u8p]
    lib.spx_permute.restype = None
    lib.spx_permute.argtypes = [ctypes.c_char_p, ctypes.c_char_p, i64p,
                                ctypes.c_longlong, ctypes.c_longlong,
                                ctypes.c_int]
    lib.spx_pad_units_f32.restype = None
    lib.spx_pad_units_f32.argtypes = [f32p, i64p, i64p, ctypes.c_longlong,
                                      ctypes.c_longlong, f32p, ctypes.c_int]
    lib.spx_pad_units_f64.restype = None
    lib.spx_pad_units_f64.argtypes = [f64p, i64p, i64p, ctypes.c_longlong,
                                      ctypes.c_longlong, f64p, ctypes.c_int]
    lib.spx_select_units.restype = ctypes.c_longlong
    lib.spx_select_units.argtypes = [i64p, i64p, i64p, u8p,
                                     ctypes.c_longlong, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_longlong,
                                     i64p, ctypes.c_longlong,
                                     i64p, i64p, i64p, u8p]
    lib.spx_color_bipartite.restype = ctypes.c_longlong
    lib.spx_color_bipartite.argtypes = [
        ctypes.c_longlong, i64p, i64p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, i64p]


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried or os.environ.get("SPARSEX_TPU_NO_NATIVE"):
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        needs_build = (not os.path.exists(_LIB_PATH)
                       or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC))
        if needs_build and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            if lib.spx_native_abi_version() != _ABI_VERSION:
                return None  # path is ABI-versioned; mismatch = corrupt
            _bind(lib)
            _lib = lib
        except (OSError, AttributeError):
            _lib = None
    return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# parse_mmf_body
# ---------------------------------------------------------------------------
def parse_mmf_body(text: str, nnz: int, with_vals: bool = True):
    """Parse `nnz` coordinate entries from MMF body text.

    Returns (rows, cols, vals, count); count < 0 signals a parse error at
    byte -(count+1).  Falls back to None when the native lib is unavailable
    (callers then use np.loadtxt).
    """
    lib = get_lib()
    if lib is None:
        return None
    buf = text.encode("utf-8")
    # Parse one extra slot so files with MORE than the declared nnz entries
    # come back with count == nnz + 1 and are rejected by the caller.
    cap = nnz + 1
    rows = np.empty(cap, dtype=np.int64)
    cols = np.empty(cap, dtype=np.int64)
    vals = np.empty(cap if with_vals else 1, dtype=np.float64)
    n = lib.spx_parse_mmf_body(
        buf, len(buf), cap, 1 if with_vals else 0,
        _ptr(rows, ctypes.c_longlong), _ptr(cols, ctypes.c_longlong),
        _ptr(vals, ctypes.c_double))
    n = int(n)
    if n != nnz:
        return rows[:0], cols[:0], (vals[:0] if with_vals else None), n
    return rows[:nnz], cols[:nnz], (vals[:nnz] if with_vals else None), n


# ---------------------------------------------------------------------------
# segment_runs
# ---------------------------------------------------------------------------
def segment_runs(trows: np.ndarray, tcols: np.ndarray):
    """Native DRLE segment scan; returns (j0, f, delta, adjacent) or None."""
    lib = get_lib()
    if lib is None:
        return None
    m = trows.size
    if m < 2:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, np.zeros(0, dtype=bool)
    trows = np.ascontiguousarray(trows, dtype=np.int64)
    tcols = np.ascontiguousarray(tcols, dtype=np.int64)
    j0 = np.empty(m - 1, dtype=np.int64)
    f = np.empty(m - 1, dtype=np.int64)
    delta = np.empty(m - 1, dtype=np.int64)
    adjacent = np.empty(m - 1, dtype=np.uint8)
    n = lib.spx_segment_runs(
        _ptr(trows, ctypes.c_longlong), _ptr(tcols, ctypes.c_longlong), m,
        _ptr(j0, ctypes.c_longlong), _ptr(f, ctypes.c_longlong),
        _ptr(delta, ctypes.c_longlong), _ptr(adjacent, ctypes.c_ubyte))
    # Views, not copies: the buffers are transient mining scratch and the
    # slack past n is small relative to the copy cost on big matrices.
    return j0[:n], f[:n], delta[:n], adjacent[:n].view(bool)


# ---------------------------------------------------------------------------
# lexsort_rc
# ---------------------------------------------------------------------------
def lexsort_rc(rows: np.ndarray, cols: np.ndarray):
    """Permutation sorting (rows, cols) row-major, or None (fallback:
    np.lexsort((cols, rows)))."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    order = np.empty(rows.size, dtype=np.int64)
    lib.spx_lexsort_rc(_ptr(rows, ctypes.c_longlong),
                       _ptr(cols, ctypes.c_longlong), rows.size,
                       _ptr(order, ctypes.c_longlong))
    return order


# ---------------------------------------------------------------------------
# csr_spmv
# ---------------------------------------------------------------------------
def csr_spmv(nrows: int, rowptr, colind, values, x, alpha=1.0, beta=0.0,
             y=None, nthreads: Optional[int] = None):
    """Multithreaded native CSR SpMV, or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    values = np.ascontiguousarray(values)
    dt = values.dtype
    if dt not in (np.dtype(np.float64), np.dtype(np.float32)):
        return None
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    colind = np.ascontiguousarray(colind, dtype=np.int32)
    x = np.ascontiguousarray(x, dtype=dt)
    out = (np.zeros(nrows, dtype=dt) if y is None
           else np.ascontiguousarray(y, dtype=dt).copy())
    if nthreads is None:
        nthreads = min(16, os.cpu_count() or 1)
    if dt == np.dtype(np.float64):
        lib.spx_csr_spmv_f64(
            nrows, _ptr(rowptr, ctypes.c_longlong),
            _ptr(colind, ctypes.c_int), _ptr(values, ctypes.c_double),
            _ptr(x, ctypes.c_double), float(alpha), float(beta),
            _ptr(out, ctypes.c_double), int(nthreads))
    else:
        lib.spx_csr_spmv_f32(
            nrows, _ptr(rowptr, ctypes.c_longlong),
            _ptr(colind, ctypes.c_int), _ptr(values, ctypes.c_float),
            _ptr(x, ctypes.c_float), float(alpha), float(beta),
            _ptr(out, ctypes.c_float), int(nthreads))
    return out


# ---------------------------------------------------------------------------
# mark_covered
# ---------------------------------------------------------------------------
def mark_covered(start_elem: np.ndarray, count: np.ndarray, m: int):
    """covered mask over m sorted elements, or None."""
    lib = get_lib()
    if lib is None:
        return None
    start_elem = np.ascontiguousarray(start_elem, dtype=np.int64)
    count = np.ascontiguousarray(count, dtype=np.int64)
    covered = np.empty(m, dtype=np.uint8)
    lib.spx_mark_covered(
        _ptr(start_elem, ctypes.c_longlong), _ptr(count, ctypes.c_longlong),
        start_elem.size, m, _ptr(covered, ctypes.c_ubyte))
    return covered.astype(bool)


# ---------------------------------------------------------------------------
# permute
# ---------------------------------------------------------------------------
def permute(arr: np.ndarray, order: np.ndarray):
    """dst[i] = arr[order[i]] (threaded), or None when unavailable.

    1-D contiguous arrays only; falls back to numpy fancy indexing.
    """
    lib = get_lib()
    if lib is None or arr.ndim != 1 or not arr.flags.c_contiguous:
        return None
    order = np.ascontiguousarray(order, dtype=np.int64)
    out = np.empty(order.size, dtype=arr.dtype)
    lib.spx_permute(
        arr.ctypes.data_as(ctypes.c_char_p),
        out.ctypes.data_as(ctypes.c_char_p),
        _ptr(order, ctypes.c_longlong), order.size, arr.itemsize,
        min(16, os.cpu_count() or 1))
    return out


def take1(arr, order):
    """arr[order] with the native threaded kernel when possible."""
    arr = np.ascontiguousarray(arr)
    if order.size > (1 << 15):
        out = permute(arr, order)
        if out is not None:
            return out
    return arr[order]


def pad_units(vals: np.ndarray, heads: np.ndarray, sizes: np.ndarray,
              width: int):
    """(U, width) zero-padded unit values: padded[u,:sizes[u]] =
    vals[heads[u]:+sizes[u]].  Native threaded; None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals)
    if vals.dtype == np.float32:
        fn, ct = lib.spx_pad_units_f32, ctypes.c_float
    elif vals.dtype == np.float64:
        fn, ct = lib.spx_pad_units_f64, ctypes.c_double
    else:
        return None
    heads = np.ascontiguousarray(heads, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    out = np.empty((heads.size, width), dtype=vals.dtype)
    fn(_ptr(vals, ct), _ptr(heads, ctypes.c_longlong),
       _ptr(sizes, ctypes.c_longlong), heads.size, width,
       _ptr(out, ct), min(16, os.cpu_count() or 1))
    return out


def select_units(j0, f, delta, adjacent, m, min_limit, max_limit,
                 allowed_deltas=None):
    """Run->unit selection (absorb rule, unit splitting, coverage) in one
    native pass.  Returns (heads, sizes, udelta, covered) or None."""
    lib = get_lib()
    if lib is None:
        return None
    nruns = j0.size
    j0 = np.ascontiguousarray(j0, dtype=np.int64)
    f = np.ascontiguousarray(f, dtype=np.int64)
    delta = np.ascontiguousarray(delta, dtype=np.int64)
    adjacent = np.ascontiguousarray(adjacent, dtype=np.uint8)
    cap = nruns + m // max(1, max_limit) + 2
    heads = np.empty(cap, dtype=np.int64)
    sizes = np.empty(cap, dtype=np.int64)
    udelta = np.empty(cap, dtype=np.int64)
    covered = np.empty(m, dtype=np.uint8)
    if allowed_deltas is not None:
        allowed = np.ascontiguousarray(np.sort(np.asarray(
            allowed_deltas, dtype=np.int64)))
        ap, na = _ptr(allowed, ctypes.c_longlong), allowed.size
    else:
        allowed, ap, na = None, None, 0
    nu = lib.spx_select_units(
        _ptr(j0, ctypes.c_longlong), _ptr(f, ctypes.c_longlong),
        _ptr(delta, ctypes.c_longlong), _ptr(adjacent, ctypes.c_ubyte),
        nruns, m, min_limit, max_limit, ap, na,
        _ptr(heads, ctypes.c_longlong), _ptr(sizes, ctypes.c_longlong),
        _ptr(udelta, ctypes.c_longlong), _ptr(covered, ctypes.c_ubyte))
    nu = int(nu)
    return heads[:nu], sizes[:nu], udelta[:nu], covered.view(bool)


# ---------------------------------------------------------------------------
# color_bipartite
# ---------------------------------------------------------------------------
def _color_bipartite_py(src: np.ndarray, dst: np.ndarray, n_src: int,
                        n_dst: int, w: int) -> np.ndarray:
    """Pure-Python Euler-split edge coloring (mirror of the C++ kernel; used
    when the native lib is unavailable — fine at test sizes)."""
    m = src.size
    color = np.zeros(m, dtype=np.int64)
    if m == 0:
        return color

    def split(edge_ids, c0, width):
        if width == 1:
            color[edge_ids] = c0
            return
        # adjacency: node -> list of edge positions
        adj: dict = {}
        for i, e in enumerate(edge_ids):
            adj.setdefault(int(src[e]), []).append(i)
            adj.setdefault(n_src + int(dst[e]), []).append(i)
        used = np.zeros(len(edge_ids), dtype=bool)
        ptr = {nd: 0 for nd in adj}
        side = np.zeros(len(edge_ids), dtype=np.uint8)

        def walk(start):
            at, s = start, 0
            while True:
                lst = adj[at]
                p = ptr[at]
                while p < len(lst) and used[lst[p]]:
                    p += 1
                ptr[at] = p
                if p == len(lst):
                    return
                i = lst[p]
                used[i] = True
                side[i] = s
                s ^= 1
                e = edge_ids[i]
                at = n_src + int(dst[e]) if at == int(src[e]) else int(src[e])

        for nd, lst in adj.items():
            if len(lst) % 2:
                walk(nd)
        for nd in adj:
            walk(nd)
        ids = np.asarray(edge_ids)
        split(ids[side == 0], c0, width // 2)
        split(ids[side == 1], c0 + width // 2, width // 2)

    split(np.arange(m, dtype=np.int64), 0, w)
    return color


def color_bipartite(src: np.ndarray, dst: np.ndarray, n_src: int,
                    n_dst: int, w: int) -> Optional[np.ndarray]:
    """Proper edge coloring of the bipartite multigraph (src[i] -> dst[i])
    with ``w`` colors (w a power of two; max degree must be <= w).

    Returns the per-edge color array, or None if a degree exceeds w.
    """
    m = src.size
    deg_ok = w > 0 and (w & (w - 1)) == 0
    if not deg_ok:
        raise ValueError(f"w must be a power of two, got {w}")
    lib = get_lib()
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    if lib is None:
        if (m and (np.bincount(src, minlength=1).max() > w
                   or np.bincount(dst, minlength=1).max() > w)):
            return None
        return _color_bipartite_py(src, dst, n_src, n_dst, w)
    color = np.empty(m, dtype=np.int64)
    rc = lib.spx_color_bipartite(
        m, _ptr(src, ctypes.c_longlong), _ptr(dst, ctypes.c_longlong),
        int(n_src), int(n_dst), int(w), _ptr(color, ctypes.c_longlong))
    if rc == -2:
        return None
    if rc != 0:
        raise RuntimeError(f"spx_color_bipartite failed: rc={rc}")
    return color
