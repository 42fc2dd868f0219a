"""Self-building loader for the CUDA kernels in ``sparsex_tpu_torch/csrc``.

Counterpart of the self-building loader in ``sparsex_tpu/native/__init__.py``
with one deliberate difference: there is no fallback.  At first use the
sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc``
process per source, all started together, and linked into one shared
library with a plain C interface, named by a hash of the sources and flags
and cached under ``sparsex_tpu_torch/_build/``, then loaded with ``ctypes``.
A missing ``nvcc`` or a failed build raises :class:`KernelBuildError`
carrying nvcc's output; the kernels' CPU versions are reached only through
CPU tensors, never because a build failed.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build
build_log: str = ""                     # nvcc/ptxas output of that build


class KernelBuildError(RuntimeError):
    """nvcc is missing or the CUDA sources did not compile or load."""


def sources() -> list:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else the
    ``nvcc`` on ``PATH``; raises :class:`KernelBuildError` if neither."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise KernelBuildError(
        f"nvcc not found (looked in {cand} and on PATH); the CUDA kernels "
        "of sparsex_tpu_torch are built from source at first use")


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as fp:
            h.update(os.path.basename(src).encode())
            h.update(fp.read())
    return os.path.join(BUILD_DIR, f"libspx_kernels_{h.hexdigest()[:16]}.so")


def _run(cmds):
    """Run the nvcc commands together; raise with the output of the first
    that fails.  Returns their combined output.  No process outlives it."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=BUILD_TIMEOUT_S)[0] for p in procs]
    except (OSError, subprocess.TimeoutExpired) as e:
        raise KernelBuildError(f"nvcc did not run to its end: {e}") from e
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise KernelBuildError(
                f"{' '.join(cmd)} exited {p.returncode}:\n{out}")
    return "".join(outs)


def _compile(out: str) -> None:
    global build_seconds, build_log
    srcs = sources()
    if not srcs:
        raise KernelBuildError(f"no CUDA sources under {SRC_DIR}")
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                    for src, obj in zip(srcs, objs)])
        log += _run([[nvcc, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)   # atomic: a concurrent loader never sees a stub
    finally:   # the objects always, the library only if it was not moved
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.unlink(path)
    build_seconds = time.perf_counter() - t0
    build_log = log


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for sfx in ("f32", "f64"):
        f = getattr(lib, f"spx_k1_{sfx}")
        f.argtypes = [vp, vp, vp, vp, vp, ll, i, vp]
        f.restype = i
        f = getattr(lib, f"spx_k1_rlp_{sfx}")
        f.argtypes = [vp, vp, vp, vp, vp, ll, i, i, vp]
        f.restype = i
        f = getattr(lib, f"spx_lane_gather_{sfx}")
        f.argtypes = [vp, vp, vp, ll, i, vp]
        f.restype = i
        f = getattr(lib, f"spx_t1_{sfx}")
        f.argtypes = [vp, vp, i, vp]
        f.restype = i
        f = getattr(lib, f"spx_k2_{sfx}")
        f.argtypes = [vp, vp, vp, vp, vp, i, i, i, vp]
        f.restype = i
        f = getattr(lib, f"spx_k3_{sfx}")
        f.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(vp),
                      ctypes.POINTER(i), i, vp, vp, i, vp, vp, i, vp, vp,
                      ll, i, vp, vp]
        f.restype = i
    lib.spx_cuda_error_string.argtypes = [i]
    lib.spx_cuda_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = _lib_path()
            if not os.path.exists(path):
                _compile(path)
            try:
                lib = ctypes.CDLL(path)
                _bind(lib)
            except (OSError, AttributeError) as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            _lib = lib
    return _lib


def check(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.spx_cuda_error_string(rc)
        raise RuntimeError(
            f"{kernel} launch failed: CUDA error {rc} "
            f"({msg.decode() if msg else '?'})")
