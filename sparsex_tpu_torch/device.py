"""Device selection for the PyTorch port.

Counterpart of ``sparsex_tpu/platform.py``: the JAX-only platform forcing
(``honor_jax_platforms_env`` / ``force_cpu``) becomes one explicit rule.
With no argument the port runs on the first CUDA device and refuses to
start without one; the CPU, where every kernel runs its plain PyTorch
version, is used only when the caller names it.  ``tune_host_allocator`` is
shared with the reference (the host planners are the same code).
"""

from __future__ import annotations

import ctypes

import torch

from sparsex_tpu_torch.errors import ErrorCode, SparsexError

__all__ = ["resolve_device", "tune_host_allocator"]

_ALLOCATOR_TUNED = False


def tune_host_allocator() -> bool:
    """Raise glibc's mmap/trim thresholds so large preprocessing temporaries
    are recycled from the heap instead of mmap'd and munmap'd per array
    (``sparsex_tpu/platform.py:47`` has the reason and its measurement).

    Returns True when mallopt was applied.  Idempotent; no-op on
    non-glibc platforms.
    """
    global _ALLOCATOR_TUNED
    if _ALLOCATOR_TUNED:
        return True
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        ok = libc.mallopt(M_MMAP_THRESHOLD, 32 * 1024 * 1024)
        ok &= libc.mallopt(M_TRIM_THRESHOLD, 512 * 1024 * 1024)
        _ALLOCATOR_TUNED = bool(ok)
    except Exception:
        return False
    return _ALLOCATOR_TUNED


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0`` (``SparsexError`` when CUDA is absent); a
    named ``"cpu"`` or ``"cuda[:i]"`` device is checked and returned."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SparsexError(
                ErrorCode.SPX_ERR_SYSTEM,
                "no CUDA device: sparsex_tpu_torch runs on a GPU by default; "
                "pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise SparsexError(ErrorCode.SPX_ERR_ARG_INVALID,
                               f"no CUDA device {dev}")
        return dev
    if dev.type == "cpu":
        return dev
    raise SparsexError(ErrorCode.SPX_ERR_ARG_INVALID,
                       f"unsupported device {dev} (cuda or cpu)")
