"""What every kernel wrapper of the port shares.

The argument checks, the cpu/cuda route, the launch through the ctypes
library of ``ops/_build.py`` and the launch counter ``launches``: each
wrapper adds one to ``launches[name]`` where it launches its CUDA kernel,
and nowhere else, so a caller can show which kernels a run used (re-exported
as ``ops.fused.launches``).  A replay of an executor's CUDA graph runs no
Python and adds nothing: only the first call per graph, its warm-up and
its capture, is counted (``ops/exec.CsxExecutor._replayed``).
"""

from __future__ import annotations

import functools
from collections import Counter
from typing import Tuple

import torch

L = 128                          # lanes per row of every tile grid
MAX_KB = 8   # columns per k-batched kernel launch (exec.py:59 MM_FUSED_KB)

launches: Counter = Counter()

_SFX = {torch.float32: "f32", torch.float64: "f64"}


def _check(name: str, t: torch.Tensor, dtype=None, shape=None,
           device=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _value_dtype(name: str, t: torch.Tensor) -> None:
    if t.dtype not in _SFX:
        raise TypeError(f"{name}: value dtype {t.dtype} is not supported "
                        "(float32 and float64 only)")


def _batch(name: str, t: torch.Tensor, dims: int) -> int:
    """0 for a ``dims``-dimensional operand, kb for a k-batched one with a
    leading axis of kb <= MAX_KB columns; anything else raises."""
    if t.dim() == dims:
        return 0
    if t.dim() == dims + 1 and 1 <= t.shape[0] <= MAX_KB:
        return t.shape[0]
    raise ValueError(f"{name}: shape {tuple(t.shape)} is neither {dims}-D "
                     f"nor a batch of 1..{MAX_KB} such operands")


def _route(device: torch.device) -> str:
    """"cpu" -> plain version, "cuda" -> kernel; anything else raises."""
    if device.type in ("cpu", "cuda"):
        return device.type
    raise ValueError(f"no kernel for device {device}")


def _launch(kernel: str, dtype: torch.dtype, *args) -> None:
    """Launch ``spx_{kernel}_{f32|f64}`` on the CUDA runtime's current
    device, with the stream among ``args``.  An executor call makes the
    matrix's device current once around all its launches
    (``CsxExecutor._on_device``); a wrapper called directly, outside an
    executor (the tests, ``chip_smoke.py``'s kernel phases), runs on the
    current device, so its caller keeps that the operands' device."""
    from sparsex_tpu_torch.ops import _build
    lib = _build.library()
    fn = getattr(lib, f"spx_{kernel}_{_SFX[dtype]}")
    _build.check(lib, fn(*args), kernel)
    launches[kernel] += 1


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=64)
def _offsets_tensor(offsets: Tuple[int, ...], device: str):
    """Device copy of a static offset tuple, made once per tuple."""
    return torch.tensor(offsets, dtype=torch.int32, device=device)
