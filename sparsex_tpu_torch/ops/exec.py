"""Device execution of one encoded partition on PyTorch.

Counterpart of ``CsxExecutor`` (``sparsex_tpu/ops/exec.py:204``).  The host
half is the reference's own: :meth:`CsxExecutor.from_reference` calls the
reference executor's ``_maybe_build_pages()`` (host planning, NumPy and
C++) and uploads the resulting plan once through
:func:`~sparsex_tpu_torch.ops.convert.plan_to_torch`.  It reads
``_pages_meta`` / ``_pages_arrays`` (or ``meta`` / ``arrays``) directly and
never calls ``_pages_active`` or ``__call__``, which reach JAX.  PyTorch
runs eagerly, so there is no per-signature compile cache to port.

The variant gate (the counterpart of ``_pages_active``, exec.py:827-849,
and of the pick in ``__call__``, :889-892) is simpler on the card: the
paged variant runs whenever the planner made one, the plain-table variant
otherwise, in float32 and float64 alike.  The reference's float32-only gate
(``pallas_dtype_ok``: Mosaic tiles are f32) and its DIA policy
(``_resolve_use_pallas``, :171-201, whose constants are TPU measurements)
are not carried over: on the card the DIA kernel always runs, at any
number of diagonals.
"""

from __future__ import annotations

import numpy as np
import torch

from sparsex_tpu_torch.ops.convert import plan_to_torch
from sparsex_tpu_torch.ops.kernels import check_slice, local_contrib

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class CsxExecutor:
    """Callable SpMV executor for one partition's plan on a device."""

    def __init__(self, meta, arrays, nrows: int, ncols: int,
                 dtype: torch.dtype, device: torch.device,
                 variant: str = "paged"):
        self.meta = meta
        self.variant = variant    # "paged" or "plain" (the plain tables)
        self.arrays = arrays
        self.nrows = nrows
        self.ncols = ncols
        self.dtype = dtype
        self.device = device

    @classmethod
    def from_reference(cls, ref, device) -> "CsxExecutor":
        """Plan on the host with the reference executor ``ref`` and upload
        the paged plan, or the plain tables when the planner made none, to
        ``device``; raises ``NotImplementedError`` for a plan outside the
        ported slice."""
        if ref._dtype not in _DTYPES:
            raise NotImplementedError(
                f"value dtype {ref._dtype} is not ported (float32 and "
                "float64 only; bf16 compute-in-f32 is ROADMAP.md Queue 1 "
                "item 4)")
        ref._maybe_build_pages()
        if ref._pages_meta is not None:
            variant, meta, host = "paged", ref._pages_meta, ref._pages_arrays
        else:
            variant, meta, host = "plain", ref.meta, ref.arrays
        check_slice(meta)
        dtype = _DTYPES[ref._dtype]
        arrays = plan_to_torch(meta, host, device, dtype)
        return cls(meta, arrays, ref.tables.nrows, ref.tables.ncols, dtype,
                   torch.device(device), variant)

    def __call__(self, x, alpha=1.0, beta=0.0, y=None):
        """``alpha * A @ x + beta * y``; the epilogue is elided when alpha
        is 1 and when beta is 0 or y is absent (exec.py:894-907)."""
        x = self._as_vector(x, "x")
        acc = local_contrib(self.meta, self.arrays, x,
                            nrows_part=self.nrows, ncols=self.ncols)
        apply_alpha = not (isinstance(alpha, (int, float))
                           and float(alpha) == 1.0)
        apply_beta = not (y is None or (isinstance(beta, (int, float))
                                        and float(beta) == 0.0))
        if apply_alpha:
            acc = acc * alpha
        if apply_beta:
            acc = acc + beta * self._as_vector(y, "y")
        return acc

    def _as_vector(self, v, name: str) -> torch.Tensor:
        """``v`` as a tensor of the plan's dtype on the plan's device."""
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                raise NotImplementedError(
                    f"bf16 {name} is not ported (ROADMAP.md Queue 1 item 4)")
            if v.device != self.device:
                raise ValueError(f"{name} is on {v.device}; the matrix is "
                                 f"on {self.device}")
            return v.to(self.dtype).contiguous()
        a = np.asarray(v)
        if a.dtype.kind not in "fiu":
            raise TypeError(f"{name}: dtype {a.dtype} is not numeric")
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)
