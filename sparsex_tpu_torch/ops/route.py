"""The route network's lane gather on PyTorch.

Counterpart of the device half of ``sparsex_tpu/ops/route.py``: the
``_build_lane_gather`` Pallas kernel, here the CUDA kernel of
``csrc/route.cu``.  The planners (``build_scatter_plan`` and the rest) are
the reference's own host code.  ``lane_gather`` launches the kernel on a
CUDA tensor and runs ``lane_gather_plain`` only on a CPU tensor; each
launch adds one to ``ops.fused.launches["lane_gather"]``.
"""

from __future__ import annotations

import torch

from sparsex_tpu_torch.ops.fused import (L, _check, _launch, _route, _stream,
                                         _value_dtype)


def lane_gather_plain(x, idx):
    """``out[r, j] = sum_k (idx[k,r,j] >= 0 ? x[r, idx[k,r,j]] : 0)``, summed
    from 0 in wire order (``route.py:_build_lane_gather``)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    acc = torch.zeros_like(x)
    for k in range(idx.shape[0]):
        w = idx[k].to(torch.int64)
        acc = acc + torch.where(w >= 0, torch.gather(x, 1, w.clamp(min=0)),
                                zero)
    return acc


def lane_gather(x, idx):
    """The lane gather of ``x`` (R, 128) through ``idx`` (K, R, 128) int8
    wires; returns (R, 128)."""
    _value_dtype("x", x)
    if x.dim() != 2 or x.shape[1] != L:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (R, {L})")
    _check("x", x)
    R = x.shape[0]
    if idx.dim() != 3 or idx.shape[0] < 1:
        raise ValueError(f"idx: shape {tuple(idx.shape)}, expected "
                         f"(K, {R}, {L}) with K >= 1")
    _check("idx", idx, torch.int8, (idx.shape[0], R, L), x.device)
    if _route(x.device) == "cpu":
        return lane_gather_plain(x, idx)
    out = torch.empty_like(x)
    _launch("lane_gather", x.dtype, x.data_ptr(), idx.data_ptr(),
            out.data_ptr(), R, idx.shape[0], _stream(x.device))
    return out


__all__ = ["lane_gather", "lane_gather_plain"]
