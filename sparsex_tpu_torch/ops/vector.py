"""Vector algebra (BLAS-1 parity API) on torch tensors.

Counterpart of ``sparsex_tpu/ops/vector.py`` (the reference library's
``Vector.hpp:38-81``, ``Vector.cpp``; public surface ``spx_vec_*`` in
``src/api/matvec.c:763-1001``): create (zero, from a user buffer, random),
set an entry, scale, scale-add, add, sub, multiply (dot), each also on a
part ``[start, end)``, reorder / inverse-reorder by a permutation, compare
at 1e-6 relative tolerance, print.

Every function takes and returns torch tensors; the constructors take an
explicit ``device`` (``None`` is ``cuda:0``, as for ``mat_tune``), and
``create_random`` an explicit ``torch.Generator`` or a seed.  A numpy array
or a list given where a vector is expected becomes a tensor on the other
operand's device (the CPU when there is none).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sparsex_tpu_torch.device import resolve_device
from sparsex_tpu_torch.errors import ErrorCode, seterror

COMPARE_TOLERANCE = 1e-6  # ref src/internals/Vector.cpp:51-56


def _t(v, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``v`` as a tensor (on ``like``'s device when it is not one)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v),
                           device=None if like is None else like.device)


def create(size: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """spx_vec_create: a zero vector of the given size."""
    return torch.zeros(size, dtype=dtype, device=resolve_device(device))


def create_from_buff(buff, copy: bool = False, device=None) -> torch.Tensor:
    """spx_vec_create_from_buff: the buffer as a tensor on ``device``
    (SPX_VEC_AS_IS: sharing its memory where it already lies there), or a
    copy of it (SPX_VEC_TUNE)."""
    v = torch.as_tensor(buff, device=resolve_device(device))
    return v.clone() if copy else v


def create_random(size: int, low: float = 0.0, high: float = 1.0,
                  dtype=torch.float64, device=None,
                  generator: Optional[torch.Generator] = None,
                  seed: Optional[int] = None) -> torch.Tensor:
    """spx_vec_create_random: uniform in [low, high), drawn on the CPU
    from ``generator`` (or a new one seeded with ``seed``) and moved to
    ``device``, so that a seed gives the same vector on every device."""
    if generator is None:
        generator = torch.Generator()
        if seed is not None:
            generator.manual_seed(seed)
    v = torch.rand(size, dtype=torch.float64, generator=generator)
    return (low + (high - low) * v).to(dtype).to(resolve_device(device))


def init(v, val) -> torch.Tensor:
    """spx_vec_init: a vector like ``v`` filled with a scalar."""
    return torch.full_like(_t(v), val)


def init_part(v, val, start: int, end: int) -> torch.Tensor:
    """spx_vec_init_part: a copy of ``v`` with [start, end) set to val."""
    out = _t(v).clone()
    out[start:end] = val
    return out


def set_entry(v, idx: int, val) -> None:
    """spx_vec_set_entry (1-based in the reference C API; 0-based here),
    in place."""
    if idx < 0 or idx >= len(v):
        seterror(ErrorCode.SPX_ERR_OUT_OF_BOUNDS, "vector index out of bounds")
    v[idx] = val


def scale(v, s) -> torch.Tensor:
    """spx_vec_scale: s * v."""
    return _t(v) * s


def scale_add(v1, v2, s) -> torch.Tensor:
    """spx_vec_scale_add: v1 + s * v2."""
    a = _t(v1)
    return a + s * _t(v2, a)


def scale_add_part(v1, v2, s, start: int, end: int) -> torch.Tensor:
    """spx_vec_scale_add_part: v1 with [start, end) += s * v2 there."""
    out = _t(v1).clone()
    out[start:end] += s * _t(v2, out)[start:end]
    return out


def add(v1, v2) -> torch.Tensor:
    """spx_vec_add."""
    a = _t(v1)
    return a + _t(v2, a)


def add_part(v1, v2, start: int, end: int) -> torch.Tensor:
    """spx_vec_add_part (ref ``src/api/matvec.c:903``): v1 with [start,
    end) replaced by v1 + v2 over that range."""
    out = _t(v1).clone()
    out[start:end] += _t(v2, out)[start:end]
    return out


def sub(v1, v2) -> torch.Tensor:
    """spx_vec_sub."""
    a = _t(v1)
    return a - _t(v2, a)


def sub_part(v1, v2, start: int, end: int) -> torch.Tensor:
    """spx_vec_sub_part (ref ``src/api/matvec.c:914``)."""
    out = _t(v1).clone()
    out[start:end] -= _t(v2, out)[start:end]
    return out


def mul(v1, v2) -> torch.Tensor:
    """spx_vec_mul: the dot product (a 0-d tensor)."""
    a = _t(v1)
    return torch.dot(a, _t(v2, a))


def mul_part(v1, v2, start: int, end: int) -> float:
    """spx_vec_mul_part (ref ``src/api/matvec.c:926``): a partial dot."""
    a = _t(v1)
    return float(torch.dot(a[start:end], _t(v2, a)[start:end]))


def copy(v) -> torch.Tensor:
    """spx_vec_copy (ref ``src/api/matvec.c:983``)."""
    return _t(v).clone()


def init_rand_range(v, low: float, high: float,
                    generator: Optional[torch.Generator] = None,
                    seed: Optional[int] = None) -> torch.Tensor:
    """spx_vec_init_rand_range (ref ``src/api/matvec.c:849``): fill v in
    place with uniform values in [low, high) (:func:`create_random`)."""
    v.copy_(create_random(v.numel(), low, high, v.dtype, v.device,
                          generator, seed).view(v.shape))
    return v


def create_interleaved(size: int, partition=None, dtype=torch.float64,
                       device=None) -> torch.Tensor:
    """Partition-aware creation (ref ``VecCreateInterleaved``,
    ``Vector.hpp:41``): the reference places a vector's parts on the NUMA
    nodes of their threads.  The shards of a matrix share one device here,
    so this is a zero vector on ``device``; the partition only documents
    the layout."""
    return create(size, dtype, device)


def reorder(v, perm) -> torch.Tensor:
    """spx_vec_reorder: out[perm[i]] = v[i]."""
    a = _t(v)
    out = torch.zeros_like(a)
    out[_t(perm, a).long()] = a
    return out


def inv_reorder(v, perm) -> torch.Tensor:
    """spx_vec_inv_reorder: out[i] = v[perm[i]]."""
    a = _t(v)
    return a[_t(perm, a).long()]


def compare(v1, v2, tol: float = COMPARE_TOLERANCE) -> bool:
    """spx_vec_compare: relative comparison at 1e-6."""
    a = _t(v1).double().cpu()
    b = _t(v2).double().cpu()
    if a.shape != b.shape:
        return False
    denom = b.abs().clamp_min(1e-30)
    return bool(((a - b).abs() / denom <= tol).all())


def print_vec(v) -> str:
    """spx_vec_print."""
    s = " ".join(f"{float(x):.6g}" for x in _t(v).cpu().tolist())
    print(s)
    return s


def init_from_map(buffers, val, idx_map) -> None:
    """``VecInitFromMap`` parity (ref ``src/internals/CsxSpmv.cpp:66-85``):
    set only the cross-shard slots listed in the reduction map, a sequence
    of (buffer index, element) pairs.  The port's per-shard symmetric
    executor sums its shards' results on the device instead
    (``ops/exec.ShardsExecutor``); this exists for API parity."""
    for b, i in idx_map:
        buffers[b][i] = val


def add_from_map(dst, buffers, idx_map) -> torch.Tensor:
    """``VecAddFromMap`` parity: a copy of ``dst`` with the cross-shard
    slots of every partial buffer added in."""
    out = _t(dst).clone()
    for b, i in idx_map:
        out[i] += buffers[b][i]
    return out


__all__ = ["COMPARE_TOLERANCE", "add", "add_from_map", "add_part", "compare",
           "copy", "create", "create_from_buff", "create_interleaved",
           "create_random", "init", "init_from_map", "init_part",
           "init_rand_range", "inv_reorder", "mul", "mul_part", "print_vec",
           "reorder", "scale", "scale_add", "scale_add_part", "set_entry",
           "sub", "sub_part"]
