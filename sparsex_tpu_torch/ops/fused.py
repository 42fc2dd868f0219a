"""The fused pipeline on PyTorch: K1, T1, K2, K3 and their glue.

Counterpart of the traced half of ``sparsex_tpu/ops/fused.py``.  The plan
(static metas and arrays) comes unchanged from the shared NumPy planners
(``build_fused_delta``, ``build_fused_run``, ``merge_segment_plan``,
``pad_dias_for_k3``); only the device half is ported:

- four kernel wrappers, ``k1`` (styles ``lp`` and ``rlp{W}``), ``t1``,
  ``k2``, ``k3``, each launching a CUDA kernel of ``csrc/fused.cu`` on a
  CUDA tensor and running its plain PyTorch version (``k1_plain`` ...) only
  on a CPU tensor;
- the glue with the reference's names and static-meta tuples:
  ``_to_blocks``, ``_k1_x2``, ``fused_delta_a1``, ``_e1s_from_a1``,
  ``fused_delta_e1s``, ``fused_run_a1``, ``fused_run_e1s``, ``merged_e1s``
  (each merged instance's G1 is the lane gather of ``ops/route.py``) and
  ``k3_combine``, plus the residual adds ``add_products`` / ``add_totals``.

Every wrapper adds one to ``launches[name]`` each time it launches its CUDA
kernel, and nowhere else, so a caller can show which kernels a run used.

K2 takes RAW ``g2b`` wires: for unmasked (``um & 1``) plans the lane offset
the Pallas kernel bakes in is removed at upload (``ops/convert.py``).
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from sparsex_tpu.ops.fused import L, MAX_INSTANCES, TILE3

launches: Counter = Counter()

_SFX = {torch.float32: "f32", torch.float64: "f64"}


# ---------------------------------------------------------------------------
# argument checks shared by the wrappers
# ---------------------------------------------------------------------------

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


def _route(device: torch.device) -> str:
    """"cpu" -> plain version, "cuda" -> kernel; anything else raises."""
    if device.type in ("cpu", "cuda"):
        return device.type
    raise ValueError(f"no kernel for device {device}")


def _launch(kernel: str, dtype: torch.dtype, *args) -> None:
    from sparsex_tpu_torch.ops import _build
    lib = _build.library()
    fn = getattr(lib, f"spx_{kernel}_{_SFX[dtype]}")
    _build.check(lib, fn(*args), kernel)
    launches[kernel] += 1


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _q8(q: int) -> int:
    return 1 << max(0, int(q - 1).bit_length())


def _d2r(nrows_part: int) -> int:
    """K3 destination blocks (of 128 pages of 128 rows) for nrows_part."""
    return -(-(-(-nrows_part // L)) // L)


# ---------------------------------------------------------------------------
# K1: lane-placed page-gather product + G1 lane route
# ---------------------------------------------------------------------------

def k1_style(style: str) -> int:
    """The sliding-sum width W of a ported K1 style: 0 for the lane-placed
    ``lp``, W for ``rlp{W}`` (W in 2, 4, 8).  The dense-tile styles ``sl``
    and ``run{W}`` raise ``NotImplementedError``."""
    if style == "lp":
        return 0
    if style.startswith("rlp") and style[3:] in ("2", "4", "8"):
        return int(style[3:])
    raise NotImplementedError(
        f"K1 style {style!r} is not ported yet (the lane-placed 'lp' and "
        "'rlp2'/'rlp4'/'rlp8' styles are); see ROADMAP.md Queue 2, item 1")


def k1_plain(plo, mg, vals, x2, q: int, style: str = "lp"):
    """``out[t,s,l] = g1 >= 0 ? p[t,s,g1] : 0`` with ``g1 = (mg[t,s,l] >> 16)
    - 1`` and the lane products ``p[t,s,l] = x2[page, low&7, l] *
    vals[t,s,l]``, ``low = mg[t,s,l] & 0x3FFF``, ``page = plo[t]*q8 + (low
    >> 3)`` (``fused.py:_build_k1``, style lp).  Style ``rlp{W}`` first adds
    ``roll(p, d)`` along the lanes for d = 1, 2, .. < W (circular), leaving
    each W-lane run's total at its last lane."""
    W = k1_style(style)
    T = mg.shape[0]
    q8 = _q8(q)
    low = mg & 0x3FFF
    pg = low >> 3
    ok = pg < q8 if q8 > 1 else torch.ones_like(pg, dtype=torch.bool)
    page = plo.to(torch.int64).view(T, 1, 1) * q8
    if q8 > 1:
        page = page + torch.where(ok, pg, 0).to(torch.int64)
    lane = torch.arange(L, device=mg.device).view(1, 1, L)
    idx = (page * 8 + (low & 7)) * L + lane
    xv = x2.reshape(-1)[idx]
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    prod = torch.where(ok, xv, zero) * vals
    d = 1
    while d < W:
        prod = prod + torch.roll(prod, d, dims=2)
        d *= 2
    g1 = ((mg >> 16) & 0xFFFF) - 1
    g = torch.gather(prod, 2, g1.clamp(min=0).to(torch.int64))
    return torch.where(g1 >= 0, g, zero)


def k1(plo, mg, vals, x2, q: int, style: str = "lp"):
    """K1 (style ``lp`` or ``rlp{W}``) over a (T, 8, 128) tile stream;
    ``x2`` is the padded page grid (npages, 8, 128), a multiple of the
    window's q8 pages."""
    W = k1_style(style)
    _value_dtype("vals", vals)
    T = mg.shape[0]
    dev = vals.device
    _check("plo", plo, torch.int32, (T,), dev)
    _check("mg", mg, torch.int32, (T, 8, L), dev)
    _check("vals", vals, None, (T, 8, L), dev)
    _check("x2", x2, vals.dtype, None, dev)
    q8 = _q8(q)
    if x2.dim() != 3 or tuple(x2.shape[1:]) != (8, L) or x2.shape[0] % q8:
        raise ValueError(f"x2: shape {tuple(x2.shape)} is not a grid of "
                         f"q8={q8}-page windows")
    if _route(dev) == "cpu":
        return k1_plain(plo, mg, vals, x2, q, style)
    out = torch.empty_like(vals)
    ptrs = (plo.data_ptr(), mg.data_ptr(), vals.data_ptr(), x2.data_ptr(),
            out.data_ptr(), T, q8)
    if W:
        _launch("k1_rlp", vals.dtype, *ptrs, W, _stream(dev))
    else:
        _launch("k1", vals.dtype, *ptrs, _stream(dev))
    return out


# ---------------------------------------------------------------------------
# T1: (A2R*128, 128) -> (A2R, 128, 128) transposed blocks
# ---------------------------------------------------------------------------

def t1_plain(a1, A2R: int):
    """Block ``a`` = ``a1[a*128:(a+1)*128].T`` (``fused.py:_build_t1``)."""
    return a1.view(A2R, L, L).transpose(1, 2).contiguous()


def t1(a1, A2R: int):
    _value_dtype("a1", a1)
    _check("a1", a1, None, (A2R * L, L))
    if _route(a1.device) == "cpu":
        return t1_plain(a1, A2R)
    out = torch.empty((A2R, L, L), dtype=a1.dtype, device=a1.device)
    _launch("t1", a1.dtype, a1.data_ptr(), out.data_ptr(), A2R,
            _stream(a1.device))
    return out


# ---------------------------------------------------------------------------
# K2: the middle stage, per outer color
# ---------------------------------------------------------------------------

def k2_plain(a1t, g2a, g2b, g2c, W2: int, D2R: int):
    """``E1[c,d,l]`` from A1T (A2R, 128, 128) through the raw g2a/g2b/g2c
    wires (``fused.py:_build_k2``; ``route._route_instance_np``)."""
    A2R = a1t.shape[0]
    zero = torch.zeros((), dtype=a1t.dtype, device=a1t.device)
    B = a1t.permute(1, 0, 2)                          # [c, b, j]
    ga = g2a.to(torch.int64)
    C1 = torch.where(ga >= 0, torch.gather(B, 2, ga.clamp(min=0)), zero)
    C1T = C1.transpose(1, 2)[:, :W2]                  # [c, w, b]
    gb = g2b[:, :, :D2R].to(torch.int64)              # [c, w, d]
    D1 = torch.where((gb >= 0) & (gb < A2R),
                     torch.gather(C1T, 2, gb.clamp(0, A2R - 1)), zero)
    D1T = D1.transpose(1, 2)                          # [c, d, w]
    gc = g2c.to(torch.int64)                          # [c, d, l]
    return torch.where((gc >= 0) & (gc < W2),
                       torch.gather(D1T, 2, gc.clamp(0, W2 - 1)), zero)


def k2(a1t, g2a, g2b, g2c, W2: int, D2R: int):
    _value_dtype("a1t", a1t)
    A2R = a1t.shape[0]
    dev = a1t.device
    if not 1 <= A2R <= L or not 1 <= W2 <= L or not 1 <= D2R <= L:
        raise ValueError(f"k2: A2R={A2R}, W2={W2}, D2R={D2R} outside 1..128")
    _check("a1t", a1t, None, (A2R, L, L), dev)
    _check("g2a", g2a, torch.int8, (L, A2R, L), dev)
    _check("g2b", g2b, torch.int8, (L, W2, L), dev)
    _check("g2c", g2c, torch.int8, (L, D2R, L), dev)
    if _route(dev) == "cpu":
        return k2_plain(a1t, g2a, g2b, g2c, W2, D2R)
    out = torch.empty((L, D2R, L), dtype=a1t.dtype, device=dev)
    _launch("k2", a1t.dtype, a1t.data_ptr(), g2a.data_ptr(),
            g2b.data_ptr(), g2c.data_ptr(), out.data_ptr(), A2R, W2, D2R,
            _stream(dev))
    return out


# ---------------------------------------------------------------------------
# K3: G3 fold-resolve + DIA windows + single y write
# ---------------------------------------------------------------------------

def _shifted(x, o: int, n: int, nx: int):
    """``w[r] = x[r + o]`` for r in [0, n), 0 where ``r + o`` is outside
    [0, nx)."""
    lo = max(0, -o)
    start = o + lo
    xp = F.pad(x[:nx], (lo, max(0, start + n - (nx + lo))))
    return xp[start: start + n]


def k3_plain(e1s, g3s, dv, dia_offsets, adv, anti_offsets, xb, xrb,
             ncols: int, D2R: int):
    """``y[i,p,l] = sum_inst sum_k E1[g3[i,k,p,l], i, p]`` (0 where the wire
    is negative) ``+ sum_d dv[i,d,p,l] * x[row + o_d]`` ``+ sum_a
    adv[i,a,p,l] * xr[row + o'_a]``, in the Pallas kernel's order
    (``fused.py:_build_k3``).  Returns (D2R, 128, 128)."""
    ref = next(t for t in (xb, xrb, *e1s) if t is not None)
    zero = torch.zeros((), dtype=ref.dtype, device=ref.device)
    total = torch.zeros((D2R, L, L), dtype=ref.dtype, device=ref.device)
    for e1, g3 in zip(e1s, g3s):
        E2 = e1.permute(1, 2, 0)                      # [i, p, c]
        for k in range(g3.shape[1]):
            idx = g3[:, k].to(torch.int64)
            total = total + torch.where(
                idx >= 0, torch.gather(E2, 2, idx.clamp(min=0)), zero)
    n = D2R * TILE3
    for xs, offs, vals in ((xb, dia_offsets, dv), (xrb, anti_offsets, adv)):
        for d, o in enumerate(offs):
            w = _shifted(xs.reshape(-1), int(o), n, ncols).view(D2R, L, L)
            total = total + vals[:, d] * w
    return total


@functools.lru_cache(maxsize=64)
def _offsets_tensor(offsets: Tuple[int, ...], device: str):
    """Device copy of a static offset tuple, made once per tuple."""
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def _ptr_array(ts: Sequence[torch.Tensor]):
    arr = (ctypes.c_void_p * MAX_INSTANCES)()
    for s, t in enumerate(ts):
        arr[s] = t.data_ptr()
    return arr


def k3(e1s, g3s, dv, dia_offsets, adv, anti_offsets, xb, xrb,
       ncols: int, D2R: int):
    """One K3 over <= 8 routed instances + the DIA tables.

    ``e1s[i]`` (128, D2R, 128), ``g3s[i]`` int8 (D2R, K_i, 128, 128);
    ``dv`` (D2R, D, 128, 128) with static ``dia_offsets``; ``adv`` likewise
    with ``anti_offsets`` already rebased to the reversed-x frame; ``xb`` /
    ``xrb`` the x / reversed-x blocks (``_to_blocks``), read as 0 outside
    [0, ncols)."""
    if len(e1s) != len(g3s) or len(e1s) > MAX_INSTANCES:
        raise ValueError(f"k3: {len(e1s)} E1 / {len(g3s)} g3 operands "
                         f"(at most {MAX_INSTANCES} instances)")
    ref = next((t for t in (xb, xrb, *e1s) if t is not None), None)
    if ref is None:
        raise ValueError("k3: nothing to combine")
    _value_dtype("k3 operands", ref)
    dev, dt = ref.device, ref.dtype
    for e1, g3 in zip(e1s, g3s):
        _check("e1", e1, dt, (L, D2R, L), dev)
        _check("g3", g3, torch.int8, None, dev)
        if g3.dim() != 4 or g3.shape[0] != D2R or g3.shape[2:] != (L, L):
            raise ValueError(f"g3: shape {tuple(g3.shape)}, expected "
                             f"({D2R}, K, {L}, {L})")
    for name, xs, offs, vals in (("dv", xb, dia_offsets, dv),
                                 ("adv", xrb, anti_offsets, adv)):
        if offs:
            _check(name, vals, dt, (D2R, len(offs), L, L), dev)
            _check(name + " x", xs, dt, None, dev)
            if xs.numel() < ncols:
                raise ValueError(f"{name}: x blocks hold {xs.numel()} < "
                                 f"ncols={ncols} values")
    if _route(dev) == "cpu":
        return k3_plain(e1s, g3s, dv, dia_offsets, adv, anti_offsets, xb,
                        xrb, ncols, D2R)
    y = torch.empty((D2R, L, L), dtype=dt, device=dev)
    Ks = (ctypes.c_int * MAX_INSTANCES)(*[g.shape[1] for g in g3s])
    nd, na = len(dia_offsets), len(anti_offsets)
    doff = _offsets_tensor(tuple(dia_offsets), str(dev)) if nd else None
    aoff = _offsets_tensor(tuple(anti_offsets), str(dev)) if na else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    _launch("k3", dt, _ptr_array(e1s), _ptr_array(g3s), Ks, len(e1s),
            ptr(dv) if nd else None, ptr(doff), nd,
            ptr(adv) if na else None, ptr(aoff), na,
            ptr(xb) if nd else None, ptr(xrb) if na else None, ncols, D2R,
            y.data_ptr(), _stream(dev))
    return y


# ---------------------------------------------------------------------------
# glue (same names and static metas as sparsex_tpu/ops/fused.py)
# ---------------------------------------------------------------------------

def _to_blocks(x):
    """x (n,) -> ((nb, 128, 128) blocks, nb); zero-pads only when ragged
    (``fused.py:1568``)."""
    n = x.shape[0]
    nb = max(-(-n // TILE3), 1)
    xp = F.pad(x, (0, nb * TILE3 - n)) if nb * TILE3 != n else x
    return xp.reshape(nb, L, L), nb


def lp_window(q: int, npages: int) -> Tuple[int, int]:
    """``(q8, npages_pad)`` of a lane-placed K1 part: its window of ``q``
    pages rounded up to a power of two, and its page grid rounded up to a
    multiple of that window."""
    q8 = _q8(q)
    return q8, max(-(-npages // q8) * q8, q8)


def page_grid(x, ncols: int, npages: int):
    """x as an (npages, 8, L) page grid, zero-padded past ``ncols``."""
    if npages * 1024 == ncols:
        return x.reshape(npages, 8, L)
    return F.pad(x[:ncols], (0, npages * 1024 - ncols)).reshape(
        npages, 8, L)


def _k1_x2(x, ncols: int, q: int, npages: int, x2):
    """The page grid an ``lp`` or ``rlp`` K1 part reads (both lane-placed,
    ``fused.py:1598``); reuses a caller-shared grid when it is large enough
    and a multiple of this window's q8 (``fused.py:1591``)."""
    q8, npages_pad = lp_window(q, npages)
    if (x2 is not None and x2.shape[0] >= npages_pad
            and x2.shape[0] % q8 == 0):
        return x2
    return page_grid(x, ncols, npages_pad)


def fused_delta_a1(meta, arrays, x, ncols: int, x2=None):
    """K1 only: the delta segment's (T*8, L) routed grid.  Hybrid plans
    (``meta[7]`` set) run K1 twice, bulk and tail, and re-interleave the
    two outputs fold-major through the static slice list
    (``fused.py:1627``, :1647-1663)."""
    T, q, npages = meta[:3]
    style = meta[6] if len(meta) > 6 else "sl"
    pm = meta[7] if len(meta) > 7 else None
    k1_style(style)
    if x.dim() != 1:
        raise NotImplementedError("k-batched (SpMM) K1 is not ported yet; "
                                  "see ROADMAP.md Queue 2, item 6")
    if pm is None:
        x2 = _k1_x2(x, ncols, q, npages, x2)
        a1 = k1(arrays["plo"], arrays["mg"], arrays["vals"], x2, q, style)
        return a1.reshape(T * 8, L)
    (T2, q2, npages2, style2), inter = pm
    k1_style(style2)
    # one shared page grid, aligned for the LARGER window
    x2 = _k1_x2(x, ncols, max(q, q2), max(npages, npages2), x2)
    a1a = k1(arrays["plo"], arrays["mg"], arrays["vals"], x2, q, style)
    a1b = k1(arrays["plo2"], arrays["mg2"], arrays["vals2"], x2, q2, style2)
    segs = [(a1a if pid == 0 else a1b)[lo:hi] for pid, lo, hi in inter]
    a1 = torch.cat(segs) if len(segs) > 1 else segs[0]
    return a1.reshape(-1, L)


def _e1s_from_a1(inst, arrays, A1, D2R: int):
    """Per-instance T1 + K2 over slices of the A1 grid: the instance's rows
    ``a0:a1``, zero-padded from S1c to S1p (``fused.py:777``).  Returns the
    ``(e1, g3, K, um3)`` list for :func:`k3_combine`."""
    out = []
    for i, meta_i in enumerate(inst):
        S1c, S1p, A2R, _D2Ri, _Dp, K, W2, a0, a1 = meta_i[:9]
        um = meta_i[9] if len(meta_i) > 9 else 0
        Ai = A1[a0:a1]
        if S1p != S1c:
            Ai = F.pad(Ai, (0, 0, 0, S1p - S1c))
        A1T = t1(Ai.contiguous(), A2R)
        e1 = k2(A1T, arrays[f"g2a_{i}"], arrays[f"g2b_{i}"],
                arrays[f"g2c_{i}"], W2, D2R)
        out.append((e1, arrays[f"g3_{i}"], K, bool(um & 2)))
    return out


def fused_delta_e1s(meta, arrays, x, ncols: int, nrows_part: int, x2=None):
    """K1 + T1 + K2 for the delta elements (``fused.py:1666``)."""
    D2R = _d2r(nrows_part)
    A1 = fused_delta_a1(meta, arrays, x, ncols, x2=x2)
    return _e1s_from_a1(meta[3], arrays, A1, D2R)


def fused_run_a1(meta, arrays, x, ncols: int, x2=None):
    """K1 (run style) only: the run segment's (T*8, L) grid
    (``fused.py:764``); ``meta = (T, q, npages, inst, n_res, style)``."""
    T, q, npages = meta[:3]
    if x.dim() != 1:
        raise NotImplementedError("k-batched (SpMM) K1 is not ported yet; "
                                  "see ROADMAP.md Queue 2, item 6")
    x2 = _k1_x2(x, ncols, q, npages, x2)
    a1 = k1(arrays["plo"], arrays["mg"], arrays["vals"], x2, q, meta[5])
    return a1.reshape(T * 8, L)


def fused_run_e1s(meta, arrays, x, ncols: int, nrows_part: int, x2=None):
    """K1 (run style) + T1 + K2 per route instance (``fused.py:804``)."""
    A1 = fused_run_a1(meta, arrays, x, ncols, x2=x2)
    return _e1s_from_a1(meta[3], arrays, A1, _d2r(nrows_part))


def merged_e1s(inst_meta, arrays, src_global, nrows_part: int):
    """Per-instance G1 + T1 + K2 over the concatenated RAW source grid
    (S, L) of every fused segment (``fused.py:882``).  G1 is the lane
    gather, run per instance: merged instances may overlap in source rows
    and colour them independently, so their G1 wires are never unioned."""
    from sparsex_tpu_torch.ops.route import lane_gather

    D2R = _d2r(nrows_part)
    out = []
    for i, meta_i in enumerate(inst_meta):
        S1c, S1p, A2R, _D2Ri, _Dp, K, W2, a0, a1 = meta_i[:9]
        um = meta_i[9] if len(meta_i) > 9 else 0
        Si = src_global[a0:a1]
        if S1p != S1c:
            Si = F.pad(Si, (0, 0, 0, S1p - S1c))
        A1 = lane_gather(Si.contiguous(), arrays[f"g1_{i}"][None])
        A1T = t1(A1, A2R)
        e1 = k2(A1T, arrays[f"g2a_{i}"], arrays[f"g2b_{i}"],
                arrays[f"g2c_{i}"], W2, D2R)
        out.append((e1, arrays[f"g3_{i}"], K, bool(um & 2)))
    return out


def k3_combine(e1_g3, dia_pack, x, nrows_part: int, ncols: int):
    """One K3 over every routed instance + every DIA table: y written once
    (``fused.py:1774``).  More than MAX_INSTANCES instances split into
    several K3 calls, the first carrying the DIA tables; anti-diagonal
    offsets ``s`` rebase to ``ncols-1-s`` over the reversed x."""
    if len(e1_g3) > MAX_INSTANCES:
        head = k3_combine(e1_g3[:MAX_INSTANCES], dia_pack, x, nrows_part,
                          ncols)
        tail = k3_combine(e1_g3[MAX_INSTANCES:], ((), None, (), None), x,
                          nrows_part, ncols)
        return head + tail
    dia_offsets, dv, anti_offsets, adv = dia_pack
    D2R = _d2r(nrows_part)
    xb = _to_blocks(x)[0] if dia_offsets else None
    if anti_offsets:
        xrb = _to_blocks(torch.flip(x, (0,)))[0]
        anti_rebased = tuple(ncols - 1 - s for s in anti_offsets)
    else:
        xrb, anti_rebased = None, ()
    y3 = k3([e for e, _, _, _ in e1_g3], [g for _, g, _, _ in e1_g3],
            dv, tuple(dia_offsets), adv, anti_rebased, xb, xrb, ncols, D2R)
    acc = y3.reshape(-1)
    return acc[:nrows_part] if acc.shape[0] != nrows_part else acc


def add_totals(acc, totals, dest):
    """``acc[dest] += totals`` in place, destinations outside [0, len(acc))
    dropped — the reference's ``.at[dest].add(..., mode="drop")``."""
    n = acc.shape[0]
    ok = (dest >= 0) & (dest < n)
    totals = torch.where(ok, totals, torch.zeros((), dtype=totals.dtype,
                                                  device=totals.device))
    return acc.index_add_(0, dest.clamp(0, n - 1), totals)


def add_products(acc, vals, cols, dest, x, ncols: int):
    """``acc[dest] += vals * x[cols]`` in place, columns clamped to
    [0, ncols) (the reference's ``take(mode="clip")``)."""
    return add_totals(acc, vals * x[cols.clamp(0, ncols - 1)], dest)


# the CUDA kernels whose launches ``launches`` counts
KERNELS = ("k1", "k1_rlp", "t1", "k2", "k3", "lane_gather")


def launch_counts() -> Dict[str, int]:
    return {k: int(launches[k]) for k in KERNELS}


__all__: List[str] = [
    "k1", "k1_plain", "k1_style", "t1", "t1_plain", "k2", "k2_plain", "k3",
    "k3_plain", "k3_combine", "fused_delta_a1", "fused_delta_e1s",
    "fused_run_a1", "fused_run_e1s", "merged_e1s", "add_products",
    "add_totals", "launches", "launch_counts", "KERNELS",
]
