"""CUDA kernels of sparsex_tpu_torch against their plain PyTorch versions.

These tests need an NVIDIA GPU with nvcc (they build ``csrc/*.cu``) and
skip without one.  This file imports no JAX, so it also runs where JAX is
not installed; there, skip the JAX-based ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

K1 (styles lp, rlp{W}, sl and run{W}), T1, K2, the lane gather, the DIA
kernel, the delta-pages product (misaligned operands refused), the
unit-page gather (1 to 16 window pages, misaligned operands refused) and
the paged-units kernel must equal their plain versions bit for bit; K3
must agree to 1e-6 of the largest value (both sum in the same order,
without FMA), and so must the scatter epilogues of the delta-pages and
paged-units kernels (atomic adds in no fixed order).  The k-batched (SpMM) variants
of K1, T1, K2, K3 and the lane gather, at kb = 1, 3 and 8 (K2 at every
kb from 1 to 8), must equal
their plain versions the same way, and each column c the kb = 0 kernel on
column c (K3 also at kb = 5).  The K3 tests alone: add ``-k k3``.  The
solvers (``-k "solver or block_cg"``): CG and block CG from one captured
block of iterations against the same solve run eagerly, the block's graph
holding ``solvers.BLOCK`` SpMVs' (SpMMs') kernels, a capture that fails
raising, and the card's solve against the CPU's.
"""

import numpy as np
import pytest
import torch

from sparsex_tpu_torch.ops import fused as tf
from sparsex_tpu_torch.ops import pallas_kernels as tpk
from sparsex_tpu_torch.ops import route as troute

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)
L = 128
TILE3 = L * L


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def _launched(key, fn):
    """``fn()``'s result, asserting one launch under ``key``."""
    before = tf.launches[key]
    out = fn()
    torch.cuda.synchronize()
    assert tf.launches[key] == before + 1
    return out


def _pack(low, g1):
    return ((low.astype(np.int32) & 0x3FFF)
            | ((g1.astype(np.int32) + 1) << 16))


@pytest.mark.parametrize("q8,T", [(1, 40), (4, 40), (32, 40), (4, 1),
                                  (32, 3), (1, 41), (4, 41)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k1_cuda_matches_plain(dev, q8, T, dtype):
    """The lp SpMV kernel (a thread per slot, two rows a block) on 1 to 41
    tiles."""
    rng = np.random.default_rng(q8 * 100 + T)
    npages = 128
    # low reaches past the window on purpose: those pages read as 0
    mg = _pack(rng.integers(0, q8 * 8 + 8, (T, 8, L)),
               rng.integers(-1, L, (T, 8, L)))
    plo = rng.integers(0, npages // q8, T).astype(np.int32)
    vals = rng.standard_normal((T, 8, L)).astype(dtype)
    x2 = rng.standard_normal((npages, 8, L)).astype(dtype)
    args = _on(dev, plo, mg, vals, x2)
    before = tf.launches["k1"]
    got = tf.k1(*args, q8)
    torch.cuda.synchronize()
    assert tf.launches["k1"] == before + 1
    assert torch.equal(got, tf.k1_plain(*args, q8))


@pytest.mark.parametrize("operand", ["vals", "mg"])
def test_k1_cuda_refuses_misaligned(dev, operand):
    """The lp SpMV kernel streams mg and vals in as 16-byte vectors: either
    one value past a 16-byte boundary is refused (CUDA error 1), and
    nothing is launched."""
    rng = np.random.default_rng(8)
    T, npages, q8 = 4, 16, 4
    mg = _pack(rng.integers(0, 8, (T, 8, L)),
               rng.integers(-1, L, (T, 8, L))).reshape(-1)
    plo = np.zeros(T, np.int32)
    vals = rng.standard_normal(T * 8 * L + 1).astype(np.float32)
    x2 = rng.standard_normal((npages, 8, L)).astype(np.float32)
    plo_t, mg_t, vals_t, x2_t = _on(dev, plo, np.append(mg, np.int32(0)),
                                    vals, x2)
    ops = {"mg": mg_t[:-1], "vals": vals_t[:-1]}
    ops[operand] = {"mg": mg_t, "vals": vals_t}[operand][1:]
    before = tf.launches["k1"]
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        tf.k1(plo_t, ops["mg"].view(T, 8, L), ops["vals"].view(T, 8, L),
              x2_t, q8)
    assert tf.launches["k1"] == before


@pytest.mark.parametrize("W", [2, 4, 8])
@pytest.mark.parametrize("q8", [1, 4, 32])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k1_rlp_cuda_matches_plain(dev, W, q8, dtype):
    rng = np.random.default_rng(W * 100 + q8)
    T, npages = 40, 128
    mg = _pack(rng.integers(0, q8 * 8 + 8, (T, 8, L)),
               rng.integers(-1, L, (T, 8, L)))
    plo = rng.integers(0, npages // q8, T).astype(np.int32)
    vals = rng.standard_normal((T, 8, L)).astype(dtype)
    x2 = rng.standard_normal((npages, 8, L)).astype(dtype)
    args = _on(dev, plo, mg, vals, x2)
    before = tf.launches["k1_rlp"]
    got = tf.k1(*args, q8, f"rlp{W}")
    torch.cuda.synchronize()
    assert tf.launches["k1_rlp"] == before + 1
    assert torch.equal(got, tf.k1_plain(*args, q8, f"rlp{W}"))


@pytest.mark.parametrize("style", ["sl", "run2", "run16", "run128"])
@pytest.mark.parametrize("q", [1, 3, 16])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k1_dense_cuda_matches_plain(dev, style, q, dtype):
    """The dense-tile styles: windows of q pages (plo counts pages),
    offsets past the window where q < 16 read 0; run{W} up to W = 128,
    seven roll passes."""
    rng = np.random.default_rng(q * 7 + len(style))
    T, npages = 40, 64
    mg = _pack(rng.integers(0, min(1 << 14, q * 1024 + 512), (T, 8, L)),
               rng.integers(-1, L, (T, 8, L)))
    plo = rng.integers(0, npages - q + 1, T).astype(np.int32)
    vals = rng.standard_normal((T, 8, L)).astype(dtype)
    x2 = rng.standard_normal((npages, 8, L)).astype(dtype)
    args = _on(dev, plo, mg, vals, x2)
    key = tf.k1_key(style)
    before = tf.launches[key]
    got = tf.k1(*args, q, style)
    torch.cuda.synchronize()
    assert tf.launches[key] == before + 1
    assert torch.equal(got, tf.k1_plain(*args, q, style))


def _lane_wires(rng, K, R, pattern):
    """K int8 wire planes over R rows: random (-1 masks a slot), all -1,
    or every wire on lane 77 (the shared row's worst bank pattern)."""
    idx = rng.integers(-1, L, (K, R, L)).astype(np.int8)
    if pattern == "masked":
        idx[:] = -1
    elif pattern == "one_lane":
        idx[:] = 77
    return idx


@pytest.mark.parametrize("pattern", ["random", "masked", "one_lane"])
@pytest.mark.parametrize("K,R", [(1, 4736), (3, 200), (1, 1), (2, 7),
                                 (3, 4737), (1, 4737)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lane_gather_cuda_matches_plain(dev, K, R, pattern, dtype):
    """A warp a row: R = 1, 7 and 4737 leave a partial last block."""
    rng = np.random.default_rng(K * 7 + R)
    x = rng.standard_normal((R, L)).astype(dtype)
    xt, it = _on(dev, x, _lane_wires(rng, K, R, pattern))
    got = _launched("lane_gather", lambda: troute.lane_gather(xt, it))
    assert torch.equal(got, troute.lane_gather_plain(xt, it))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lane_gather_cuda_row_slice(dev, dtype):
    """Rows 3..3+R of a larger grid, as a route instance's rows a0:a1 of
    the merged source: the slice starts 3 x 128 values in."""
    rng = np.random.default_rng(11)
    R = 1000
    src, idx = _on(dev, rng.standard_normal((R + 9, L)).astype(dtype),
                   rng.integers(-1, L, (1, R, L)).astype(np.int8))
    xt = src[3:3 + R]
    assert xt.is_contiguous() and xt.data_ptr() != src.data_ptr()
    got = _launched("lane_gather", lambda: troute.lane_gather(xt, idx))
    assert torch.equal(got, troute.lane_gather_plain(xt, idx))


@pytest.mark.parametrize("operand", ["x", "idx"])
def test_lane_gather_cuda_refuses_misaligned(dev, operand):
    """x loads as 16-byte vectors and the wires as 4-byte words: x one
    value, or idx one byte, past the boundary is refused (CUDA error 1)
    and nothing is launched."""
    rng = np.random.default_rng(5)
    R = 16
    xf, idxf = _on(dev, rng.standard_normal(R * L + 1).astype(np.float32),
                   rng.integers(-1, L, R * L + 1).astype(np.int8))
    x, idx = xf[:-1].view(R, L), idxf[:-1].view(1, R, L)
    if operand == "x":
        x = xf[1:].view(R, L)
    else:
        idx = idxf[1:].view(1, R, L)
    before = tf.launches["lane_gather"]
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        troute.lane_gather(x, idx)
    assert tf.launches["lane_gather"] == before


def test_row_kernels_refuse_misaligned_out(dev):
    """The launchers of the SpMV lane gather, K1 lp (both forms) and K1 sl
    kb refuse an output off a 16-byte boundary (cudaErrorInvalidValue =
    1); their wrappers allocate aligned outputs, so the C entry points are
    called directly."""
    from sparsex_tpu_torch.ops import _build
    lib = _build.library()
    R, T, kb = 8, 1, 2
    x, out = (torch.zeros(R * L + 4, device=dev) for _ in range(2))
    idx = torch.zeros((1, R, L), dtype=torch.int8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert lib.spx_lane_gather_f32(x.data_ptr(), idx.data_ptr(),
                                   out.data_ptr() + 4, R, 1, stream) == 1
    plo = torch.zeros(T, dtype=torch.int32, device=dev)
    mg = torch.zeros((T, 8, L), dtype=torch.int32, device=dev)
    vals = torch.zeros((T, 8, L), device=dev)
    x2 = torch.zeros((kb, 4, 8, L), device=dev)
    res = torch.zeros(kb * T * 8 * L + 4, device=dev)
    assert lib.spx_k1_sl_kb_f32(plo.data_ptr(), mg.data_ptr(),
                                vals.data_ptr(), x2.data_ptr(),
                                res.data_ptr() + 4, T, 2, kb, 4 * 8 * L,
                                stream) == 1
    assert lib.spx_k1_sl_kb_f32(plo.data_ptr(), mg.data_ptr(),
                                vals.data_ptr(), x2.data_ptr(),
                                res.data_ptr(), T, 2, kb, 4 * 8 * L,
                                stream) == 0
    for off, want in ((4, 1), (0, 0)):
        assert lib.spx_k1_kb_f32(plo.data_ptr(), mg.data_ptr(),
                                 vals.data_ptr(), x2.data_ptr(),
                                 res.data_ptr() + off, T, 4, kb, 4 * 8 * L,
                                 stream) == want
        assert lib.spx_k1_f32(plo.data_ptr(), mg.data_ptr(),
                              vals.data_ptr(), x2[0].data_ptr(),
                              res.data_ptr() + off, T, 4, stream) == want
    torch.cuda.synchronize()


# T1's block counts: 1 and 2, a headline-sized 46, a full blocky
# instance's 110 (about one wave of the card's SMs), and 129 (over one)
T1_A2R = [1, 2, 13, 46, 110, 129]


@pytest.mark.parametrize("A2R", T1_A2R)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_t1_cuda_matches_plain(dev, A2R, dtype):
    a1 = np.random.default_rng(A2R).standard_normal(
        (A2R * L, L)).astype(dtype)
    (t,) = _on(dev, a1)
    got = _launched("t1", lambda: tf.t1(t, A2R))
    assert torch.equal(got, tf.t1_plain(t, A2R))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_t1_refuses_misaligned(dev, dtype):
    """Both T1 launchers move 16-byte vectors: an input or an output one
    value off a 16-byte boundary is refused (cudaErrorInvalidValue = 1) and
    nothing is launched.  The wrapper allocates its output, so the C entry
    points are called directly for a misaligned output."""
    from sparsex_tpu_torch.ops import _build
    lib = _build.library()
    A2R, kb = 2, 3
    flat = torch.zeros(kb * A2R * TILE3 + 2, dtype=dtype, device=dev)
    for shape, key in (((A2R * L, L), "t1"), ((kb, A2R * L, L), "t1_kb")):
        n = int(np.prod(shape))
        before = tf.launches[key]
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            tf.t1(flat[1:1 + n].view(shape), A2R)
        assert tf.launches[key] == before
    sfx = "f32" if dtype == torch.float32 else "f64"
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr, size = flat.data_ptr(), flat.element_size()
    assert getattr(lib, f"spx_t1_{sfx}")(ptr, ptr + size, A2R, stream) == 1
    assert getattr(lib, f"spx_t1_kb_{sfx}")(ptr, ptr + size, A2R, kb,
                                            stream) == 1
    assert getattr(lib, f"spx_t1_{sfx}")(ptr, ptr, 0, stream) == 1
    torch.cuda.synchronize()


# (A2R, W2, D2R, masked): each of A2R, W2 and D2R at 1, 127 and 128, in
# masked (wires of -1) and um2 (no negative wire) form; random wires past
# A2R or W2 read 0 as well
K2_SHAPES = [
    (46, 128, 64, False),      # the headline instance
    (13, 16, 5, True),
    (128, 64, 128, False),     # 16 row blocks of 8 per colour
    (1, 1, 1, True),
    (1, 128, 127, False),      # a last row block of 7 rows
    (127, 127, 127, True),
    (128, 1, 128, True),
    (127, 128, 1, False),
    (128, 128, 128, True),
]


@pytest.mark.parametrize("A2R,W2,D2R,masked", K2_SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k2_cuda_matches_plain(dev, A2R, W2, D2R, masked, dtype):
    rng = np.random.default_rng(A2R)
    lo = -1 if masked else 0
    a1t = rng.standard_normal((A2R, L, L)).astype(dtype)
    g2a = rng.integers(lo, L, (L, A2R, L)).astype(np.int8)
    g2b = rng.integers(lo, L, (L, W2, L)).astype(np.int8)
    g2c = rng.integers(lo, L, (L, D2R, L)).astype(np.int8)
    args = _on(dev, a1t, g2a, g2b, g2c)
    got = tf.k2(*args, W2, D2R)
    torch.cuda.synchronize()
    assert torch.equal(got, tf.k2_plain(*args, W2, D2R))


# (seed, D2R, wires per instance, um3, dia, anti, ncols): K3's tiling is a
# band of 16 strips of one destination block a CUDA block, the tiles of
# every instance (and column) streaming through a shared-memory ring, each
# instance's wires in registers; its edges are one destination block, an
# odd number of them, eight instances of 1..8 wires beside DIA and anti
# tables (n_inst = 8 in f64 at kb = 8: the largest ring), masked wires (-1)
K3_CASES = [
    pytest.param(1, 3, (2,), True, (-13, -1, 0, 1, 8), (), 40000,
                 id="1-True-dia0-anti0"),
    pytest.param(2, 3, (2, 2), False, (-20000, 300, 16390), (5, 40000),
                 40000, id="2-False-dia1-anti1"),
    pytest.param(8, 3, (2,) * 8, True, (), (0,), 40000,
                 id="8-True-dia2-anti2"),
    pytest.param(11, 1, (2,), False, (-5, 0, 7), (), 12000,
                 id="d2r1-masked"),
    pytest.param(12, 5, (1, 4), False, (-20000, 300), (5,), 70000,
                 id="d2r5-k1k4-masked"),
    pytest.param(13, 3, (1, 2, 3, 4, 5, 6, 7, 8), False, (-9, 0, 30000),
                 (2, 40000), 45000, id="d2r3-8inst-k1to8-masked"),
    pytest.param(14, 1, (8,) * 8, True, (0,), (0,), 16384,
                 id="d2r1-8inst-k8-um3"),
]


def _k3_operands(dev, rng, D2R, Ks, um3, dia, anti, ncols, dtype, kb=0):
    """K3's operands on ``dev``: one E1 ((kb,) 128, D2R, 128) and g3 (D2R,
    K, 128, 128) per instance, dv / adv, and x as ``fused._to_blocks``
    gives it (k-major when kb)."""
    lead = (kb,) if kb else ()
    e1s = _on(dev, *[rng.standard_normal(lead + (L, D2R, L)).astype(dtype)
                     for _ in Ks])
    g3s = _on(dev, *[rng.integers(0 if um3 else -1, L, (D2R, K, L, L))
                     .astype(np.int8) for K in Ks])
    dv, adv, x = _on(dev, rng.standard_normal((D2R, len(dia), L, L))
                     .astype(dtype),
                     rng.standard_normal((D2R, len(anti), L, L))
                     .astype(dtype),
                     rng.standard_normal(lead + (ncols,)).astype(dtype))
    xb = tf._to_blocks(x)[0]
    xrb = tf._to_blocks(torch.flip(x, (-1,)))[0]

    def args(c=None):
        """The operands, or column ``c``'s alone (the SpMV's)."""
        pick = (lambda t: t) if c is None else (lambda t: t[c])
        return ([pick(e) for e in e1s], g3s, dv, dia, adv, anti, pick(xb),
                pick(xrb), ncols, D2R)
    return args


@pytest.mark.parametrize("seed,D2R,Ks,um3,dia,anti,ncols", K3_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k3_cuda_matches_plain(dev, seed, D2R, Ks, um3, dia, anti, ncols,
                               dtype):
    args = _k3_operands(dev, np.random.default_rng(seed), D2R, Ks, um3, dia,
                        anti, ncols, dtype)
    got = _launched("k3", lambda: tf.k3(*args()))
    want = tf.k3_plain(*args())
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.parametrize("D", [5, 27, 70])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dia_cuda_matches_plain(dev, D, dtype):
    """Offsets a tile and more apart on both sides, ncols != nrows, and
    D = 70 past the 64 diagonals the Pallas kernel stops at."""
    rng = np.random.default_rng(D)
    nrows, ncols = 100000, 90000
    offsets = tuple(int(o) for o in sorted(rng.choice(
        np.arange(-50000, 50000), D, replace=False)))
    dv = rng.standard_normal((D, nrows)).astype(dtype)
    x = rng.standard_normal(ncols).astype(dtype)
    dvt, xt = _on(dev, dv, x)
    xp, pad_lo = tpk.dia_frame(offsets, xt, nrows, ncols)
    before = tf.launches["dia"]
    got = tpk.dia(dvt, xp, offsets, pad_lo)
    torch.cuda.synchronize()
    assert tf.launches["dia"] == before + 1
    assert torch.equal(got, tpk.dia_plain(dvt, xp, offsets, pad_lo))


def _delta_stream(dev, dtype, n=1 << 16, m=50000, seed=5):
    """A paged delta stream of m singles near the diagonal of an n-row
    matrix (some padding slots with the sentinel row n) and an x, on the
    card: (plo, sl, vals, rows int32, x, x2, q, npages)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, m)
    cols = np.clip(rows + rng.integers(-5000, 5000, m), 0, n - 1)
    rep, _left = tpk.build_delta_pages(cols, rows,
                                       rng.standard_normal(m).astype(dtype),
                                       n, n)
    q, npages = rep.pop("q"), rep.pop("npages")
    assert (rep["rows"] == n).any() and rep["sl"].dtype == np.int16
    x = rng.standard_normal(n).astype(dtype)
    plo, sl, vals, rws, xt = _on(dev, rep["plo"], rep["sl"], rep["vals"],
                                 rep["rows"].astype(np.int32), x)
    return plo, sl, vals, rws, xt, tpk.pad_x_pages(xt, n, q, npages), q, \
        npages


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_delta_pages_cuda_matches_plain(dev, dtype):
    """The product bit-equal; the scatter epilogue (``delta_pages_spmv``)
    drops the padding slots' sentinel row n and agrees with the plain
    version's ``index_add_`` within 1e-6 of the largest value (atomic adds
    sum in no fixed order)."""
    n = 1 << 16
    plo, sl, vals, rws, xt, x2, q, npages = _delta_stream(dev, dtype, n)
    got = _launched("delta_pages", lambda: tpk.delta_pages(plo, sl, vals,
                                                           x2, q))
    assert torch.equal(got, tpk.delta_pages_plain(plo, sl, vals, x2, q))
    meta = (plo.shape[0], q, npages)
    trep = {"plo": plo, "sl": sl, "vals": vals, "rows": rws}
    acc = _launched("delta_pages_acc", lambda: tpk.delta_pages_spmv(
        meta, trep, xt, n, n, torch.zeros(n, dtype=vals.dtype, device=dev)))
    want = torch.zeros(n, dtype=vals.dtype)
    tpk.delta_pages_spmv(meta, {k: v.cpu() for k, v in trep.items()},
                         xt.cpu(), n, n, want)
    assert (acc.cpu() - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.parametrize("n_acc", [1 << 16, 40000])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_delta_pages_acc_cuda_matches_plain(dev, n_acc, dtype):
    """The scatter epilogue into an accumulator that already holds values,
    of every row (n_acc = n) or of the first 40000 (rows past it dropped),
    within 1e-6 of ``delta_pages_acc_plain``."""
    plo, sl, vals, rws, _xt, x2, q, _np = _delta_stream(dev, dtype, seed=7)
    acc0 = torch.from_numpy(np.random.default_rng(1).standard_normal(n_acc)
                            .astype(dtype)).to(dev)
    got = _launched("delta_pages_acc", lambda: tpk.delta_pages_acc(
        plo, sl, vals, x2, q, acc0.clone(), rws))
    want = tpk.delta_pages_acc_plain(plo, sl, vals, x2, q, acc0.clone(), rws)
    assert got.shape == (n_acc,)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.parametrize("operand", ["sl", "vals", "out", "rows", "q"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_delta_pages_cuda_refuses_misaligned(dev, operand, dtype):
    """A thread's offsets and rows load as one vector each and its values
    and products as 16 bytes: an operand one element past its boundary is
    refused (CUDA error 1), and so is q = 17; nothing is launched."""
    rng = np.random.default_rng(4)
    T, q = 4, 2
    plo, x2 = _on(dev, np.zeros(T, np.int32),
                  rng.standard_normal((20, 8, L)).astype(dtype))
    slf, valf, rowf = _on(dev, rng.integers(0, q * 1024, T * 8 * L + 8)
                          .astype(np.int16),
                          rng.standard_normal(T * 8 * L + 8).astype(dtype),
                          rng.integers(0, 100, T * 8 * L + 8)
                          .astype(np.int32))
    shape = (T, 8, L)
    sl, vals, rows = slf[:-8].view(shape), valf[:-8].view(shape), rowf[:-8]
    out_off = {"out": 1}.get(operand, 0)
    if operand == "sl":
        sl = slf[1:-7].view(shape)
    elif operand == "vals":
        vals = valf[1:-7].view(shape)
    elif operand == "rows":
        rows = rowf[1:-7]
    qq = 17 if operand == "q" else q
    if operand == "q":
        x2 = x2.repeat(2, 1, 1)
    acc = torch.zeros(100, dtype=vals.dtype, device=dev)
    before = (tf.launches["delta_pages"], tf.launches["delta_pages_acc"])
    if operand != "rows":     # the product form
        out = torch.empty(T * 8 * L + 4, dtype=vals.dtype, device=dev)
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            if operand == "out":
                from sparsex_tpu_torch.ops._launch import _launch, _stream
                _launch("delta_pages", vals.dtype, plo.data_ptr(),
                        sl.data_ptr(), vals.data_ptr(), x2.data_ptr(),
                        out[out_off:].data_ptr(), T, qq, _stream(dev))
            else:
                tpk.delta_pages(plo, sl, vals, x2, qq)
    if operand != "out":      # the scatter epilogue
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            tpk.delta_pages_acc(plo, sl, vals, x2, qq, acc, rows)
    assert (tf.launches["delta_pages"],
            tf.launches["delta_pages_acc"]) == before


@pytest.mark.parametrize("T", [64, 61])
@pytest.mark.parametrize("sl_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_paged_gather_cuda_matches_plain(dev, T, sl_dtype, dtype):
    """int16 and int32 window offsets, some outside the q-page window."""
    rng = np.random.default_rng(T)
    q, npages = 6, 100
    plo = rng.integers(0, npages - q + 1, T).astype(np.int32)
    sl = rng.integers(0, q * 1024 + 500, (T, 8, L)).astype(sl_dtype)
    x2 = rng.standard_normal((npages, 8, L)).astype(dtype)
    args = _on(dev, plo, sl, x2)
    before = tf.launches["paged_gather"]
    got = tpk.gather(*args, q)
    torch.cuda.synchronize()
    assert tf.launches["paged_gather"] == before + 1
    assert torch.equal(got, tpk.gather_plain(*args, q))


@pytest.mark.parametrize("q", [1, 8, 16])
@pytest.mark.parametrize("sl_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_paged_gather_cuda_window_sizes(dev, q, sl_dtype, dtype):
    """The staged window from 1 to 16 pages (past 48 KB of shared memory in
    f64 at q = 8 and 16), and a page grid whose windows start off a 16-byte
    boundary (element copies)."""
    rng = np.random.default_rng(q)
    T, npages = 37, 40
    plo = rng.integers(0, npages - q + 1, T).astype(np.int32)
    sl = rng.integers(-3, q * 1024 + 3, (T, 8, L)).astype(sl_dtype)
    x2f = rng.standard_normal(npages * 8 * L + 1).astype(dtype)
    plo_d, sl_d, x2_d = _on(dev, plo, sl, x2f)
    for x2 in (x2_d[:-1].view(npages, 8, L), x2_d[1:].view(npages, 8, L)):
        got = _launched("paged_gather", lambda: tpk.gather(plo_d, sl_d, x2,
                                                           q))
        assert torch.equal(got, tpk.gather_plain(plo_d, sl_d, x2, q))


@pytest.mark.parametrize("sl_dtype", [np.int16, np.int32])
def test_paged_gather_cuda_refuses_misaligned(dev, sl_dtype):
    """A thread's 4 offsets load as one vector: ``sl`` one element past its
    boundary is refused (CUDA error 1), and so is q = 17; nothing is
    launched."""
    rng = np.random.default_rng(3)
    T, q = 4, 2
    plo, x2 = _on(dev, np.zeros(T, np.int32),
                  rng.standard_normal((8, 8, L)).astype(np.float32))
    (slf,) = _on(dev, rng.integers(0, q * 1024, T * 8 * L + 1)
                 .astype(sl_dtype))
    before = tf.launches["paged_gather"]
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        tpk.gather(plo, slf[1:].view(T, 8, L), x2, q)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        tpk.gather(plo, slf[:-1].view(T, 8, L), x2[:8].contiguous()
                   .repeat(3, 1, 1), 17)
    assert tf.launches["paged_gather"] == before


@pytest.mark.parametrize("form,width,q", [
    ("runs", 5, 2), ("runs", 8, 1), ("diag", 3, 3), ("blocks", 3, 2),
    ("blocks", 2, 8)])
@pytest.mark.parametrize("sl_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_paged_units_cuda_matches_plain(dev, form, width, q, sl_dtype, dtype):
    """Horizontal run sums, diagonal products and block-row sums over
    q-page windows (q = 8: 64 KB of f64 window in shared memory), some
    offsets outside the window; on a page grid of its own and on one that
    starts one value past a 16-byte boundary (element copies); then the
    scatter epilogue into an accumulator."""
    rng = np.random.default_rng(width * 10 + q)
    T, npages = 37, 60
    su = width
    g = 1024 // su
    plo = rng.integers(0, npages - q + 1, T).astype(np.int32)
    sl = rng.integers(-5, q * 1024 + 300, (T, 8, L)).astype(sl_dtype)
    vshape = (T * g, width, width) if form == "blocks" else (T * g, width)
    vals = rng.standard_normal(vshape).astype(dtype)
    x2 = rng.standard_normal((npages * 1024 + 1,)).astype(dtype)
    plo_t, sl_t, vals_t, x2_t = _on(dev, plo, sl, vals, x2)
    each = form == "diag"
    for grid in (x2_t[:-1].view(npages, 8, L),
                 x2_t[1:].view(npages, 8, L)):   # misaligned by one value
        got = _launched("paged_units", lambda: tpk.paged_units(
            plo_t, sl_t, vals_t, grid, q, each))
        want = tpk.paged_units_plain(plo_t, sl_t, vals_t, grid, q, each)
        assert got.shape == want.shape and torch.equal(got, want)
    # the scatter epilogue: atomic adds into acc[dest], rows outside
    # [0, n) dropped, in no fixed order: within 1e-6 of index_add_'s sums
    n = 5000
    dest = torch.from_numpy(rng.integers(-3, n + 3, want.numel())).to(dev)
    acc0 = torch.from_numpy(rng.standard_normal(n).astype(dtype)).to(dev)
    got = _launched("paged_units", lambda: tpk.paged_units(
        plo_t, sl_t, vals_t, grid, q, each, acc0.clone(), dest))
    want = tpk.paged_units_plain(plo_t, sl_t, vals_t, grid, q, each,
                                 acc0.clone(), dest)
    assert got.shape == (n,)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def route_singles(n, m=6000, seed=6):
    """m random singles, deduplicated and sorted, f32 values
    (tests/test_route.py:220-250): under ``xform=none`` and lowered
    thresholds the paged delta with its scatter route (``dscatter``)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, m)
    cols = rng.integers(0, n, m)
    _, uniq = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[uniq], cols[uniq]
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    return rows, cols, rng.standard_normal(rows.size).astype(np.float32)


def _api_cuda_vs_cpu(build, n, dtype, kernels, **options):
    """Tune ``build(n)`` on the card and on the CPU, run one SpMV on each and
    check that every kernel in ``kernels`` launched on the card."""
    import sparsex_tpu_torch as spt

    rows, cols, vals = build(n)
    cfg = spt.Config.reset()
    cfg.set("spx.tpu.value_dtype", dtype)
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "portion")
    for key, value in options.items():
        cfg.set(key, value)
    rowptr = np.zeros(n + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    inp = spt.input_load_csr(rowptr, cols, vals, n, n)
    A = spt.mat_tune(inp)
    B = spt.mat_tune(inp, device="cpu")
    x = np.random.default_rng(0).standard_normal(n).astype(dtype)
    before = tf.launch_counts()
    y = spt.matvec_kernel(1.0, A, x, 0.0, None)
    torch.cuda.synchronize()
    after = tf.launch_counts()
    assert all(after[k] > before[k] for k in kernels), (before, after)
    want = spt.matvec_kernel(1.0, B, x, 0.0, None)
    assert ((y.cpu() - want).abs().max()
            <= 1e-6 * want.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_api_cuda_matches_cpu(dev, dtype):
    """The headline slice on the card against the same slice on the CPU."""
    import chip_smoke
    _api_cuda_vs_cpu(chip_smoke.build_matrix, 1 << 17, dtype,
                     ("k1", "t1", "k2", "k3"))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_api_cuda_blocky_matches_cpu(dev, dtype):
    """The blocky slice (fused runs, merged plan) on the card against the
    same slice on the CPU."""
    import chip_smoke
    _api_cuda_vs_cpu(chip_smoke.build_blocky_matrix, 1 << 18, dtype,
                     ("k1", "k1_rlp", "t1", "k2", "k3", "lane_gather"))


@pytest.mark.parametrize("build,kernels", [
    ("lane_skew_matrix", ("k1_sl", "t1", "k2", "k3")),
    ("wide_run_matrix", ("k1", "k1_run", "lane_gather", "t1", "k2", "k3")),
])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_api_cuda_dense_matches_cpu(dev, build, kernels, dtype):
    """The dense-tile K1 styles on their paths at 2^18 rows: the sl delta
    pipeline, and a run16 fused run table in a merged plan."""
    import chip_smoke
    fn = getattr(chip_smoke, build)
    _api_cuda_vs_cpu(fn if build == "lane_skew_matrix"
                     else (lambda n: fn(n, 16)), 1 << 18, dtype, kernels)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_api_cuda_hpcg_matches_cpu(dev, dtype):
    """The plain-table variant (the HPCG stencil at 32^3: one DIA table)."""
    import chip_smoke
    _api_cuda_vs_cpu(lambda n: chip_smoke.hpcg_matrix(32)[1:], 32 ** 3,
                     dtype, ("dia",), **{"spx.preproc.sampling": "none"})


@pytest.mark.parametrize("build,n,kernels", [
    ("build_matrix", 1 << 17, ("dia", "delta_pages_acc")),
    ("build_blocky_matrix", 1 << 18, ("delta_pages_acc", "paged_units")),
])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_api_cuda_paged_matches_cpu(dev, monkeypatch, build, n, kernels,
                                    dtype):
    """The legacy paged variant without a fused segment: nothing fuses
    under a raised ``spx.tpu.min_fused_nnz`` and nothing is routed, so the
    paged delta runs the delta-pages kernel's scatter epilogue."""
    import chip_smoke
    monkeypatch.setattr(troute, "MIN_ELEMS", 1 << 30)
    _api_cuda_vs_cpu(getattr(chip_smoke, build), n, dtype, kernels,
                     **{"spx.tpu.min_fused_nnz": str(1 << 30)})


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_api_cuda_dscatter_matches_cpu(dev, monkeypatch, dtype):
    """The paged delta with its scatter route (``dscatter``: 4096 rows of
    random singles under ``xform=none`` and lowered gates): the delta-pages
    product, then five lane gathers per route instance."""
    monkeypatch.setattr(tpk, "MIN_PAGE_NNZ", 64)
    monkeypatch.setattr(troute, "MIN_ELEMS", 64)
    _api_cuda_vs_cpu(route_singles, 4096, dtype,
                     ("delta_pages", "lane_gather"),
                     **{"spx.preproc.xform": "none"})


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_api_cuda_paged_routed_matches_cpu(dev, monkeypatch, dtype):
    """The fused pipeline kept off on blocky 2^16 (gates at 1024): the
    routed delta, an fs run table, and an fblk table whose block rows a
    merged plan takes (the unit-page gather, the lane rolls, G1, T1, K2,
    K3, the bres residuals)."""
    import chip_smoke
    monkeypatch.setattr(tpk, "MIN_PAGE_NNZ", 1024)
    monkeypatch.setattr(troute, "MIN_ELEMS", 1024)
    _api_cuda_vs_cpu(chip_smoke.build_blocky_matrix, 1 << 16, dtype,
                     ("delta_pages", "lane_gather", "paged_gather",
                      "paged_units", "t1", "k2", "k3"),
                     **{"spx.tpu.min_fused_nnz": str(1 << 30)})


@pytest.mark.parametrize("build,n", [
    ("block3_matrix", 3 << 16),
    ("wide_run_matrix", 1 << 17),
])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_api_cuda_fs_matches_cpu(dev, monkeypatch, build, n, dtype):
    """The partial-segment route: a 3x3 block table, and a width-5 run
    table beside the fused delta pipeline (route gate lowered as in
    tests/test_torch_fs.py): the paged-units kernel, then per instance the
    lane gather, T1 and K2, into K3."""
    import chip_smoke
    monkeypatch.setattr(troute, "MIN_ELEMS", 1024)
    fn = getattr(chip_smoke, build)
    _api_cuda_vs_cpu(fn if build == "block3_matrix" else (lambda m: fn(m, 5)),
                     n, dtype, ("paged_units", "lane_gather", "t1", "k2",
                                "k3"))


@pytest.mark.parametrize("mode,routed,kernels", [
    ("off", True, ("dia", "delta_pages", "lane_gather")),
    ("off", False, ("dia", "delta_pages_acc")),
    ("on", True, ("dia", "delta_pages", "lane_gather")),
])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_api_cuda_symmetric_matches_cpu(dev, monkeypatch, mode, routed,
                                        kernels, dtype):
    """bench.py's symmetric matrix at 2^14 rows (page and route gates at
    1024): per shard (``spx.tpu.sym_full=off``) both paged delta streams
    through their scatter routes (``dscatter``, ``dscatterT``) or, with
    the route gate out of reach, through the kernel's scatter epilogue;
    the full mirror (``on``) on the paged delta with its route."""
    import chip_smoke
    monkeypatch.setattr(tpk, "MIN_PAGE_NNZ", 1024)
    monkeypatch.setattr(troute, "MIN_ELEMS", 1024 if routed else 1 << 30)
    _api_cuda_vs_cpu(chip_smoke.build_symmetric_matrix, 1 << 14, dtype,
                     kernels, **{"spx.matrix.symmetric": "true",
                                 "spx.tpu.sym_full": mode})


@pytest.mark.parametrize("dtype,bar", [("float32", 2e-4),
                                       ("float64", 1e-6)])
def test_api_cuda_overlap_run_matches_oracle(dev, dtype, bar):
    """The run matrix whose fused run's route instances overlapped outside
    a merged plan (``chip_smoke.overlap_run_matrix(1 << 16)``, 3.1M
    nonzeros): its run table re-planned with an ``fs`` route, on the card
    against the float64 COO oracle (max |y - y_oracle| / max |y_oracle|),
    through the paged-units kernel, the lane gather, T1, K2 and K3."""
    import chip_smoke
    import sparsex_tpu_torch as spt

    n = 1 << 16
    rows, cols, vals = chip_smoke.overlap_run_matrix(n)
    cfg = spt.Config.reset()
    cfg.set("spx.tpu.value_dtype", dtype)
    cfg.set("spx.preproc.xform", "all")
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n))
    x = np.random.default_rng(1).standard_normal(n).astype(dtype)
    before = tf.launch_counts()
    y = spt.matvec_mult(1.0, A, x)
    torch.cuda.synchronize()
    after = tf.launch_counts()
    assert all(after[k] > before[k] for k in ("paged_units", "lane_gather",
                                              "t1", "k2", "k3"))
    want = np.bincount(rows, weights=vals.astype(dtype).astype(np.float64)
                       * x.astype(np.float64)[cols], minlength=n)
    got = y.double().cpu().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < bar


# ---------------------------------------------------------------------------
# the k-batched (SpMM) variants
# ---------------------------------------------------------------------------

def _columns_equal(batched, per_column):
    for c, want in enumerate(per_column):
        assert torch.equal(batched[c], want), f"column {c}"


@pytest.mark.parametrize("style,q,T", [
    ("lp", 1, 40), ("lp", 4, 40), ("lp", 32, 40), ("rlp2", 4, 40),
    ("rlp8", 1, 40), ("sl", 3, 40), ("sl", 16, 40), ("run16", 3, 40),
    ("run128", 1, 40), ("rlp128", 4, 40), ("run2", 3, 40), ("rlp4", 32, 40),
    ("rlp8", 4, 1), ("run16", 2, 3), ("rlp2", 32, 41), ("run128", 1, 41),
    ("sl", 1, 1), ("sl", 2, 3), ("sl", 16, 41), ("sl", 1, 41),
    ("lp", 4, 1), ("lp", 32, 3), ("lp", 1, 41), ("lp", 32, 41)])
@pytest.mark.parametrize("kb", [1, 3, 8, 5])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k1_kb_cuda_matches_plain(dev, style, q, T, kb, dtype):
    """Lane-placed windows of q8 pages, dense windows of q pages (offsets
    past either read 0); (kb, npages, 8, 128) grids give (kb, T, 8, 128).
    The run styles take one (W = 2) to seven (W = 128) roll passes, and
    T = 1, 3, 41 tiles leave a partial last block if a block takes more
    than one tile."""
    rng = np.random.default_rng(q * 31 + kb + len(style) + T)
    npages = 64
    dense = tf.k1_style(style)[0]
    hi = min(1 << 14, q * 1024 + 512) if dense else q * 8 + 8
    mg = _pack(rng.integers(0, hi, (T, 8, L)),
               rng.integers(-1, L, (T, 8, L)))
    plo = rng.integers(0, npages - q + 1 if dense else npages // q,
                       T).astype(np.int32)
    vals = rng.standard_normal((T, 8, L)).astype(dtype)
    x2 = rng.standard_normal((kb, npages, 8, L)).astype(dtype)
    args = _on(dev, plo, mg, vals, x2)
    got = _launched(tf.k1_key(style) + "_kb",
                    lambda: tf.k1(*args, q, style))
    assert got.shape == (kb, T, 8, L)
    assert torch.equal(got, tf.k1_plain(*args, q, style))
    _columns_equal(got, [tf.k1(*args[:3], args[3][c], q, style)
                         for c in range(kb)])


@pytest.mark.parametrize("operand", ["vals", "mg"])
@pytest.mark.parametrize("style,q", [("rlp8", 4), ("run16", 2), ("sl", 2),
                                     ("lp", 4)])
def test_k1_roll_kb_cuda_refuses_misaligned(dev, style, q, operand):
    """The kb kernels of every style stream mg and vals in as 16-byte
    vectors (and the warp-per-row ones store 16-byte vectors): vals or mg
    one value past a 16-byte boundary is refused (CUDA error 1), and
    nothing is launched."""
    rng = np.random.default_rng(7)
    T, npages = 4, 16
    mg = _pack(rng.integers(0, 8, (T, 8, L)),
               rng.integers(-1, L, (T, 8, L))).reshape(-1)
    plo = np.zeros(T, np.int32)
    vals = rng.standard_normal(T * 8 * L + 1).astype(np.float32)
    x2 = rng.standard_normal((2, npages, 8, L)).astype(np.float32)
    plo_t, mg_t, vals_t, x2_t = _on(dev, plo, np.append(mg, np.int32(0)),
                                    vals, x2)
    ops = {"mg": mg_t[:-1], "vals": vals_t[:-1]}
    ops[operand] = {"mg": mg_t, "vals": vals_t}[operand][1:]
    key = tf.k1_key(style) + "_kb"
    before = tf.launches[key]
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        tf.k1(plo_t, ops["mg"].view(T, 8, L), ops["vals"].view(T, 8, L),
              x2_t, q, style)
    assert tf.launches[key] == before


@pytest.mark.parametrize("A2R", T1_A2R)
@pytest.mark.parametrize("kb", [1, 3, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_t1_kb_cuda_matches_plain(dev, A2R, kb, dtype):
    a1 = np.random.default_rng(kb * 1000 + A2R).standard_normal(
        (kb, A2R * L, L)).astype(dtype)
    (t,) = _on(dev, a1)
    got = _launched("t1_kb", lambda: tf.t1(t, A2R))
    assert torch.equal(got, tf.t1_plain(t, A2R))
    _columns_equal(got, [tf.t1(t[c], A2R) for c in range(kb)])


@pytest.mark.parametrize("A2R,W2,D2R,masked", K2_SHAPES)
@pytest.mark.parametrize("kb", [1, 3, 8, 2, 4, 5, 6, 7])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k2_kb_cuda_matches_plain(dev, A2R, W2, D2R, masked, kb, dtype):
    rng = np.random.default_rng(A2R + kb)
    lo = -1 if masked else 0
    a1t = rng.standard_normal((kb, A2R, L, L)).astype(dtype)
    g2a = rng.integers(lo, L, (L, A2R, L)).astype(np.int8)
    g2b = rng.integers(lo, L, (L, W2, L)).astype(np.int8)
    g2c = rng.integers(lo, L, (L, D2R, L)).astype(np.int8)
    args = _on(dev, a1t, g2a, g2b, g2c)
    got = _launched("k2_kb", lambda: tf.k2(*args, W2, D2R))
    assert torch.equal(got, tf.k2_plain(*args, W2, D2R))
    _columns_equal(got, [tf.k2(args[0][c], *args[1:], W2, D2R)
                         for c in range(kb)])


K3_KB_CASES = K3_CASES[:3] + [
    pytest.param(3, 3, (2,) * 3, False, (), (), 40000,
                 id="3-False-dia3-anti3")] + K3_CASES[3:]


@pytest.mark.parametrize("seed,D2R,Ks,um3,dia,anti,ncols", K3_KB_CASES)
@pytest.mark.parametrize("kb", [1, 3, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k3_kb_cuda_matches_plain(dev, seed, D2R, Ks, um3, dia, anti, ncols,
                                  kb, dtype):
    args = _k3_operands(dev, np.random.default_rng(seed * 10 + kb), D2R, Ks,
                        um3, dia, anti, ncols, dtype, kb)
    got = _launched("k3_kb", lambda: tf.k3(*args()))
    want = tf.k3_plain(*args())
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    _columns_equal(got, [tf.k3(*args(c)) for c in range(kb)])


@pytest.mark.parametrize("seed,D2R,Ks,um3,dia,anti,ncols", K3_CASES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k3_kb_columns_bit_equal_k3(dev, seed, D2R, Ks, um3, dia, anti, ncols,
                                    dtype):
    """Each column c of one k3_kb launch over kb = 5 columns (a batch the
    kernel's unrolled column loop cuts short) equals, bit for bit, the SpMV
    kernel k3 launched on column c alone."""
    kb = 5
    args = _k3_operands(dev, np.random.default_rng(seed + 50), D2R, Ks, um3,
                        dia, anti, ncols, dtype, kb)
    got = _launched("k3_kb", lambda: tf.k3(*args()))
    cols = [_launched("k3", lambda c=c: tf.k3(*args(c))) for c in range(kb)]
    _columns_equal(got, cols)


@pytest.mark.parametrize("K,R", [(1, 4736), (3, 200)])
@pytest.mark.parametrize("kb", [1, 3, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lane_gather_kb_cuda_matches_plain(dev, K, R, kb, dtype):
    rng = np.random.default_rng(K * 10 + kb)
    x = rng.standard_normal((kb, R, L)).astype(dtype)
    idx = rng.integers(-1, L, (K, R, L)).astype(np.int8)
    xt, it = _on(dev, x, idx)
    got = _launched("lane_gather_kb", lambda: troute.lane_gather(xt, it))
    assert torch.equal(got, troute.lane_gather_plain(xt, it))
    _columns_equal(got, [troute.lane_gather(xt[c].contiguous(), it)
                         for c in range(kb)])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_api_cuda_spmm_matches_cpu(dev, dtype):
    """The blocky slice's SpMM (k = 11: chunks of 8 and 3) on the card runs
    only the k-batched kernels, and matches the same SpMM on the CPU.  Its
    first call runs the body from Python twice, the warm-up and the
    capture of the executor's graph: two K3 chunks each."""
    import chip_smoke
    import sparsex_tpu_torch as spt

    n, k = 1 << 18, 11
    rows, cols, vals = chip_smoke.build_blocky_matrix(n)
    cfg = spt.Config.reset()
    cfg.set("spx.tpu.value_dtype", dtype)
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "portion")
    inp = chip_smoke.csr_input(spt, rows, cols, vals, n)
    A, B = spt.mat_tune(inp), spt.mat_tune(inp, device="cpu")
    X = np.random.default_rng(0).standard_normal((n, k)).astype(dtype)
    tf.launches.clear()
    Y = spt.matmat_mult(1.0, A, X)
    torch.cuda.synchronize()
    counts = tf.launch_counts()
    assert all(counts[key] == 0 for key in tf.KERNELS
               if key not in tf.KB_KERNELS), counts
    assert counts["k1_rlp_kb"] > 0 and counts["k3_kb"] == 4, counts
    want = spt.matmat_mult(1.0, B, X)
    assert (Y.cpu() - want).abs().max() <= 1e-6 * want.abs().max()


# ---------------------------------------------------------------------------
# the executor's CUDA graphs (ops/exec.py: CsxExecutor._replayed)
# ---------------------------------------------------------------------------

# plan class -> (chip_smoke builder, rows, options, route gate MIN_ELEMS or
# None, whether two runs of the same x give the same bits: not where the
# residual adds (index_add_) or the paged-units kernel's scatter epilogue
# add with atomics)
GRAPH_PLANS = {
    "lp": ("build_matrix", 1 << 17, {}, None, False),
    "rlp": ("build_blocky_matrix", 1 << 18, {}, None, False),
    "run16": ("wide_run_matrix", 1 << 18, {}, None, False),
    "sl": ("lane_skew_matrix", 1 << 18, {}, None, False),
    "fs": ("block3_matrix", 3 << 16, {}, 1024, True),
    "hpcg": ("hpcg_matrix", 32 ** 3, {"spx.preproc.sampling": "none"}, None,
             True),
    "paged": ("build_blocky_matrix", 1 << 18,
              {"spx.tpu.min_fused_nnz": str(1 << 30)}, 1 << 30, False),
    # a symmetric matrix per shard: both paged delta streams routed, or
    # (route gate out of reach) through the scatter epilogue
    "sym": ("build_symmetric_matrix", 1 << 17,
            {"spx.matrix.symmetric": "true", "spx.tpu.sym_full": "off"},
            None, False),
    "sym-acc": ("build_symmetric_matrix", 1 << 17,
                {"spx.matrix.symmetric": "true", "spx.tpu.sym_full": "off"},
                1 << 30, False),
}


def _graph_plan(monkeypatch, plan, dtype="float32"):
    """(matrix tuned on the card, n, rows, cols, vals, bit-exact) of one
    plan class of GRAPH_PLANS."""
    import chip_smoke
    import sparsex_tpu_torch as spt

    build, n, options, min_elems, exact = GRAPH_PLANS[plan]
    if min_elems is not None:
        monkeypatch.setattr(troute, "MIN_ELEMS", min_elems)
    fn = getattr(chip_smoke, build)
    if build == "hpcg_matrix":
        _n, rows, cols, vals = fn(32)
    elif build == "wide_run_matrix":
        rows, cols, vals = fn(n, 16)
    else:
        rows, cols, vals = fn(n)
    cfg = spt.Config.reset()
    cfg.set("spx.tpu.value_dtype", dtype)
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "portion")
    for key, value in options.items():
        cfg.set(key, value)
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n))
    return A, n, rows, cols, vals, exact


def _same(got, want, exact):
    if exact:
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def _eager(ex, x):
    if x.dim() == 2:
        return ex.matmat(x)
    with ex._on_device():
        return ex._matvec(x)


@pytest.mark.parametrize("plan", sorted(GRAPH_PLANS))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_graph_replay_equals_eager(dev, monkeypatch, plan, dtype):
    """On each plan class the SpMV replayed from the executor's graph gives
    what the eager body gives on the same x (bit for bit, or within 1e-6
    of the largest value where atomics reorder sums); the first call runs
    the body from Python twice (warm-up, capture), a replay not at all."""
    A, n, *_rest, exact = _graph_plan(monkeypatch, plan, dtype)
    ex = A.csx.executors[0]
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(n),
                        dtype=ex.dtype, device=dev)
    tf.launches.clear()
    first = ex(x)
    torch.cuda.synchronize()
    captured = tf.launch_counts()
    assert list(ex._graphs) == [("mv",)] and sum(captured.values()) > 0
    tf.launches.clear()
    replayed = ex(x)
    torch.cuda.synchronize()
    assert sum(tf.launch_counts().values()) == 0
    eager = _eager(ex, x)
    tf.launches.clear()
    _eager(ex, x)
    torch.cuda.synchronize()
    assert {k: 2 * v for k, v in tf.launch_counts().items()} == captured
    _same(first, eager, exact)
    _same(replayed, eager, exact)


def test_graph_results_are_fresh(dev, monkeypatch):
    """Three calls in a row return three tensors, none the graph's static
    output: the earlier results keep their values after later replays."""
    A, n, *_rest = _graph_plan(monkeypatch, "rlp")
    ex = A.csx.executors[0]
    rng = np.random.default_rng(2)
    ys, kept = [], []
    for _ in range(3):
        x = torch.as_tensor(rng.standard_normal(n), dtype=ex.dtype,
                            device=dev)
        ys.append(ex(x))
        kept.append(ys[-1].clone())
    torch.cuda.synchronize()
    ptrs = {y.data_ptr() for y in ys} | {ex._graphs[("mv",)].out.data_ptr()}
    assert len(ptrs) == 4
    for y, want in zip(ys, kept):
        assert torch.equal(y, want)
    assert not torch.equal(ys[0], ys[1])


@pytest.mark.parametrize("plan", ["lp", "paged"])
def test_graph_epilogue_on_one_graph(dev, monkeypatch, plan):
    """alpha = 1 / beta = 0, alpha = 2 / beta = 0.5 and alpha = -0.75 /
    beta = 3 all replay the one SpMV graph; each equals the eager
    epilogue on the eager body."""
    A, n, *_rest, exact = _graph_plan(monkeypatch, plan)
    ex = A.csx.executors[0]
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal(n), dtype=ex.dtype, device=dev)
    y0 = torch.as_tensor(rng.standard_normal(n), dtype=ex.dtype, device=dev)
    acc = _eager(ex, x)
    for alpha, beta, y in ((1.0, 0.0, None), (2.0, 0.5, y0),
                           (-0.75, 3.0, y0)):
        got = ex(x, alpha=alpha, beta=beta, y=y)
        want = acc if alpha == 1.0 else acc * alpha
        if y is not None:
            want = want + beta * y
        _same(got, want, exact)
    assert list(ex._graphs) == [("mv",)]


@pytest.mark.parametrize("k", [1, 8, 11])
@pytest.mark.parametrize("plan", ["rlp", "hpcg", "sym"])
def test_graph_spmm_equals_eager(dev, monkeypatch, plan, k):
    """The SpMM replayed from its ("mm", k) graph: the k-batched chunks of
    a fused plan (rlp), the SpMV once per column otherwise (hpcg, and a
    symmetric matrix's per-shard plan)."""
    A, n, *_rest, exact = _graph_plan(monkeypatch, plan)
    ex = A.csx.executors[0]
    X = torch.as_tensor(np.random.default_rng(4).standard_normal((n, k)),
                        dtype=ex.dtype, device=dev)
    first, again = ex(X), ex(X)
    assert list(ex._graphs) == [("mm", k)]
    want = _eager(ex, X)
    assert first.shape == (n, k) and first.data_ptr() != again.data_ptr()
    _same(first, want, exact)
    _same(again, want, exact)


def test_graph_spmm_widths_are_bounded(dev, monkeypatch):
    """An executor keeps the SpMV graph and the ``MM_GRAPHS`` SpMM widths
    used last."""
    from sparsex_tpu_torch.ops import exec as texec
    A, n, *_rest = _graph_plan(monkeypatch, "lp")
    ex = A.csx.executors[0]
    rng = np.random.default_rng(5)
    ex(torch.as_tensor(rng.standard_normal(n), dtype=ex.dtype, device=dev))
    widths = list(range(1, texec.MM_GRAPHS + 3))
    for k in widths:
        ex(torch.as_tensor(rng.standard_normal((n, k)), dtype=ex.dtype,
                           device=dev))
    assert list(ex._graphs) == [("mv",)] + [("mm", k) for k in
                                            widths[-texec.MM_GRAPHS:]]
    assert all(b > 0 for b in ex.graph_bytes().values())


def test_graph_under_outer_capture(dev, monkeypatch):
    """Called under the caller's own capture, the executor launches its
    kernels into the caller's graph and replays none of its own; that graph
    gives what the direct call gives."""
    A, n, *_rest, exact = _graph_plan(monkeypatch, "rlp")
    ex = A.csx.executors[0]
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(n),
                        dtype=ex.dtype, device=dev)
    direct = ex(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ex(x)
    torch.cuda.current_stream().wait_stream(side)
    outer = torch.cuda.CUDAGraph()
    tf.launches.clear()
    with torch.cuda.graph(outer):
        captured = ex(x)
    assert tf.launches["k3"] > 0 and list(ex._graphs) == [("mv",)]
    outer.replay()
    torch.cuda.synchronize()
    _same(captured, direct, exact)


@pytest.mark.parametrize("build,n", [("build_matrix", 1 << 17),
                                     ("build_blocky_matrix", 1 << 18)])
def test_bf16_cuda_matches_oracle(dev, build, n):
    """A bf16 matrix on the card, computed in f32 from a bf16 x: a bf16
    result within 2e-2 of the largest value of the float64 COO oracle on
    the bf16-rounded values and x (the reference's bar), for the SpMV and
    a k = 3 SpMM."""
    import chip_smoke
    import sparsex_tpu_torch as spt

    rows, cols, vals = getattr(chip_smoke, build)(n)
    cfg = spt.Config.reset()
    cfg.set("spx.tpu.value_dtype", "bfloat16")
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "portion")
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n))
    assert A.csx.executors[0].dtype == torch.float32
    vb = torch.from_numpy(vals).bfloat16().double().numpy()
    X = torch.as_tensor(np.random.default_rng(7).standard_normal((n, 3)),
                        dtype=torch.bfloat16, device=dev)
    Xh = X.double().cpu().numpy()
    for got, xs in ((spt.matvec_mult(1.0, A, X[:, 0].contiguous()),
                     Xh[:, :1]),
                    (spt.matmat_mult(1.0, A, X), Xh)):
        assert got.dtype == torch.bfloat16
        want = np.stack([np.bincount(rows, weights=vb * xs[cols, j],
                                     minlength=n)
                         for j in range(xs.shape[1])], axis=1)
        g = got.double().cpu().numpy().reshape(want.shape)
        assert np.abs(g - want).max() / np.abs(want).max() < 2e-2


def test_graph_capture_failure_raises(dev, monkeypatch):
    """A body that cannot be captured (here a host sync forced into it)
    raises an error naming the graph's key; nothing runs eagerly instead,
    and no graph is kept."""
    from sparsex_tpu_torch.ops import exec as texec
    A, n, *_rest = _graph_plan(monkeypatch, "lp")
    ex = A.csx.executors[0]
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(n),
                        dtype=ex.dtype, device=dev)
    real = texec.local_contrib

    def syncing(meta, arrs, xv, **kw):
        float(xv.sum())   # a device-to-host copy: illegal under a capture
        return real(meta, arrs, xv, **kw)

    monkeypatch.setattr(texec, "local_contrib", syncing)
    with pytest.raises(RuntimeError,
                       match=r"capturing the CUDA graph of \('mv',\)"):
        ex(x)
    assert not ex._graphs
    torch.cuda.synchronize()


def _tune_shards(n, dtype, nshards, build=None, **options):
    """``build(n)`` (the headline matrix by default) tuned on the card in
    ``nshards`` shards, with its COO."""
    import chip_smoke
    import sparsex_tpu_torch as spt

    rows, cols, vals = (build or chip_smoke.build_matrix)(n)
    cfg = spt.Config.reset()
    cfg.set("spx.tpu.value_dtype", dtype)
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "portion")
    cfg.set("spx.rt.nr_threads", str(nshards))
    for key, value in options.items():
        cfg.set(key, value)
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n))
    return spt, A, rows, cols, vals


@pytest.mark.parametrize("nshards", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_shards_one_graph_holds_every_shard(dev, nshards, dtype):
    """A matrix of several shards replays one graph a call whose kernel
    nodes are the sum of its shards' per-SpMV counts; a replay launches
    nothing from Python; the result meets the COO oracle."""
    import chip_smoke
    spt, A, rows, cols, vals = _tune_shards(1 << 17, dtype, nshards)
    n = A.nrows
    ex = A.csx._executor()
    assert len(A.csx.executors) == nshards
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(n),
                        dtype=ex.dtype, device=dev)
    one = chip_smoke.matrix_counts(A.csx)
    tf.launches.clear()
    spt.matvec_kernel(1.0, A, x, 0.0, None)
    torch.cuda.synchronize()
    assert tf.launch_counts() == {k: 2 * v for k, v in one.items()}
    assert list(ex._graphs) == [("mv",)]
    assert all(not e._graphs for e in A.csx.executors)
    tf.launches.clear()
    y = spt.matvec_kernel(1.0, A, x, 0.0, None)
    torch.cuda.synchronize()
    assert sum(tf.launch_counts().values()) == 0
    assert chip_smoke.graph_kernels(ex._graphs[("mv",)].graph) == {
        k: v for k, v in one.items() if v}
    want = np.bincount(rows, weights=vals.astype(np.float64)
                       * x.double().cpu().numpy()[cols], minlength=n)
    bar = chip_smoke.CHECK_TOL if dtype == "float32" else 1e-6
    assert chip_smoke._mixed_rel_err(y.double().cpu().numpy(), want) < bar
    # the SpMM (k = 8, each shard's own body in one graph)
    X = torch.as_tensor(np.random.default_rng(2).standard_normal((n, 8)),
                        dtype=ex.dtype, device=dev)
    spt.matmat_mult(1.0, A, X)
    Y = spt.matmat_mult(1.0, A, X).double().cpu().numpy()
    Xh = X.double().cpu().numpy()
    want = np.stack([np.bincount(rows, weights=vals.astype(np.float64)
                                 * Xh[cols, j], minlength=n)
                     for j in range(8)], axis=1)
    assert chip_smoke._mixed_rel_err(Y, want) < bar


def test_set_entry_through_a_replayed_graph(dev):
    """``set_entry`` on shard 1 shows in the next SpMV replayed from the
    matrix's graph: shard 1 alone is planned and uploaded again and a new
    graph captured."""
    import chip_smoke
    spt, A, rows, cols, vals = _tune_shards(1 << 16, "float64", 2)
    n = A.nrows
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(n),
                        device=dev)
    spt.matvec_kernel(1.0, A, x, 0.0, None)
    old = A.csx._executor()._graphs[("mv",)]
    r0 = A.csx.partition.row_start[1]
    i = int(np.nonzero(rows >= r0)[0][5])
    spt.mat_set_entry(A, int(rows[i]), int(cols[i]), 7.5)
    new = vals.astype(np.float64)
    new[i] = 7.5
    spt.matvec_kernel(1.0, A, x, 0.0, None)
    y = spt.matvec_kernel(1.0, A, x, 0.0, None)
    assert A.csx.replans == 1
    assert A.csx._executor()._graphs[("mv",)] is not old
    want = np.bincount(rows, weights=new * x.cpu().numpy()[cols],
                       minlength=n)
    assert chip_smoke._mixed_rel_err(y.cpu().numpy(), want) < 1e-10


@pytest.mark.parametrize("nshards", [1, 2])
def test_restore_on_the_card_is_bit_equal(dev, tmp_path, nshards):
    """``mat_save`` then ``mat_restore`` onto the card: the restored
    plans' device arrays equal the original's, and so does the SpMV (the
    eager bodies under torch's deterministic algorithms, which make the
    residual adds' ``index_add_`` sum in a fixed order)."""
    import chip_smoke
    # the fused plan in every shard: no kernel of ours adds atomically
    spt, A, rows, cols, vals = _tune_shards(1 << 18, "float32", nshards)
    assert all("dfused" in chip_smoke.extras_of(e.meta)
               for e in A.csx.executors)
    path = str(tmp_path / "a.npz")
    spt.mat_save(A, path)
    B = spt.mat_restore(path)
    assert B.device == A.device
    for a, b in zip(A.csx.executors, B.csx.executors):
        assert a.meta == b.meta and chip_smoke._same_tree(a.arrays, b.arrays)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(A.nrows),
                        dtype=torch.float32, device=dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ya, yb = (m.csx._executor()._matvec(x) for m in (A, B))
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(ya, yb)
    ga = spt.matvec_kernel(1.0, A, x, 0.0, None)
    gb = spt.matvec_kernel(1.0, B, x, 0.0, None)
    assert (ga - gb).abs().max() <= 1e-6 * ga.abs().max()


@pytest.mark.parametrize("mode", ["off", "on"])
def test_symmetric_shards_on_the_card(dev, monkeypatch, mode):
    """Symmetric 2^14 in 2 shards, both modes, on the card against the
    oracle: per shard, shard 1 runs at ``row_start`` > 0 with both paged
    delta streams."""
    import chip_smoke
    monkeypatch.setattr(tpk, "MIN_PAGE_NNZ", 256)
    monkeypatch.setattr(troute, "MIN_ELEMS", 1024)
    spt, A, rows, cols, vals = _tune_shards(
        1 << 14, "float64", 2, chip_smoke.build_symmetric_matrix,
        **{"spx.matrix.symmetric": "true", "spx.tpu.sym_full": mode})
    n = A.nrows
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(n),
                        device=dev)
    y = spt.matvec_kernel(1.0, A, x, 0.0, None)
    y = spt.matvec_kernel(1.0, A, x, 0.0, None)
    want = np.bincount(rows, weights=vals.astype(np.float64)
                       * x.cpu().numpy()[cols], minlength=n)
    assert chip_smoke._mixed_rel_err(y.cpu().numpy(), want) < 1e-10
    if mode == "off":
        assert [e.row_start for e in A.csx.executors] == \
            A.csx.partition.row_start[:2]
        assert chip_smoke.graph_kernels(
            A.csx._executor()._graphs[("mv",)].graph) == {
            k: v for k, v in chip_smoke.matrix_counts(A.csx).items() if v}


# ---------------------------------------------------------------------------
# the solvers: a block of iterations captured as one CUDA graph
# ---------------------------------------------------------------------------

# s.p.d. matrices -> (chip_smoke builder, rows, options): the CSX-Sym
# matrix with 2.0 on its diagonal as a general matrix (the fused delta
# pipeline), as its full mirror and in two shards; HPCG's stencil at 16^3
# (the plain DIA tables)
SOLVER_PLANS = {
    "general": ("spd_symmetric_matrix", 1 << 17, {}),
    "mirror": ("spd_symmetric_matrix", 1 << 17,
               {"spx.matrix.symmetric": "true", "spx.tpu.sym_full": "on"}),
    "shards": ("spd_symmetric_matrix", 1 << 16, {"spx.rt.nr_threads": "2"}),
    "hpcg": ("hpcg_matrix", 16 ** 3, {"spx.preproc.sampling": "none"}),
}
# graph against eager solve: max |x - x_eager| / max |x_eager|
SOLVE_BAR = {"float64": 1e-10, "float32": 1e-5}


def _solver_plan(plan, dtype):
    import chip_smoke
    import sparsex_tpu_torch as spt

    build, n, options = SOLVER_PLANS[plan]
    if build == "hpcg_matrix":
        _n, rows, cols, vals = chip_smoke.hpcg_matrix(16)
    else:
        rows, cols, vals = getattr(chip_smoke, build)(n)
    cfg = spt.Config.reset()
    cfg.set("spx.tpu.value_dtype", dtype)
    cfg.set("spx.preproc.xform", "all")
    for key, value in options.items():
        cfg.set(key, value)
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n))
    return A, n, rows, cols, vals


@pytest.mark.parametrize("plan", sorted(SOLVER_PLANS))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_solver_graph_equals_eager(dev, plan, dtype):
    """CG from one captured block of ``solvers.BLOCK`` iterations against
    the same solve run eagerly (one iteration a Python step, the same
    kernels): the same count and x within ``SOLVE_BAR`` (the shards' plans
    add residuals with atomics, which reorder sums); the block's graph
    holds ``BLOCK`` SpMVs' kernels; the f64 solve meets the float64 COO
    oracle's residual.  The kept graph is read and dropped before any
    assertion: a failed test's frames would keep it to be freed in the
    middle of a later test's capture."""
    import chip_smoke
    from sparsex_tpu_torch import solvers

    A, n, rows, cols, vals = _solver_plan(plan, dtype)
    b = torch.as_tensor(np.random.default_rng(11).standard_normal(n),
                        dtype=getattr(torch, dtype), device=dev)
    tol = 1e-8 if dtype == "float64" else 1e-4
    st, ste = {}, {}
    x, it, res = solvers.cg(A.csx.matvec, b, tol=tol, stats=st)
    xe, ite, rese = solvers.cg(A.csx.matvec, b, tol=tol, graph=False,
                               stats=ste)
    kernels = chip_smoke.graph_kernels(st.pop("graph"))
    del st["state"], ste["state"]
    assert it == ite and 0 < it < 1000
    assert (x - xe).abs().max() <= SOLVE_BAR[dtype] * xe.abs().max()
    assert ste["graph"] is None
    assert st["blocks"] == ste["blocks"] == -(-it // solvers.BLOCK)
    one = chip_smoke.matrix_counts(A.csx)
    assert kernels == {k: solvers.BLOCK * v for k, v in one.items() if v}
    if dtype == "float64":
        xh = x.cpu().numpy()
        r = b.cpu().numpy() - np.bincount(rows, weights=vals * xh[cols],
                                          minlength=n)
        assert np.linalg.norm(r) <= 1e-7 * np.linalg.norm(b.cpu().numpy())


@pytest.mark.parametrize("k", [3, 8])
def test_block_cg_graph_runs_the_kb_kernels(dev, k):
    """Block CG on the fused plan: one captured block replays ``BLOCK``
    k-batched SpMMs; its x is the eager solve's within ``SOLVE_BAR`` and,
    column by column, cg's within 1e-8."""
    import chip_smoke
    from sparsex_tpu_torch import solvers

    A, n, rows, cols, vals = _solver_plan("general", "float64")
    B = torch.as_tensor(np.random.default_rng(12).standard_normal((n, k)),
                        device=dev)
    st = {}
    X, it, res = solvers.block_cg(A.csx.matmat, B, tol=1e-8, stats=st)
    Xe, ite, _ = solvers.block_cg(A.csx.matmat, B, tol=1e-8, graph=False)
    kernels = chip_smoke.graph_kernels(st.pop("graph"), kb=True)
    del st
    assert it == ite and res.shape == (k,)
    assert (X - Xe).abs().max() <= SOLVE_BAR["float64"] * Xe.abs().max()
    one = chip_smoke.matrix_counts(A.csx, k)
    assert kernels == {key: solvers.BLOCK * v for key, v in one.items() if v}
    for j in range(k):
        xj, itj, _ = solvers.cg(A.csx.matvec, B[:, j].contiguous(),
                                tol=1e-8)
        assert itj <= it
        assert (X[:, j] - xj).abs().max() <= 1e-8 * xj.abs().max()


def test_solver_capture_failure_raises(dev):
    """A matvec that syncs with the host cannot be captured: the solve
    raises, naming the block; it does not fall back to the eager loop."""
    from sparsex_tpu_torch import solvers

    A, n, *_rest = _solver_plan("hpcg", "float64")

    def syncing(v):
        float(v.sum())
        return A.csx.matvec(v)

    b = torch.ones(n, dtype=torch.float64, device=dev)
    with pytest.raises(RuntimeError, match="cg's block of 16 iterations"):
        solvers.cg(syncing, b)
    x, it, _ = solvers.cg(syncing, b, graph=False)
    assert it > 0 and torch.isfinite(x).all()
    torch.cuda.synchronize()


def test_solver_on_the_card_matches_the_cpu(dev):
    """The same matrix and b solved on the card and on the CPU (the plain
    kernel versions): the same count, x within 1e-10."""
    import chip_smoke
    import sparsex_tpu_torch as spt
    from sparsex_tpu_torch import solvers

    rows, cols, vals = chip_smoke.spd_symmetric_matrix(1 << 14)
    n = 1 << 14
    b = np.random.default_rng(13).standard_normal(n)
    out = []
    for device in ("cuda:0", "cpu"):
        cfg = spt.Config.reset()
        cfg.set("spx.preproc.xform", "all")
        A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n),
                         device=device)
        out.append(solvers.cg(A.csx.matvec, b, tol=1e-10, device=device))
    (xg, itg, _), (xc, itc, _) = out
    assert itg == itc
    assert (xg.cpu() - xc).abs().max() <= 1e-10 * xc.abs().max()
