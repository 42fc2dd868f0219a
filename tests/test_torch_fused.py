"""Plain PyTorch kernels of sparsex_tpu_torch against the Pallas kernels.

Each of K1, T1, K2 and K3 (``sparsex_tpu_torch/ops/fused.py``) runs its
plain PyTorch version on CPU tensors; the reference Pallas kernel
(``sparsex_tpu/ops/fused.py``) runs in interpret mode on the same inputs,
made with numpy from a seed.  K1, T1 and K2 only move and multiply values
once, so they must match exactly; K3 sums and must match to 1e-6 of the
largest value in f32.  The CUDA kernels are held against the same plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import sparsex_tpu.ops.fused as fused
import sparsex_tpu.ops.pallas_kernels as pk
from sparsex_tpu.ops import route as route_mod
from sparsex_tpu_torch.ops import convert
from sparsex_tpu_torch.ops import fused as tf

torch.set_num_threads(1)
L = 128
TILE3 = L * L


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _k1_inputs(rng, T, q8, npages, dtype):
    low = rng.integers(0, q8 * 8, (T, 8, L))
    g1 = rng.integers(-1, L, (T, 8, L))
    mg = fused.pack_k1_meta(low, g1)
    plo = rng.integers(0, npages // q8, T).astype(np.int32)
    vals = rng.standard_normal((T, 8, L)).astype(dtype)
    x2 = rng.standard_normal((npages, 8, L)).astype(dtype)
    return plo, mg, vals, x2


@pytest.mark.parametrize("q8", [1, 4, 32])
def test_k1_lp_matches_pallas(q8):
    rng = np.random.default_rng(q8)
    T, npages = 8, 64
    plo, mg, vals, x2 = _k1_inputs(rng, T, q8, npages, np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused._build_k1(T, q8, "lp", "float32")(
            jnp.asarray(plo), jnp.asarray(mg), jnp.asarray(vals),
            jnp.asarray(x2)))
    got = tf.k1(_t(plo), _t(mg), _t(vals), _t(x2), q8)
    assert got.shape == (T, 8, L) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).mean() > 0.5        # the wires really route values


def test_k1_rejects_bad_arguments():
    rng = np.random.default_rng(0)
    plo, mg, vals, x2 = _k1_inputs(rng, 8, 4, 16, np.float32)
    with pytest.raises(TypeError):
        tf.k1(_t(plo).long(), _t(mg), _t(vals), _t(x2), 4)
    with pytest.raises(ValueError):
        tf.k1(_t(plo), _t(mg), _t(vals), _t(x2[:6]), 4)   # not q8 pages
    with pytest.raises(ValueError):
        tf.k1(_t(plo), _t(mg), _t(vals).transpose(1, 2), _t(x2), 4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_t1_matches_pallas(dtype):
    rng = np.random.default_rng(7)
    A2R = 6
    a1 = rng.standard_normal((A2R * L, L)).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused._build_t1(A2R, np.dtype(dtype).name)(
            jnp.asarray(a1)))
    got = tf.t1(_t(a1), A2R)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), a1.reshape(A2R, L, L).transpose(0, 2, 1))


@pytest.mark.parametrize("um2", [True, False])
def test_k2_matches_pallas(um2):
    """A2R = 13 is not a multiple of 8 (ceil8 = 16, 8 colors per batched
    transpose in the unmasked Pallas kernel); W2 = 16 < 128 and D2R = 5
    exercise the pad lanes."""
    rng = np.random.default_rng(11 if um2 else 12)
    A2R, W2, D2R = 13, 16, 5
    A2R8 = 16
    a1t = rng.standard_normal((A2R, L, L)).astype(np.float32)
    lo = 0 if um2 else -1
    g2a = rng.integers(lo, L, (L, A2R, L)).astype(np.int8)
    # unmasked plans keep g2b targets below ceil8(A2R) (route.py:274-281);
    # targets in [A2R, A2R8) and g2c targets >= W2 read zero pad lanes
    g2b = rng.integers(lo, A2R8, (L, W2, L)).astype(np.int8)
    g2c = rng.integers(lo, 2 * W2, (L, D2R, L)).astype(np.int8)
    g2b_pallas = fused._g2b_lane_offset(g2b, A2R) if um2 else g2b
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused._build_k2(A2R, W2, D2R, "float32",
                                          um2=um2)(
            jnp.asarray(a1t), jnp.asarray(g2a), jnp.asarray(g2b_pallas),
            jnp.asarray(g2c)))
    got = tf.k2(_t(a1t), _t(g2a), _t(g2b), _t(g2c), W2, D2R)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).mean() > 0.2


def test_k2_matches_route_numpy_reference():
    """The K2 composition on raw wires equals the middle stages of
    ``route._route_instance_np`` on a real planner instance."""
    rng = np.random.default_rng(5)
    n = 1 << 14
    dest = rng.integers(0, n, 64 * L)
    plan = route_mod.build_scatter_plan(dest, n, min_elems=1)
    metas, arrs, _res_pos, _res_dest = plan
    meta, a = metas[0], arrs[0]
    S1c, S1p, A2R, D2R, _Dp, _K, W2 = meta[:7]
    src = rng.standard_normal((S1c, L))
    A0 = np.zeros((S1p, L))
    A0[:S1c] = src
    A1 = route_mod._take_masked_np(A0, a["g1"])
    a1t = tf.t1(torch.from_numpy(A1), A2R)
    e1 = tf.k2(a1t, _t(a["g2a"].reshape(L, A2R, L)),
               _t(a["g2b"].reshape(L, W2, L)),
               _t(a["g2c"].reshape(L, D2R, L)), W2, D2R)
    # downstream of E1 the numpy reference is one transpose + K gathers
    E2 = e1.numpy().reshape(L, D2R * L)[:, :meta[4]].T
    out = sum(route_mod._take_masked_np(E2, a["g3"][k])
              for k in range(a["g3"].shape[0])).reshape(-1)
    np.testing.assert_array_equal(out, route_mod._route_instance_np(
        src, a, meta))


def _k3_case(rng, D2R, ncols, n_inst, um3, dia, anti, K=3):
    e1_np, g3_np = [], []
    for _ in range(n_inst):
        e1_np.append(rng.standard_normal((L, D2R, L)).astype(np.float32))
        g3_np.append(rng.integers(0 if um3 else -1, L,
                                  (D2R, K, L, L)).astype(np.int8))
    nrows = D2R * TILE3
    r = np.arange(nrows)

    def grid(offs, is_anti):
        if not offs:
            return None
        v = rng.standard_normal((len(offs), nrows)).astype(np.float32)
        for k, o in enumerate(offs):
            c = o - r if is_anti else r + o
            v[k, (c < 0) | (c >= ncols)] = 0   # the encoder's guarantee
        return np.ascontiguousarray(
            v.reshape(len(offs), D2R, L, L).transpose(1, 0, 2, 3))

    dv, adv = grid(dia, False), grid(anti, True)
    x = rng.standard_normal(ncols).astype(np.float32)
    return e1_np, g3_np, dv, adv, x


def _k3_both(e1_np, g3_np, um3, dia, dv, anti, adv, x, nrows, ncols):
    K = g3_np[0].shape[1] if g3_np else 0
    with pltpu.force_tpu_interpret_mode():
        e1g3 = [(jnp.asarray(e), jnp.asarray(g), K, um3)
                for e, g in zip(e1_np, g3_np)]
        pack = (tuple(dia), None if dv is None else jnp.asarray(dv),
                tuple(anti), None if adv is None else jnp.asarray(adv))
        want = np.asarray(fused.k3_combine(e1g3, pack, jnp.asarray(x),
                                           nrows, ncols))
    tpack = (tuple(dia), None if dv is None else _t(dv), tuple(anti),
             None if adv is None else _t(adv))
    got = tf.k3_combine([(_t(e), _t(g), K, um3)
                         for e, g in zip(e1_np, g3_np)], tpack, _t(x),
                        nrows, ncols).numpy()
    return got, want


@pytest.mark.parametrize("n_inst,um3,dia,anti", [
    (1, True, (-13, -1, 0, 1, 8), ()),
    (2, False, (-20000, 300, 16390), (5, 40000)),
    (2, True, (), (0, 32767)),
])
def test_k3_matches_pallas(n_inst, um3, dia, anti):
    """Negative, positive and anti offsets; a ragged x (ncols below the
    padded y grid) so the Pallas kernel reads clamped edge blocks."""
    rng = np.random.default_rng(n_inst * 10 + len(dia))
    D2R, ncols = 2, 30000
    nrows = D2R * TILE3 - 700
    e1_np, g3_np, dv, adv, x = _k3_case(rng, D2R, ncols, n_inst, um3, dia,
                                        anti)
    got, want = _k3_both(e1_np, g3_np, um3, dia, dv, anti, adv, x, nrows,
                         ncols)
    assert got.shape == (nrows,)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_k3_combine_splits_above_eight_instances():
    rng = np.random.default_rng(9)
    D2R, ncols = 1, TILE3
    e1_np, g3_np, dv, _adv, x = _k3_case(rng, D2R, ncols, 9, False,
                                         (-3, 0, 2), (), K=1)
    got, want = _k3_both(e1_np, g3_np, False, (-3, 0, 2), dv, (), None, x,
                         TILE3, ncols)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("A2R", [1, 13, 46, 64, 100, 128])
def test_g2b_lane_offset_round_trip(A2R):
    rng = np.random.default_rng(A2R)
    A2R8 = min(L, -(-A2R // 8) * 8)
    raw = rng.integers(0, A2R8, (L, 32, L)).astype(np.int8)
    baked = fused._g2b_lane_offset(raw, A2R)
    np.testing.assert_array_equal(convert.g2b_raw(baked, A2R), raw)


@pytest.fixture
def small_thresholds(monkeypatch):
    monkeypatch.setattr(fused, "MIN_FUSED_NNZ", 256)
    monkeypatch.setattr(pk, "MIN_PAGE_NNZ", 64)
    monkeypatch.setattr(route_mod, "MIN_ELEMS", 64)


def test_plan_to_torch_round_trip(small_thresholds):
    """Every uploaded stream reads back as the planner's array; g2b of an
    unmasked instance reads back raw, and re-offsetting restores it."""
    rng = np.random.default_rng(2)
    n = 1 << 15
    rows = rng.integers(0, n, 12000)
    cols = rng.integers(0, n, 12000)
    key = rows * n + cols
    _, u = np.unique(key, return_index=True)
    rows, cols = rows[u], cols[u]
    vals = rng.standard_normal(rows.size).astype(np.float32)
    fmeta, farr = fused.build_fused_delta(cols, rows, vals, n, n)
    assert fmeta is not None
    meta = (n, n, (), (), (), ("dfused", fmeta))
    out = convert.plan_to_torch(meta, {"fused": farr}, "cpu",
                                torch.float32)["fused"]
    host = {k: v for k, v in farr.items() if not k.startswith("_")}
    assert set(out) == set(host)
    for key, a in host.items():
        back = out[key].numpy()
        if key.startswith("g2b_"):
            inst = fmeta[3][int(key[4:])]
            assert inst[9] & 1, "planner instances are unmasked"
            back = fused._g2b_lane_offset(back, inst[2])
        assert back.dtype.kind == a.dtype.kind
        np.testing.assert_array_equal(back, a)
