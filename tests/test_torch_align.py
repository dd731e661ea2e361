"""Align stage of the PyTorch port against the JAX reference: the DP tile
kernel's plain version (what the wrapper runs for CPU tensors) against the
Pallas tile in interpret mode, the wavefront engine, and Smith-Waterman.
SW values are integers in fp32, so they are held exactly; DTW at the
reference kernel tests' tolerance."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import align as A
from repro.core import wavefront as WF
from repro.kernels import ops
from repro_torch.core import align as TA
from repro_torch.core import wavefront as TWF
from repro_torch.kernels import dtw_wavefront as KT
from repro_torch.kernels import ops as TOPS

RTOL, ATOL = 1e-5, 1e-4       # tests/test_kernels_pallas.py:122-124


def _t(x):
    return torch.as_tensor(np.array(x))


def _sw_inputs(tr, tc, seed):
    rng = np.random.default_rng(seed)
    top = rng.integers(0, 30, tc).astype(np.float32)
    left = rng.integers(0, 30, tr).astype(np.float32)
    corner = np.float32(rng.integers(0, 30))
    a = rng.integers(0, 4, tr).astype(np.int32)
    b = rng.integers(0, 4, tc).astype(np.int32)
    return top, left, corner, a, b


@pytest.mark.parametrize("tr,tc", [(64, 64), (32, 16), (16, 32)])
def test_sw_tile_exact_vs_pallas(tr, tc):
    ins = _sw_inputs(tr, tc, tr * 1000 + tc)
    want = ops.dp_tile(*(jnp.asarray(x) for x in ins), kind="sw")
    got = KT.dp_tile(*(_t(x) for x in ins), kind="sw")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("tr,tc", [(16, 16), (32, 16)])
def test_dtw_tile_vs_pallas(tr, tc):
    rng = np.random.default_rng(tr * 100 + tc)
    ins = (rng.normal(size=tc).astype(np.float32),
           rng.normal(size=tr).astype(np.float32),
           np.float32(rng.normal()),
           rng.normal(size=tr).astype(np.float32),
           rng.normal(size=tc).astype(np.float32))
    want = ops.dtw_tile_fn(*(jnp.asarray(x) for x in ins))
    got = TOPS.dtw_tile_fn(*(_t(x) for x in ins))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


def test_tile_batched_equals_per_tile():
    ins = [_sw_inputs(16, 8, s) for s in range(3)]
    batched = [_t(np.stack([x[k] for x in ins])) for k in range(5)]
    tile, bottom, right, corner = KT.dp_tile(*batched, kind="sw")
    for p, x in enumerate(ins):
        t1, b1, r1, c1 = KT.dp_tile(*(_t(v) for v in x), kind="sw")
        assert torch.equal(tile[p], t1) and torch.equal(bottom[p], b1)
        assert torch.equal(right[p], r1) and torch.equal(corner[p], c1)


def test_dp_tile_diagonal_matches_reference():
    ins = _sw_inputs(8, 12, 5)
    cell = functools.partial(A._cell, A.SWParams())
    tcell = functools.partial(TA._cell, TA.SWParams())
    want = WF.dp_tile_diagonal(cell, *(jnp.asarray(x) for x in ins))
    got = TWF.dp_tile_diagonal(tcell, *(_t(x) for x in ins))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,m", [(48, 64), (100, 37)])
def test_sw_ref_exact(n, m):
    rng = np.random.default_rng(n + m)
    a = rng.integers(0, 4, n).astype(np.int32)
    b = rng.integers(0, 4, m).astype(np.int32)
    want = np.asarray(A.sw_ref(jnp.asarray(a), jnp.asarray(b)))
    got = TA.sw_ref(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert float(TA.sw_score_ref(_t(a), _t(b))) == float(want.max())


def _related(n, m, seed):
    """b holds a mutated copy of a, so the alignment has real structure."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 4, m).astype(np.int32)
    a = b[5:5 + n].copy()
    a[rng.random(n) < 0.1] = rng.integers(0, 4)
    return a, b


@pytest.mark.parametrize("n,m,tile", [(48, 64, 16), (70, 90, 32)])
def test_sw_tiled_kernel_path_exact_vs_pallas_path(n, m, tile):
    a, b = _related(n, m, n)
    want_mat, want_best = ops.sw_tiled(jnp.asarray(a), jnp.asarray(b),
                                       tile_r=tile, tile_c=tile)
    mat, best = TOPS.sw_tiled(_t(a), _t(b), tile_r=tile, tile_c=tile)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(want_mat))
    assert float(best) == float(want_best)
    np.testing.assert_array_equal(mat.numpy(),
                                  TA.sw_ref(_t(a), _t(b)).numpy())
    wi, wj = A.sw_end_position(want_mat)
    gi, gj = TA.sw_end_position(mat)
    assert (int(gi), int(gj)) == (int(wi), int(wj))


def test_sw_tiled_plain_tile_fn_exact_vs_reference():
    a, b = _related(40, 56, 9)
    tile_fn = jax.jit(functools.partial(A._sw_tile_fn, A.SWParams()))
    want_mat, want_best = A.sw_tiled(jnp.asarray(a), jnp.asarray(b),
                                     tile_r=8, tile_c=8, tile_fn=tile_fn)
    mat, best = TA.sw_tiled(_t(a), _t(b), tile_r=8, tile_c=8)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(want_mat))
    assert float(best) == float(want_best)
    assert float(TA.sw_score(_t(a), _t(b), tile_r=8, tile_c=8)) == float(
        want_best)


def test_run_wavefront_batched_equals_rows():
    rows = [_related(32, 48, s) for s in range(3)]
    a = torch.stack([_t(x) for x, _ in rows])
    b = torch.stack([_t(y) for _, y in rows])
    fn = TOPS.make_sw_tile_fn()
    z = functools.partial(torch.zeros, dtype=torch.float32)
    mat, bot, right, corner = TWF.run_wavefront_batched(
        fn, a, b, z(3, 48), z(3, 32), z(3), tile_r=16, tile_c=16)
    for p in range(3):
        m1, b1, r1, c1 = TWF.run_wavefront(fn, a[p], b[p], z(48), z(32),
                                           z(()), tile_r=16, tile_c=16)
        assert torch.equal(mat[p], m1) and torch.equal(bot[p], b1)
        assert torch.equal(right[p], r1) and torch.equal(corner[p], c1)
    with pytest.raises(ValueError, match="multiples"):
        TWF.run_wavefront(fn, a[0][:30], b[0], z(48), z(30), z(()), 16, 16)


@pytest.mark.parametrize("n,mult,fill", [(10, 4, 255), (12, 4, 0),
                                         (5, 8, -1.5)])
def test_pad_to_multiple_matches_reference(n, mult, fill):
    x = np.arange(n, dtype=np.float32 if isinstance(fill, float)
                  else np.int32)
    want = np.asarray(WF.pad_to_multiple(jnp.asarray(x), mult, 0, fill))
    got = TWF.pad_to_multiple(_t(x), mult, 0, fill).numpy()
    np.testing.assert_array_equal(got, want)
