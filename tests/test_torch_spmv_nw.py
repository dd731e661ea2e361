"""SpMV (paper Fig. 1c) and Needleman-Wunsch (paper §V-C) of the PyTorch
port against the JAX reference on the CPU.

``random_csr`` is a numpy copy of the reference's, so one seed gives
identical arrays. Both SpMV forms agree with the JAX functions within 1e-5
(absolute and relative: the sums run in another order), for any worker
chunking. NW scores are integers, exact in fp32, so ``nw_ref`` and
``nw_tiled`` equal the reference's matrices exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import align as RA
from repro.core import spmv as RS
from repro_torch.core import align as TA
from repro_torch.core import spmv as TS

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = [(32, 40, 0.2, 0.0, 4),
         (100, 64, 0.1, 0.5, 8),      # power-law row lengths (imbalance)
         (17, 23, 0.3, 0.0, 5),       # odd sizes
         (64, 200, 0.02, 2.0, 3)]     # heavy skew, rows up to all columns


def _pair(n_rows, n_cols, density, skew, seed):
    return (RS.random_csr(n_rows, n_cols, density, seed=seed, skew=skew),
            TS.random_csr(n_rows, n_cols, density, seed=seed, skew=skew,
                          device="cpu"))


@pytest.mark.parametrize("n_rows,n_cols,density,skew,chunks", CASES)
def test_random_csr_is_the_reference_matrix(n_rows, n_cols, density, skew,
                                            chunks):
    want, got = _pair(n_rows, n_cols, density, skew, seed=n_rows)
    assert got.n_cols == want.n_cols
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(TS.to_dense(got, n_rows),
                                  RS.to_dense(want, n_rows))
    for w, g in zip(RS._ell_pack(want, n_rows, chunks),
                    TS._ell_pack(got, n_rows, chunks)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("n_rows,n_cols,density,skew,chunks", CASES)
def test_spmv_matches_the_reference_and_dense(n_rows, n_cols, density, skew,
                                              chunks):
    jm, tm = _pair(n_rows, n_cols, density, skew, seed=n_rows)
    x = np.random.default_rng(1).normal(size=n_cols).astype(np.float32)
    xt = torch.as_tensor(x)
    dense = TS.to_dense(tm, n_rows) @ x
    for want, got in (
            (RS.spmv_chunked(jm, jnp.asarray(x), n_rows, num_chunks=chunks),
             TS.spmv_chunked(tm, xt, n_rows, num_chunks=chunks)),
            (RS.spmv_segsum(jm, jnp.asarray(x), n_rows),
             TS.spmv_segsum(tm, xt, n_rows))):
        assert got.shape == (n_rows,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), dense, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunks", [1, 2, 5, 7, 12])
@pytest.mark.parametrize("seed", [0, 3, 6])
def test_spmv_chunk_invariance(chunks, seed):
    """Any worker chunking gives the segment-sum result (the Squire claim):
    the examples of the reference's property test on a fixed grid."""
    n_rows, n_cols = 24, 16
    jm, tm = _pair(n_rows, n_cols, 0.25, 0.0, seed)
    x = np.random.default_rng(seed).normal(size=n_cols).astype(np.float32)
    base = np.asarray(RS.spmv_segsum(jm, jnp.asarray(x), n_rows))
    got = TS.spmv_chunked(tm, torch.as_tensor(x), n_rows, num_chunks=chunks)
    np.testing.assert_allclose(got.numpy(), base, **TOL)
    np.testing.assert_allclose(
        TS.spmv_segsum(tm, torch.as_tensor(x), n_rows).numpy(), base, **TOL)


def test_row_ids_and_empty_rows():
    """Rows without nonzeros get 0 from both forms; row ids are monotone."""
    indptr = torch.tensor([0, 2, 2, 3, 3, 5], dtype=torch.int32)
    m = TS.CSR(indptr, torch.tensor([0, 3, 1, 2, 3], dtype=torch.int32),
               torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0]), 4)
    assert TS.row_ids(m).tolist() == [0, 0, 2, 4, 4]
    x = torch.tensor([1.0, 10.0, 100.0, 1000.0])
    want = [2001.0, 0.0, 30.0, 0.0, 5400.0]
    assert TS.spmv_segsum(m, x, 5).tolist() == want
    assert TS.spmv_chunked(m, x, 5, num_chunks=2).tolist() == want


@pytest.mark.parametrize("n,m,tile", [(16, 16, 8), (24, 40, 8), (13, 9, 4),
                                      (37, 29, 8)])
def test_nw_equals_the_reference_exactly(n, m, tile):
    rng = np.random.default_rng(n * 100 + m)
    a = rng.integers(0, 4, n).astype(np.int32)
    b = rng.integers(0, 4, m).astype(np.int32)
    want = np.asarray(RA.nw_ref(jnp.asarray(a), jnp.asarray(b)))
    got = TA.nw_ref(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_array_equal(got.numpy(), want)
    wmat, wscore = RA.nw_tiled(jnp.asarray(a), jnp.asarray(b),
                               tile_r=tile, tile_c=tile)
    gmat, gscore = TA.nw_tiled(torch.as_tensor(a), torch.as_tensor(b),
                               tile_r=tile, tile_c=tile)
    np.testing.assert_array_equal(gmat.numpy(), np.asarray(wmat))
    np.testing.assert_array_equal(gmat.numpy(), want)
    assert float(gscore) == float(wscore) == want[-1, -1]


@pytest.mark.parametrize("seed", [0, 1])
def test_nw_row_block_is_the_diagonal_tile_of_the_nw_cell(seed):
    """The row-scanned block equals the reference's form of a tile (the
    diagonal tile over ``_nw_cell``) from arbitrary integer edges."""
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.integers(0, 4, 8), dtype=torch.int32)
    b = torch.as_tensor(rng.integers(0, 4, 12), dtype=torch.int32)
    top = torch.as_tensor(rng.integers(-40, 10, 12), dtype=torch.float32)
    left = torch.as_tensor(rng.integers(-40, 10, 8), dtype=torch.float32)
    corner = torch.tensor(float(rng.integers(-40, 10)))
    p = TA.SWParams()
    want, _, _, _ = TA.wavefront.dp_tile_diagonal(
        lambda *x: TA._nw_cell(p, *x), top, left, corner, a, b)
    assert torch.equal(TA._nw_rows(p, top, left, corner, a, b), want)
    d, u, lf = (torch.as_tensor(rng.normal(size=5).astype(np.float32))
                for _ in range(3))
    av, bv = (torch.as_tensor(rng.integers(0, 4, 5)) for _ in range(2))
    np.testing.assert_array_equal(
        TA._nw_cell(p, d, u, lf, av, bv).numpy(),
        np.asarray(RA._nw_cell(p, *(jnp.asarray(x.numpy())
                                    for x in (d, u, lf, av, bv)))))


def test_nw_identical_sequences_and_global_vs_local():
    a = torch.as_tensor(np.arange(12) % 4, dtype=torch.int32)
    _, score = TA.nw_tiled(a, a, tile_r=4, tile_c=4)
    assert float(score) == 2.0 * 12                  # all matches
    rng = np.random.default_rng(3)
    core = rng.integers(0, 4, 10).astype(np.int32)
    x = torch.as_tensor(np.concatenate([np.full(5, 0, np.int32), core]))
    y = torch.as_tensor(np.concatenate([np.full(5, 3, np.int32), core]))
    sw_best = float(torch.amax(TA.sw_ref(x, y)))
    _, nw_score = TA.nw_tiled(x, y, tile_r=5, tile_c=5)
    assert sw_best >= 2.0 * 10 and float(nw_score) < sw_best
