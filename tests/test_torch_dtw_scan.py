"""DTW and the 1-D affine scans of the PyTorch port against the JAX
reference. DTW matrices exact (the same fp32 cell arithmetic); the scans
exact in the max-plus and min-plus semirings and at rtol 1e-5 in the real
one, where XLA may fuse a multiply-add; the chunked matrix-state scan at
rtol 1e-5 (its log/exp/cumsum run in other libraries)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import dtw as JD
from repro.core import scan1d as JS
from repro.core import semiring as JSR
from repro_torch.core import dtw as TD
from repro_torch.core import scan1d as TS
from repro_torch.core import semiring as TSR
from repro_torch.kernels import ops

_dtw_ref_jit = jax.jit(JD.dtw_ref)
_dtw_diag_jit = jax.jit(JD.dtw_diag)
_affine_jit = jax.jit(JS.affine_scan,
                      static_argnames=("sr", "mode", "num_chunks",
                                       "boundary_mode"))


def _series(n, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n).astype(np.float32),
            rng.normal(size=m).astype(np.float32))


@pytest.mark.parametrize("n,m", [(1, 1), (13, 21), (24, 16)])
def test_dtw_ref_and_diag_exact(n, m):
    s, r = _series(n, m, n * m)
    js, jr = jnp.asarray(s), jnp.asarray(r)
    ts, tr = torch.as_tensor(s), torch.as_tensor(r)
    np.testing.assert_array_equal(TD.dtw_ref(ts, tr).numpy(),
                                  np.asarray(_dtw_ref_jit(js, jr)))
    np.testing.assert_array_equal(TD.dtw_diag(ts, tr).numpy(),
                                  np.asarray(_dtw_diag_jit(js, jr)))


@pytest.mark.parametrize("n,m,tr,tc", [(13, 21, 16, 8)])
def test_dtw_tiled_exact(n, m, tr, tc):
    s, r = _series(n, m, n + m)
    want_mat, want_d = JD.dtw_tiled(jnp.asarray(s), jnp.asarray(r), tr, tc)
    mat, d = TD.dtw_tiled(torch.as_tensor(s), torch.as_tensor(r), tr, tc)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(want_mat))
    assert float(d) == float(want_d)
    # the kernel path's plain tile gives the same matrix
    kmat, kd = ops.dtw_tiled(torch.as_tensor(s), torch.as_tensor(r), tr, tc)
    assert torch.equal(kmat, mat) and float(kd) == float(d)
    assert float(TD.dtw_distance(torch.as_tensor(s), torch.as_tensor(r),
                                 tile_r=tr, tile_c=tc)) == float(d)


def test_dtw_tiled_without_assembly():
    s, r = _series(32, 16, 9)
    _, want = JD.dtw_tiled(jnp.asarray(s), jnp.asarray(r), 8, 8,
                           assemble=False)
    mat, d = TD.dtw_tiled(torch.as_tensor(s), torch.as_tensor(r), 8, 8,
                          assemble=False)
    assert mat is None and float(d) == float(want)
    with pytest.raises(ValueError, match="tile-aligned"):
        TD.dtw_tiled(torch.as_tensor(s[:30]), torch.as_tensor(r), 8, 8,
                     assemble=False)


MODES = [("sequential", {}), ("associative", {}),
         ("chunked", {"num_chunks": 4}), ("chunked", {"num_chunks": 8}),
         ("chunked", {"num_chunks": 4, "boundary_mode": "associative"})]


@pytest.mark.parametrize("semiring", ["real", "maxplus", "minplus"])
@pytest.mark.parametrize("mode,kw", MODES,
                         ids=["seq", "assoc", "chunk4", "chunk8",
                              "chunk4-assoc"])
def test_affine_scan_vs_reference(semiring, mode, kw):
    rng = np.random.default_rng(len(semiring) + len(mode))
    for t in (1, 7, 33):
        a = (rng.normal(size=(t, 3)) * 0.9).astype(np.float32)
        b = rng.normal(size=(t, 3)).astype(np.float32)
        x0 = rng.normal(size=3).astype(np.float32)
        want = np.asarray(_affine_jit(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(x0),
                                      JSR.SEMIRINGS[semiring], mode=mode,
                                      **kw))
        got = TS.affine_scan(torch.as_tensor(a), torch.as_tensor(b),
                             torch.as_tensor(x0), TSR.SEMIRINGS[semiring],
                             mode=mode, **kw).numpy()
        if semiring == "real":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


def test_affine_scan_unknown_mode():
    z = torch.zeros(3)
    with pytest.raises(ValueError, match="mode"):
        TS.affine_scan(z, z, torch.zeros(()), mode="nope")


@pytest.mark.parametrize("n", [1, 2, 7, 33])
def test_associative_scan_combines_in_jax_order(n):
    """Real affine composition is not associative in fp32, so equal results
    mean equal combination order (eager JAX: no fused multiply-adds)."""
    rng = np.random.default_rng(n)
    a = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)

    def jcombine(e1, e2):
        return JSR.REAL.affine_compose(e1[0], e1[1], e2[0], e2[1])

    want = jax.lax.associative_scan(jcombine, (jnp.asarray(a),
                                               jnp.asarray(b)))
    got = TS.associative_scan(
        lambda x, y: list(TSR.REAL.affine_compose(x[0], x[1], y[0], y[1])),
        [torch.as_tensor(a), torch.as_tensor(b)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["sequential", "chunked"])
def test_diag_rank1_scan_vs_reference(mode):
    rng = np.random.default_rng(7)
    t, dk, dv = 50, 4, 3
    w = rng.uniform(0.5, 1.0, (t, dk)).astype(np.float32)
    k = rng.normal(size=(t, dk)).astype(np.float32)
    v = rng.normal(size=(t, dv)).astype(np.float32)
    s0 = rng.normal(size=(dk, dv)).astype(np.float32)
    want = np.asarray(JS.diag_rank1_scan(*(jnp.asarray(x)
                                           for x in (w, k, v, s0)),
                                         mode=mode, chunk=16))
    got = TS.diag_rank1_scan(*(torch.as_tensor(x) for x in (w, k, v, s0)),
                             mode=mode, chunk=16).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["real", "maxplus", "minplus"])
def test_semiring_affine_ops_match_reference(name):
    rng = np.random.default_rng(len(name))
    a1, b1, a2, b2, x = (rng.normal(size=5).astype(np.float32)
                         for _ in range(5))
    jsr, tsr = JSR.SEMIRINGS[name], TSR.SEMIRINGS[name]
    t = [torch.as_tensor(v) for v in (a1, b1, a2, b2, x)]
    np.testing.assert_array_equal(
        tsr.affine_apply(t[0], t[1], t[4]).numpy(),
        np.asarray(jsr.affine_apply(*(jnp.asarray(v) for v in (a1, b1, x)))))
    for g, w in zip(tsr.affine_compose(*t[:4]),
                    jsr.affine_compose(*(jnp.asarray(v)
                                         for v in (a1, b1, a2, b2)))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
