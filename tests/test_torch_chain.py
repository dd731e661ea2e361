"""Chain stage of the PyTorch port against the JAX reference: the
chain_scan kernel's plain version (what the wrapper runs for CPU tensors)
against chain_scan_pallas in interpret mode, and chain_anchors in every
mode. off / pred exact; f at the reference kernel tests' tolerance."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import chain as C
from repro.data import genomics
from repro.kernels.chain_scan import chain_scan_pallas
from repro_torch.core import chain as TC
from repro_torch.kernels import chain_scan as KC
from repro_torch.kernels import ops as TOPS

RTOL, ATOL = 1e-5, 1e-4       # tests/test_kernels_pallas.py:89-91

# jitted, as the reference's read mapper runs it
_chain_jit = jax.jit(C.chain_anchors, static_argnames=("T", "mode", "block"))


def _masked_scores(n, t, seed):
    """Random band scores with a NEG mask and no forward references, as in
    tests/test_kernels_pallas.py."""
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(n, t)).astype(np.float32)
    scores[rng.random((n, t)) < 0.5] = -1e18
    for i in range(min(n, t)):
        scores[i, i:] = -1e18
    return scores


@pytest.mark.parametrize("n,t", [(256, 64), (512, 128), (300, 17)])
def test_chain_scan_plain_vs_pallas(n, t):
    scores = _masked_scores(n, t, n + t)
    w = np.full((n,), 15.0, np.float32)
    pad = (-n) % 256
    sp = np.concatenate([scores, np.full((pad, t), -1e18, np.float32)])
    wp = np.concatenate([w, np.full((pad,), -1e18, np.float32)])
    f_pal, off_pal = chain_scan_pallas(jnp.asarray(sp), jnp.asarray(wp),
                                       block=256)
    f, off = KC.chain_scan(torch.as_tensor(scores), torch.as_tensor(w))
    np.testing.assert_array_equal(off.numpy(), np.asarray(off_pal)[:n])
    np.testing.assert_allclose(f.numpy(), np.asarray(f_pal)[:n],
                               rtol=RTOL, atol=ATOL)


def test_chain_scan_ties_take_the_first_index():
    n, t = 64, 8
    scores = np.full((n, t), 1.0, np.float32)     # every candidate ties
    w = np.full((n,), 0.5, np.float32)
    f_ref, off_ref = C.chain_sequential(jnp.asarray(scores), jnp.asarray(w))
    f, off = KC.chain_scan(torch.as_tensor(scores), torch.as_tensor(w))
    np.testing.assert_array_equal(off.numpy(), np.asarray(off_ref))
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_ref))


def test_chain_scan_batched_plain_matches_rows():
    scores = np.stack([_masked_scores(128, 32, s) for s in range(3)])
    w = np.full((3, 128), 15.0, np.float32)
    f, off = KC.chain_scan(torch.as_tensor(scores), torch.as_tensor(w))
    for p in range(3):
        f1, o1 = KC.chain_scan(torch.as_tensor(scores[p]),
                               torch.as_tensor(w[p]))
        assert torch.equal(f[p], f1) and torch.equal(off[p], o1)


@pytest.mark.parametrize("n,seed", [(100, 0), (333, 1), (700, 2)])
def test_chain_scores_match(n, seed):
    q, r = genomics.anchor_set(n, seed=seed, noise=30)
    want = np.asarray(C.chain_scores(jnp.asarray(q), jnp.asarray(r), 64))
    got = TC.chain_scores(torch.as_tensor(q), torch.as_tensor(r), 64).numpy()
    np.testing.assert_array_equal(got <= -1e17, want <= -1e17)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode,n,seed", [
    ("sequential", 100, 0), ("sequential", 333, 1), ("sequential", 700, 2),
    ("blocked", 333, 1)])
def test_chain_anchors_vs_reference(mode, n, seed):
    q, r = genomics.anchor_set(n, seed=seed, noise=30)
    f_ref, p_ref = _chain_jit(jnp.asarray(q), jnp.asarray(r), T=64,
                              mode=mode)
    f, p = TC.chain_anchors(torch.as_tensor(q), torch.as_tensor(r), T=64,
                            mode=mode)
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,seed", [(333, 1), (700, 2)])
def test_ops_chain_anchors_vs_pallas_path(n, seed):
    """The kernel path (ops.chain_anchors) against the reference's Pallas
    path, with padding anchors masked out."""
    from repro.kernels import ops
    q, r = genomics.anchor_set(n, seed=seed, noise=30)
    f_pal, p_pal = ops.chain_anchors(jnp.asarray(q), jnp.asarray(r), T=64)
    f, p = TOPS.chain_anchors(torch.as_tensor(q), torch.as_tensor(r), T=64)
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_pal))
    np.testing.assert_allclose(f.numpy(), np.asarray(f_pal),
                               rtol=RTOL, atol=ATOL)
    n, pad = len(q), 60
    qp = np.concatenate([q, np.zeros(pad, q.dtype)])
    rp = np.concatenate([r, np.full(pad, 2**30, r.dtype)])
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    fv, pv = TOPS.chain_anchors(torch.as_tensor(qp), torch.as_tensor(rp),
                                T=64, anchor_valid=torch.as_tensor(valid))
    np.testing.assert_array_equal(pv.numpy()[:n], p.numpy())
    np.testing.assert_array_equal(fv.numpy()[:n], f.numpy())
    assert (fv.numpy()[n:] < -1e17).all()


@pytest.mark.parametrize("block", [4, 16, 64])
def test_blocked_matches_sequential(block):
    """Blocked composes fp32 sums in another order than the row scan, so
    f agrees to rounding (as in tests/test_chain.py) and a predecessor may
    flip only where two candidates tie to rounding."""
    q, r = genomics.anchor_set(257, seed=3)
    qt, rt = torch.as_tensor(q), torch.as_tensor(r)
    f_seq, p_seq = TC.chain_anchors(qt, rt, T=32, mode="sequential")
    f_blk, p_blk = TC.chain_anchors(qt, rt, T=32, mode="blocked",
                                    block=block)
    np.testing.assert_allclose(f_blk.numpy(), f_seq.numpy(),
                               rtol=RTOL, atol=ATOL)
    assert (p_blk != p_seq).sum() <= 2


@pytest.mark.parametrize("name", ["real", "maxplus", "minplus"])
def test_semiring_matmul_and_zero_match_reference(name):
    from repro.core import semiring as SR
    from repro_torch.core import semiring as TSR
    rng = np.random.default_rng(len(name))
    a = rng.normal(size=(3, 4, 5)).astype(np.float32)
    b = rng.normal(size=(3, 5, 2)).astype(np.float32)
    want = np.asarray(SR.SEMIRINGS[name].matmul(jnp.asarray(a),
                                                jnp.asarray(b)))
    got = TSR.SEMIRINGS[name].matmul(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.int32, jnp.int32)):
        assert (TSR.finite_zero(TSR.SEMIRINGS[name], dt).item()
                == SR.finite_zero(SR.SEMIRINGS[name], jdt).item())


def test_backtrack_matches_reference():
    q, r = genomics.anchor_set(400, seed=7)
    f, p = C.chain_anchors(jnp.asarray(q), jnp.asarray(r), T=64)
    f, p = np.asarray(f), np.asarray(p)
    assert TC.backtrack(f, p, 40.0) == C.backtrack(f, p, 40.0)


def test_unbanded_oracle_copy_matches_reference():
    q, r = genomics.anchor_set(150, seed=8)
    for x, y in zip(TC.chain_ref_unbanded(q, r, T=200),
                    C.chain_ref_unbanded(q, r, T=200)):
        np.testing.assert_array_equal(x, y)
