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


@pytest.mark.parametrize("mode", ["fission", "blocked"])
def test_chain_stage_batched_equals_single_calls(mode):
    """A (3, N) stack of padded anchor sets returns what three (N,) calls
    return, exactly: scores, weights and chains (core and kernel path)."""
    sets = [genomics.anchor_set(nv, seed=seed, noise=30)
            for seed, nv in ((0, 300), (1, 170), (2, 45))]
    n = max(len(q) for q, _ in sets)
    qs, rs, vs = [], [], []
    for q, r in sets:
        nv = len(q)
        qs.append(np.pad(q, (0, n - nv)))
        rs.append(np.pad(r, (0, n - nv), constant_values=2**30))
        vs.append(np.arange(n) < nv)
    q, r, v = (torch.as_tensor(np.stack(x)) for x in (qs, rs, vs))
    scores = TC.chain_scores(q, r, 64, anchor_valid=v)
    w = TC.anchor_weights(q.shape, TC.ChainParams(), v, q.device)
    assert scores.shape == (3, n, 64) and w.shape == (3, n)
    f, p = TC.chain_anchors(q, r, T=64, mode=mode, anchor_valid=v)
    fk, pk = TOPS.chain_anchors(q, r, T=64, anchor_valid=v)
    for i in range(3):
        assert torch.equal(scores[i], TC.chain_scores(q[i], r[i], 64,
                                                      anchor_valid=v[i]))
        assert torch.equal(w[i], TC.anchor_weights(q[i].shape,
                                                   TC.ChainParams(), v[i],
                                                   q.device))
        f1, p1 = TC.chain_anchors(q[i], r[i], T=64, mode=mode,
                                  anchor_valid=v[i])
        assert torch.equal(f[i], f1) and torch.equal(p[i], p1)
        f1, p1 = TOPS.chain_anchors(q[i], r[i], T=64, anchor_valid=v[i])
        assert torch.equal(fk[i], f1) and torch.equal(pk[i], p1)


# --------------------------------------------------------------------------
# the CUDA kernel's forwarding order (csrc/chain_scan.cu), modelled in torch
# --------------------------------------------------------------------------

_GARBAGE = 3e38     # what a ring slot holds while its block is in flight


def _forwarding_chain(scores, w):
    """chain_scan.cu's order, step by step: one warp per problem (lanes are
    the last axis), rows in rounds of 32 owned by lane row mod 32, K =
    ceil(T/32) running (best, j) slots per lane, each new f shuffled from
    its owner and added to every row in flight, ties replacing (t only
    decreases), virtual rows before 0 that weigh NEG, take no candidate and
    so close at NEG, and the scores read from the kernel's ring of K+2
    shared-memory blocks at the kernel's addresses (a row outside the band
    reads the -inf sentinel past the ring). A block in flight holds garbage
    until the kernel's cp.async.wait would have landed it, so a read the
    kernel's ordering does not cover shows up in f. scores (P, N, T), w (P,
    N) fp32."""
    p, n, t = scores.shape
    k = -(-t // 32)
    rr = k + 2
    ts = t + (t & 1)
    blk = 32 * ts
    sent = rr * blk
    nblocks = -(-n // 32)
    lane = torch.arange(32)
    ring = torch.full((p, rr * blk + 1), _GARBAGE)
    ring[:, sent] = float("-inf")
    groups = []                                  # cp.async groups in order

    def issue(b):
        if b is None or b >= nblocks:
            groups.append(None)
            return
        base = (b % rr) * blk
        ring[:, base:base + blk] = _GARBAGE
        groups.append(b)

    def land(keep):                              # cp.async.wait_group keep
        while len(groups) > keep:
            b = groups.pop(0)
            if b is None:
                continue
            base = (b % rr) * blk
            rows = min(32, n - 32 * b)
            for row in range(rows):
                ring[:, base + row * ts:base + row * ts + t] = \
                    scores[:, 32 * b + row]

    def wload(m):
        row = 32 * m + lane
        got = w[:, row.clamp(0, n - 1)]
        return torch.where(row < 0, torch.tensor(TC.NEG, dtype=torch.float32),
                           torch.where(row < n, got, torch.zeros(())))

    best = torch.full((p, 32, k), float("-inf"))
    bj = torch.zeros((p, 32, k), dtype=torch.int64)
    fc = torch.full((p, 32), TC.NEG, dtype=torch.float32)
    fo = torch.zeros((p, 32))
    oo = torch.zeros((p, 32), dtype=torch.int64)
    f = torch.empty((p, n))
    off = torch.empty((p, n), dtype=torch.int32)
    m0 = -((t - 1 + 31) // 32)
    for b in range(k + 1):
        issue(b)
    wnext = wload(m0)
    for m in range(m0, nblocks):
        issue(m + k + 1 if m >= 0 else None)
        land(1)
        wcur, wnext = wnext, wload(m + 1)
        row = 32 * m + lane
        cb = [(m + d) % rr * blk + lane * ts + 32 * d - 1 for d in range(k)]
        lim = [torch.full((32,), t - 32 * d if m + d >= 0 else -(1 << 30))
               for d in range(k)]
        cb_next = (m + k) % rr * blk + lane * ts + 32 * k - 1
        for s in range(32):
            j = 32 * m + s - 1
            fj = fc[:, (s + 31) % 32]
            lt = lane - s + 1
            bw = torch.maximum(best[:, :, 0], wcur)
            for d in range(k):
                inb = lt <= lim[d]
                c = ring[:, torch.where(inb, cb[d] + lt, sent)] + fj[:, None]
                if d == 0:
                    c0 = c
                take = inb & (c >= best[:, :, d])
                best[:, :, d] = torch.where(take, c, best[:, :, d])
                bj[:, :, d] = torch.where(take, j, bj[:, :, d])
            fc = torch.maximum(c0, bw)
            close = lt == 1
            fo = torch.where(close, fc, fo)
            oo = torch.where(close, torch.where(best[:, :, 0] >= wcur,
                                                row - bj[:, :, 0], 0), oo)
            best[:, :, 0] = torch.where(close, float("-inf"), best[:, :, 0])
            cb[0] = torch.where(close, cb_next, cb[0])
            lim[0] = torch.where(close, t - 32 * k, lim[0])
        ok = (row >= 0) & (row < n)
        f[:, row[ok]] = fo[:, ok]
        off[:, row[ok]] = oo[:, ok].int()
        best = torch.roll(best, -1, dims=2)
        bj = torch.roll(bj, -1, dims=2)
    return f, off


def _tie_scores(p, n, t, seed):
    """(P, N, T) integer-valued band scores (so candidates tie), a random
    half masked to NEG; the band reaches before row 0 unmasked, so rows i <
    T take S[i, t-1] + NEG for i - t < 0 and tie there. w of 15 or small
    integers with a tenth NEG (invalid anchors); the last problem's w is
    all NEG, so that f sits at NEG and the seeded candidates decide off."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(-3, 4, (p, n, t)).astype(np.float32)
    scores[rng.random((p, n, t)) < 0.5] = -1e18
    w = rng.choice(np.array([15.0, 1.0, 2.0], np.float32), (p, n))
    w[rng.random((p, n)) < 0.1] = -1e18
    w[-1] = -1e18
    return scores, w


@pytest.mark.parametrize("n,t", [(20, 1), (20, 33), (100, 128), (257, 64),
                                 (70, 33), (31, 128), (200, 64)])
def test_forwarding_order_is_the_row_scan_bit_for_bit(n, t):
    """The kernel's order, as modelled above, against chain_sequential (JAX
    and port) and chain_scan_pallas (interpret mode), bit for bit: f and
    off, for 3 problems, with ties, NEG weights and N < 32, N < T or N not a
    multiple of 32."""
    scores, w = _tie_scores(3, n, t, seed=n * t)
    f, off = _forwarding_chain(torch.as_tensor(scores), torch.as_tensor(w))
    f_plain, off_plain = KC.chain_scan_plain(torch.as_tensor(scores),
                                             torch.as_tensor(w))
    assert torch.equal(off, off_plain) and torch.equal(f, f_plain)
    pad = (-n) % 256
    for i in range(3):
        f_ref, off_ref = C.chain_sequential(jnp.asarray(scores[i]),
                                            jnp.asarray(w[i]))
        np.testing.assert_array_equal(off[i].numpy(), np.asarray(off_ref))
        np.testing.assert_array_equal(f[i].numpy(), np.asarray(f_ref))
        sp = np.concatenate([scores[i], np.full((pad, t), -1e18,
                                                np.float32)])
        wp = np.concatenate([w[i], np.full((pad,), -1e18, np.float32)])
        f_pal, off_pal = chain_scan_pallas(jnp.asarray(sp), jnp.asarray(wp),
                                           block=256)
        np.testing.assert_array_equal(off[i].numpy(), np.asarray(off_pal)[:n])
        np.testing.assert_array_equal(f[i].numpy(), np.asarray(f_pal)[:n])
    # ties did occur, and so did chains that start at a NEG weight
    assert (off > 0).any() and (off == 0).any()
