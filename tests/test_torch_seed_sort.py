"""Seed stage of the PyTorch port against the JAX reference, exactly: the
hash, k-mer codes, minimizers, index, probe, radix sort and merge."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import seeding as S
from repro.core import sort as R
from repro_torch.convert import index_from_numpy
from repro_torch.core import seeding as TS
from repro_torch.core import sort as TR

K, W = 15, 10

# the reference runs these jitted, as its read mapper's dispatcher does
_seed_jit = jax.jit(S.seed, static_argnums=(2, 3),
                    static_argnames=("max_occ", "num_sort_chunks"))
_sort_jit = jax.jit(R.radix_sort,
                    static_argnames=("num_chunks", "key_bits", "min_parallel"))
_sort_i32_jit = jax.jit(R.sort_i32,
                        static_argnames=("num_chunks", "min_parallel"))


def _t(x):
    return torch.as_tensor(np.array(x))


def _seq(n, seed):
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.int8)


def test_hash32_exact():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 2**32, 5000, dtype=np.uint32),
                        np.array([0, 1, 2**31, 2**32 - 1], np.uint32)])
    want = np.asarray(S.hash32(jnp.asarray(x)))
    got = TS.hash32(_t(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("n,k", [(300, 15), (257, 11), (64, 5)])
def test_kmer_codes_exact(n, k):
    seq = _seq(n, n)
    want = np.asarray(S.kmer_codes(jnp.asarray(seq), k))
    got = TS.kmer_codes(_t(seq), k).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("n,seed", [(400, 0), (1000, 1)])
def test_minimizers_exact(n, seed):
    seq = _seq(n, seed)
    seq[100:160] = seq[40:100]          # repeats make hash ties
    wp, wh, wk = (np.asarray(x) for x in
                  S.minimizers(jnp.asarray(seq), K, W))
    gp, gh, gk = (x.numpy() for x in TS.minimizers(_t(seq), K, W))
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gh, wh.astype(np.int64))
    np.testing.assert_array_equal(gk, wk)


def test_minimizers_leftmost_on_ties():
    seq = np.zeros(40, np.int8)         # every k-mer equal: all ties
    wp, _, _ = S.minimizers(jnp.asarray(seq), K, W)
    gp, _, _ = TS.minimizers(_t(seq), K, W)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


def test_build_index_exact_and_convert():
    ref = _seq(12_000, 5)
    want = S.build_index(ref, K, W)
    got = TS.build_index(ref, K, W, device="cpu")
    np.testing.assert_array_equal(got.hashes.numpy(),
                                  np.asarray(want.hashes).astype(np.int64))
    np.testing.assert_array_equal(got.positions.numpy(),
                                  np.asarray(want.positions))
    conv = index_from_numpy(np.asarray(want.hashes),
                            np.asarray(want.positions), device="cpu")
    assert torch.equal(conv.hashes, got.hashes)
    assert torch.equal(conv.positions, got.positions)


@pytest.fixture(scope="module")
def index_pair():
    ref = _seq(12_000, 6)
    jidx = S.build_index(ref, K, W)
    tidx = index_from_numpy(np.asarray(jidx.hashes),
                            np.asarray(jidx.positions), device="cpu")
    return ref, jidx, tidx


@pytest.mark.parametrize("max_occ", [1, 8])
def test_lookup_anchors_exact(index_pair, max_occ):
    ref, jidx, tidx = index_pair
    read = ref[3000:3600].copy()
    read[::37] = (read[::37] + 1) % 4
    qp, qh, qv = S.minimizers(jnp.asarray(read), K, W)
    want = S.lookup_anchors(jidx, qp, qh, qv, max_occ)
    got = TS.lookup_anchors(tidx, _t(qp).long(),
                            _t(np.asarray(qh).astype(np.int64)), _t(qv),
                            max_occ)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("chunks,pad", [(1, 0), (8, 77)])
def test_seed_exact(index_pair, chunks, pad):
    ref, jidx, tidx = index_pair
    read = ref[5000:5500].copy()
    read[::29] = (read[::29] + 2) % 4
    padded = np.concatenate([read, np.zeros(pad, np.int8)]).astype(np.int32)
    want = _seed_jit(jidx, jnp.asarray(padded), K, W, max_occ=8,
                     num_sort_chunks=chunks, valid_len=jnp.int32(len(read)))
    got = TS.seed(tidx, _t(padded), K, W, max_occ=8, num_sort_chunks=chunks,
                  valid_len=len(read))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("chunks,n", [(1, 1000), (8, 1003)])
def test_radix_sort_exact(chunks, n):
    rng = np.random.default_rng(n + chunks)
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    keys[::5] = keys[1::5][: len(keys[::5])]     # duplicates: stability
    vals = rng.integers(0, 2**31, n).astype(np.int32)
    wk, wv = _sort_jit(jnp.asarray(keys), jnp.asarray(vals),
                       num_chunks=chunks, min_parallel=0)
    gk, gv = TR.radix_sort(_t(keys.astype(np.int64)), _t(vals).long(),
                           num_chunks=chunks, min_parallel=0)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk).astype(np.int64))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gk.numpy(), np.sort(keys).astype(np.int64))


def test_merge_sorted_stable_exact():
    rng = np.random.default_rng(3)
    ak = np.sort(rng.integers(0, 50, 300)).astype(np.uint32)
    bk = np.sort(rng.integers(0, 50, 200)).astype(np.uint32)
    av = np.arange(300, dtype=np.int32)
    bv = np.arange(300, 500, dtype=np.int32)
    wk, wv = R.merge_sorted(jnp.asarray(ak), jnp.asarray(av),
                            jnp.asarray(bk), jnp.asarray(bv))
    gk, gv = TR.merge_sorted(_t(ak.astype(np.int64)), _t(av).long(),
                             _t(bk.astype(np.int64)), _t(bv).long())
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_sort_i32_exact():
    rng = np.random.default_rng(4)
    keys = rng.integers(-2**31, 2**31, 700).astype(np.int32)
    wk, wv = _sort_i32_jit(jnp.asarray(keys), num_chunks=4, min_parallel=0)
    gk, gv = TR.sort_i32(_t(keys), num_chunks=4, min_parallel=0)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
