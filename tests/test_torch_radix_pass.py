"""The plain versions of the radix kernels' decomposition (what the wrappers
run for CPU tensors) against the reference on the same numpy keys: the
tile-order rank twin against radix_rank_pallas in interpret mode, the
histogram of every digit against np.bincount, one pass against the
reference's one-pass sort, and the whole sort against the reference's
radix_sort_chunks. Every result is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels.radix_rank import radix_rank_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import radix_rank as KR

# chunk lengths about both tile sizes: 1, 255, T - 1, T, T + 1, 3T + 7
CHUNK_LENS = sorted({n for t in KR.TILES
                     for n in (1, 255, t - 1, t, t + 1, 3 * t + 7)})


def _keys(shape, seed, draw):
    """uint32 keys: "repeated" (every third key equal to the first, so ties
    and stability count) or "one_bucket" (all keys equal: every digit of a
    chunk falls in one bucket)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, shape, dtype=np.uint32)
    if draw == "repeated":
        keys[..., ::3] = keys[..., :1]
    else:
        keys[...] = keys[..., :1]
    return keys


def _t(keys):
    return torch.as_tensor(keys.astype(np.int64))


@pytest.mark.parametrize("draw", ["repeated", "one_bucket"])
@pytest.mark.parametrize("clen", CHUNK_LENS)
def test_tile_order_rank_vs_pallas(clen, draw):
    """The kernel's order (tile counts, the exclusive prefix over a chunk's
    tiles, ranks within a tile) at both tile sizes and at a tile of 16 (many
    tiles a chunk) gives the Pallas kernel's ranks and histograms."""
    keys = _keys((3, clen), clen, draw)
    kt = _t(keys)
    for shift in (0, 8, 16, 24):
        ranks, hists = radix_rank_pallas(jnp.asarray(keys), shift=shift,
                                         block=clen)
        for tile in KR.TILES + (16,):
            got_r, got_h = KR.radix_rank_tiles_plain(kt, shift, tile)
            assert got_r.dtype == torch.int32 and got_h.dtype == torch.int32
            np.testing.assert_array_equal(got_r.numpy(), np.asarray(ranks))
            np.testing.assert_array_equal(got_h.numpy(), np.asarray(hists))


@pytest.mark.parametrize("key_bits", [8, 12, 32])
@pytest.mark.parametrize("draw", ["repeated", "one_bucket"])
def test_plain_hist_vs_bincount(key_bits, draw):
    keys = _keys((4, 1025), key_bits, draw)
    hists, starts = KR.radix_hist(_t(keys), key_bits)
    n_passes = -(-key_bits // 8)
    assert hists.shape == starts.shape == (4, n_passes, 256)
    assert hists.dtype == starts.dtype == torch.int32
    for c in range(4):
        for p in range(n_passes):
            want = np.bincount((keys[c] >> (8 * p)) & 255, minlength=256)
            np.testing.assert_array_equal(hists[c, p].numpy(), want)
            np.testing.assert_array_equal(starts[c, p].numpy(),
                                          np.cumsum(want) - want)


@pytest.mark.parametrize("with_vals", [False, True])
@pytest.mark.parametrize("draw", ["repeated", "one_bucket"])
@pytest.mark.parametrize("clen", [1, 255, 1000])
def test_plain_pass_vs_reference_one_pass(clen, draw, with_vals):
    """One pass at shift 0 is the reference's sort with key_bits=8."""
    keys = _keys((3, clen), clen + 1, draw)
    vals = (np.random.default_rng(2).integers(-9, 9, (3, clen))
            .astype(np.int32) if with_vals else None)
    sk, sv = jops.radix_sort_chunks(
        jnp.asarray(keys), None if vals is None else jnp.asarray(vals),
        key_bits=8, block=clen)
    kt = _t(keys)
    _, starts = KR.radix_hist(kt, 8)
    gk, gv = KR.radix_pass(kt, None if vals is None else torch.as_tensor(
        vals), starts, 0)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(sk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(sv))


@pytest.mark.parametrize("key_bits", [8, 12, 32])
@pytest.mark.parametrize("with_vals", [False, True])
@pytest.mark.parametrize("draw", ["repeated", "one_bucket"])
def test_plain_sort_vs_reference(key_bits, with_vals, draw):
    """The whole sort in the kernels' order (the histograms, then one pass
    per digit) against the reference's."""
    keys = _keys((4, 768), key_bits, draw)
    vals = (np.random.default_rng(3).integers(-9, 9, (4, 768))
            .astype(np.int32) if with_vals else None)
    sk, sv = jops.radix_sort_chunks(
        jnp.asarray(keys), None if vals is None else jnp.asarray(vals),
        key_bits=key_bits, block=256)
    gk, gv = ops.radix_sort_chunks(
        _t(keys), None if vals is None else torch.as_tensor(vals),
        key_bits=key_bits)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(sk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(sv))


def test_pass_returns_new_tensors_and_leaves_its_inputs():
    keys = _t(_keys((2, 300), 9, "repeated"))
    vals = torch.arange(600, dtype=torch.int64).reshape(2, 300)
    k0, v0 = keys.clone(), vals.clone()
    _, starts = KR.radix_hist(keys)
    got = KR.radix_pass(keys, vals, starts, 1)
    assert got[0].data_ptr() != keys.data_ptr()
    assert got[1].data_ptr() != vals.data_ptr()
    assert torch.equal(keys, k0) and torch.equal(vals, v0)
    order = torch.argsort((k0 >> 8) & 255, dim=1, stable=True)
    assert torch.equal(got[0], torch.gather(k0, 1, order))
    assert torch.equal(got[1], torch.gather(v0, 1, order))


def test_cpu_calls_launch_nothing_and_key_bits_are_checked():
    before = (KR.launches, KR.hist_launches, KR.pass_launches)
    keys = _t(_keys((2, 5), 1, "repeated"))
    KR.radix_rank(keys, 8)
    _, starts = KR.radix_hist(keys)
    KR.radix_pass(keys, None, starts, 3)
    ops.radix_sort_chunks(keys)
    assert (KR.launches, KR.hist_launches, KR.pass_launches) == before
    for bits in (0, 33):
        with pytest.raises(ValueError, match="key_bits"):
            KR.radix_hist(keys, bits)
