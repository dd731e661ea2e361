"""The radix_rank kernel's plain version (what the wrapper runs for CPU
tensors) against radix_rank_pallas in interpret mode and against the stable
rank oracle of tests/test_kernels_pallas.py, and ops.radix_sort_chunks
against the reference's. Ranks, histograms and sorted keys/values exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels.radix_rank import radix_rank_pallas
from repro_torch.core import sort as TS
from repro_torch.kernels import ops
from repro_torch.kernels import radix_rank as KR


def _keys(shape, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, shape, dtype=np.uint32)
    keys[..., ::3] = keys[..., :1]          # repeated keys: stability counts
    return keys


def _oracle(chunk, shift):
    """Stable rank per bucket and the histogram, one key at a time."""
    bucket = (chunk >> shift) & 255
    ranks = np.zeros(len(chunk), np.int32)
    seen: dict = {}
    for i, b in enumerate(bucket):
        ranks[i] = seen.get(b, 0)
        seen[b] = seen.get(b, 0) + 1
    return ranks, np.bincount(bucket, minlength=256)


@pytest.mark.parametrize("shift", [0, 8, 16, 24])
def test_plain_rank_vs_pallas(shift):
    keys = _keys((3, 512), shift)
    ranks, hists = radix_rank_pallas(jnp.asarray(keys), shift=shift,
                                     block=256)
    got_r, got_h = KR.radix_rank(torch.as_tensor(keys.astype(np.int64)),
                                 shift)
    assert got_r.dtype == torch.int32 and got_h.dtype == torch.int32
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(ranks))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(hists))


@pytest.mark.parametrize("clen", [1, 255, 1000])
def test_plain_rank_any_chunk_len(clen):
    """The Pallas kernel wants chunk_len a multiple of its block; the port
    takes any length (compared here with block = chunk_len)."""
    keys = _keys((2, clen), clen)
    kt = torch.as_tensor(keys.astype(np.int64))
    for shift in (0, 8, 16, 24):
        ranks, hists = radix_rank_pallas(jnp.asarray(keys), shift=shift,
                                         block=clen)
        got_r, got_h = KR.radix_rank(kt, shift)
        np.testing.assert_array_equal(got_r.numpy(), np.asarray(ranks))
        np.testing.assert_array_equal(got_h.numpy(), np.asarray(hists))
        for c in range(2):
            want_r, want_h = _oracle(keys[c], shift)
            np.testing.assert_array_equal(got_r[c].numpy(), want_r)
            np.testing.assert_array_equal(got_h[c].numpy(), want_h)


@pytest.mark.parametrize("with_vals", [False, True])
def test_radix_sort_chunks_vs_reference(with_vals):
    keys = _keys((4, 512), 11)
    vals = np.random.default_rng(4).integers(-9, 9, (4, 512)).astype(
        np.int32) if with_vals else None
    sk, sv = jops.radix_sort_chunks(
        jnp.asarray(keys), None if vals is None else jnp.asarray(vals),
        block=256)
    gk, gv = ops.radix_sort_chunks(
        torch.as_tensor(keys.astype(np.int64)),
        None if vals is None else torch.as_tensor(vals))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(sk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(sv))


def test_radix_sort_chunks_merged_is_a_stable_sort():
    """Alg. 1 end to end: sort 4 chunks, merge them pairwise; equals a
    stable sort of the whole array, and the port's core.sort.radix_sort."""
    keys = _keys((1000,), 5)
    kt = torch.as_tensor(keys.astype(np.int64))
    ck, cv = ops.radix_sort_chunks(kt.reshape(4, 250))
    cv = cv.to(torch.int64) + 250 * torch.arange(4)[:, None]
    chunks = [(ck[i], cv[i]) for i in range(4)]
    (ak, av), (bk, bv) = (TS.merge_sorted(*chunks[0], *chunks[1]),
                          TS.merge_sorted(*chunks[2], *chunks[3]))
    mk, mv = TS.merge_sorted(ak, av, bk, bv)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(mk.numpy(), keys[order])
    np.testing.assert_array_equal(mv.numpy(), order)
    rk, rv = TS.radix_sort(kt, num_chunks=4, min_parallel=0)
    assert torch.equal(rk, mk) and torch.equal(rv, mv)


def test_cpu_keys_launch_no_kernel_and_other_devices_raise():
    KR.launches = 0
    KR.radix_rank(torch.zeros((2, 5), dtype=torch.int64), 0)
    ops.radix_sort_chunks(torch.zeros((2, 5), dtype=torch.int64))
    assert KR.launches == 0
    with pytest.raises(ValueError, match="meta"):
        KR.radix_rank(torch.zeros((2, 5), dtype=torch.int64,
                                  device="meta"), 0)
