"""The plain version of the port's ``flash_attention`` kernel (the one the
wrapper runs for CPU tensors) against the JAX package's
``flash_attention_pallas`` in interpret mode, at the reference's own sweep
shapes and tolerances (tests/test_kernels_pallas.py: 2e-3 in fp32, 3e-2 in
bf16), and at ragged lengths, which the TPU kernel refuses, against the
naive formula of those tests. The CUDA arm is in test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as KF
from repro_torch.kernels import ops


def _inputs(b, h, kvh, sq, hd, seed, skv=None):
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    return (rng.normal(size=(b, h, sq, hd)).astype(np.float32),
            rng.normal(size=(b, kvh, skv, hd)).astype(np.float32),
            rng.normal(size=(b, kvh, skv, hd)).astype(np.float32))


def _naive(q, k, v, window=0):
    """tests/test_kernels_pallas.py's _naive_attn, in numpy (float64)."""
    b, h, sq, hd = q.shape
    grp = h // k.shape[1]
    kf = np.repeat(k.astype(np.float64), grp, axis=1)
    vf = np.repeat(v.astype(np.float64), grp, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kf) * hd ** -0.5
    qp = np.arange(sq)[:, None]
    kp = np.arange(k.shape[2])[None, :]
    ok = kp <= qp
    if window:
        ok &= (qp - kp) < window
    s = np.where(ok, s, -1e30)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, vf)


def _port(q, k, v, window=0, dtype=torch.float32):
    return KF.flash_attention(*(torch.as_tensor(x).to(dtype)
                                for x in (q, k, v)), window)


@pytest.mark.parametrize("b,h,kvh,sq,hd,win,bq,bk", [
    (2, 4, 4, 128, 64, 0, 64, 64),       # MHA
    (1, 8, 2, 256, 32, 0, 128, 128),     # GQA 4:1
    (1, 4, 1, 256, 64, 0, 64, 128),      # MQA
    (1, 4, 2, 256, 64, 96, 64, 64),      # sliding window (gemma3 local)
])
def test_plain_version_matches_the_tpu_kernel_sweep(b, h, kvh, sq, hd, win,
                                                    bq, bk):
    q, k, v = _inputs(b, h, kvh, sq, hd, sq + win)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window=win, bq=bq, bk=bk)
    before = KF.launches
    got = _port(q, k, v, win)
    assert KF.launches == before            # CPU: the plain version only
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_the_tpu_kernel_dtypes(dtype):
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    q, k, v = _inputs(1, 2, 2, 128, 64, 9)
    jq, jk, jv = (jnp.asarray(x).astype(jd) for x in (q, k, v))
    want = flash_attention_pallas(jq, jk, jv)
    # both packages see the same bf16-rounded inputs
    tq, tk, tv = (torch.as_tensor(np.array(x, np.float32)).to(td)
                  for x in (jq, jk, jv))
    got = KF.flash_attention(tq, tk, tv)
    assert got.dtype == td and want.dtype == jd
    tol = 2e-3 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("b,h,kvh,sq,skv,hd,win", [
    (2, 4, 2, 100, 100, 32, 0),          # Sq no multiple of 64
    (1, 8, 1, 150, 150, 16, 40),         # MQA, ragged, window
    (1, 4, 4, 37, 70, 64, 0),            # Sq < Skv: positions from 0 in both
])
def test_plain_version_takes_ragged_lengths(b, h, kvh, sq, skv, hd, win):
    q, k, v = _inputs(b, h, kvh, sq, hd, sq + skv, skv=skv)
    got = _port(q, k, v, win)
    np.testing.assert_allclose(got.numpy(), _naive(q, k, v, win), rtol=2e-3,
                               atol=2e-3)


def test_rows_that_see_nothing_give_zero():
    """With a window, a q row past Skv + window - 1 sees no kv position;
    the kernel then gives 0 (p forced to 0, l clamped), and so must the
    plain version."""
    q, k, v = _inputs(1, 2, 1, 12, 16, 3, skv=4)
    got = _port(q, k, v, window=3).numpy()
    assert np.all(got[:, :, 6:] == 0.0)
    np.testing.assert_allclose(got[:, :, :6], _naive(q, k, v, 3)[:, :, :6],
                               rtol=1e-5, atol=1e-5)


def test_ops_wrapper_takes_the_model_layout():
    q, k, v = _inputs(2, 4, 2, 50, 32, 1)
    want = _port(q, k, v, 16).numpy()
    tq, tk, tv = (torch.as_tensor(x).transpose(1, 2).contiguous()
                  for x in (q, k, v))             # (B, S, heads, hd)
    got = ops.flash_attention(tq, tk, tv, window=16)
    assert tuple(got.shape) == (2, 50, 4, 32)
    np.testing.assert_array_equal(got.transpose(1, 2).numpy(), want)


def test_wrapper_launches_nothing_off_the_card_and_never_falls_back():
    q, k, v = (torch.as_tensor(x) for x in _inputs(1, 2, 1, 64, 32, 5))
    before = KF.launches
    KF.flash_attention(q, k, v)
    assert KF.launches == before
    meta = [x.to("meta") for x in (q, k, v)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        KF.flash_attention(*meta)
    assert KF.launches == before
