"""The backward of the port's ``flash_attention`` on the CPU, where the
``FlashAttention`` autograd Function runs the plain forward (which also
gives the row log-sum-exp) and ``flash_attention_bwd_plain``, the plain
version of the backward kernel (csrc/flash_attention_bwd.cu).

The reference has no backward kernel: it trains through the jnp
``blockwise_attention``, so the gradients are held against ``jax.vjp`` of
that function on the same numpy inputs, in fp32: GQA, MQA, a sliding
window, ragged lengths and several ``kv_block`` sizes. Tolerance: 1e-5 of
the largest gradient (both sum in fp32 in other orders; the errors seen
are near 1e-7). The Function is also held to autograd through the port's
``flash_attention_plain`` (1e-5), including rows that see nothing, which
get zero gradient. The CUDA arm is in test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.models.attention import blockwise_attention
from repro_torch.kernels import flash_attention as KF
from repro_torch.kernels import ops

TOL = 1e-5


def _inputs(b, h, kvh, sq, skv, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, h, sq, hd), (b, kvh, skv, hd), (b, kvh, skv, hd),
                      (b, h, sq, hd))]


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= TOL * scale


def _jax_vjp(q, k, v, do, window, kv_block):
    """vjp of the reference's blockwise_attention, in the kernel layout."""
    b, h, s, _ = q.shape
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))

    def f(q_, k_, v_):
        return blockwise_attention(q_, k_, v_, pos, pos, window=window,
                                   kv_block=kv_block)
    t = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    _, vjp = jax.vjp(f, t(q), t(k), t(v))
    return [np.asarray(g).transpose(0, 2, 1, 3) for g in vjp(t(do))]


@pytest.mark.parametrize("b,h,kvh,s,hd,window,kv_block", [
    (2, 4, 4, 64, 16, 0, 16),       # MHA
    (1, 8, 2, 96, 32, 0, 32),       # GQA 4:1
    (2, 4, 1, 70, 16, 0, 32),       # MQA, ragged against the kv block
    (1, 4, 2, 80, 32, 24, 16),      # sliding window
    (1, 6, 3, 33, 64, 7, 512),      # ragged, window, one kv block
])
def test_plain_backward_matches_jax_vjp(b, h, kvh, s, hd, window, kv_block):
    q, k, v, do = _inputs(b, h, kvh, s, s, hd, seed=s + hd)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = KF.flash_attention_fwd_plain(tq, tk, tv, window)
    got = KF.flash_attention_bwd_plain(tq, tk, tv, out, lse,
                                       torch.from_numpy(do), window)
    want = _jax_vjp(q, k, v, do, window, kv_block)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_function_on_the_cpu_matches_jax_vjp_through_ops():
    """ops.flash_attention (the model's (B, S, H, hd) layout, the kernel
    reading transposed views) passes a gradient to q, k and v."""
    q, k, v, do = _inputs(2, 4, 2, 48, 48, 32, seed=3)
    t = lambda x: torch.from_numpy(x).transpose(1, 2).contiguous()  # noqa
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, window=10)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (tq, tk, tv), t(do))
    want = _jax_vjp(q, k, v, do, 10, 16)
    for g, w in zip(got, want):
        _close(g.transpose(1, 2).numpy(), w)


@pytest.mark.parametrize("b,h,kvh,sq,skv,hd,window", [
    (2, 4, 2, 40, 40, 16, 0),
    (1, 4, 1, 30, 50, 32, 0),       # Skv > Sq
    (1, 4, 2, 50, 20, 16, 8),       # Sq > Skv, window: rows that see nothing
])
def test_function_matches_autograd_of_the_plain_version(b, h, kvh, sq, skv,
                                                        hd, window):
    q, k, v, do = _inputs(b, h, kvh, sq, skv, hd, seed=sq + skv)
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = (KF.launches, KF.bwd_launches)
    out = KF.flash_attention(*args, window)
    assert isinstance(out.grad_fn.__class__, type) and \
        "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, args, torch.from_numpy(do))
    want = torch.autograd.grad(KF.flash_attention_plain(*args, window),
                               args, torch.from_numpy(do))
    assert (KF.launches, KF.bwd_launches) == before   # CPU: no kernel
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g.numpy(), w.numpy())
    if sq > skv and window:
        blind = np.arange(sq) >= skv - 1 + window   # rows that see nothing
        assert not torch.any(got[0][:, :, blind])
        assert torch.equal(out.detach()[:, :, blind],
                           torch.zeros_like(out.detach()[:, :, blind]))


def test_lse_is_the_row_log_sum_exp():
    q, k, v, _ = _inputs(1, 2, 1, 20, 20, 16, seed=5)
    tq, tk, tv = (torch.from_numpy(x).double() for x in (q, k, v))
    _, lse = KF.flash_attention_fwd_plain(tq.float(), tk.float(), tv.float(),
                                          4)
    s = torch.einsum("bhqd,bhkd->bhqk", tq, tk.repeat_interleave(2, 1))
    s = s * 16 ** -0.5
    qp, kp = torch.arange(20)[:, None], torch.arange(20)[None]
    s = s.masked_fill(~((kp <= qp) & (qp - kp < 4)), -float("inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_no_gradient_path_is_unchanged():
    """Serving (no input requires a gradient, or no-grad mode) takes the
    plain forward without the Function."""
    q, k, v, _ = _inputs(1, 2, 1, 16, 16, 16, seed=6)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    assert KF.flash_attention(tq, tk, tv).grad_fn is None
    with torch.no_grad():
        out = KF.flash_attention(tq.requires_grad_(), tk, tv)
    assert out.grad_fn is None
    assert torch.equal(out, KF.flash_attention_plain(tq, tk, tv))
