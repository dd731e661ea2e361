"""The backward of the port's ``ssm_scan`` (the WKV scan) on the CPU,
where the ``SSMScan`` autograd Function runs the plain forward and
``ssm_scan_bwd_plain``, the plain version of the backward kernel
(csrc/ssm_scan_bwd.cu).

The reference has no backward kernel: it trains through the jnp
``wkv_chunked``, so the gradients dr, dw, dk, dv, du and ds0 (from dy and
the final state's gradient) are held against ``jax.vjp`` of
``repro.core.linear_attn.wkv_chunked`` on the same numpy inputs, in fp32.
w is drawn in [0.45, 0.999], above the clamp at e^-1 that ``wkv_chunked``
applies (below it the clamp's gradient is 0; the port's model clamps
before the scan, under autograd). Tolerance: 1e-4 of the largest gradient
of each kind (the chunked form goes through exp and log of the decay, the
step loop does not: errors seen near 1e-6). The Function is also held to
autograd through the plain step loop (1e-5). The CUDA arm is in
test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core.linear_attn import wkv_chunked
from repro_torch.kernels import ssm_scan as KS

NAMES = ("dr", "dw", "dk", "dv", "du", "ds0")


def _inputs(b, t, dk, dv, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"r": f(b, t, dk), "w": rng.uniform(0.45, 0.999, (b, t, dk))
            .astype(np.float32), "k": f(b, t, dk), "v": f(b, t, dv),
            "u": 0.5 * f(dk), "s0": f(b, dk, dv), "dy": f(b, t, dv),
            "dsf": f(b, dk, dv)}


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _torch(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("with_u,with_s0", [(True, True), (False, False),
                                            (True, False)])
@pytest.mark.parametrize("b,t,dk,dv", [(2, 64, 8, 8), (3, 100, 16, 24),
                                       (1, 37, 4, 12)])
def test_plain_backward_matches_jax_vjp(b, t, dk, dv, with_u, with_s0):
    x = _inputs(b, t, dk, dv, seed=t + dk)
    u = x["u"] if with_u else None
    s0 = x["s0"] if with_s0 else None

    def f(r, w, k, v, uu, ss):
        return wkv_chunked(r, w, k, v, uu, ss, chunk=16)
    primals = [jnp.asarray(x[n]) for n in ("r", "w", "k", "v")]
    primals += [None if u is None else jnp.asarray(u),
                None if s0 is None else jnp.asarray(s0)]
    _, vjp = jax.vjp(f, *primals)
    want = vjp((jnp.asarray(x["dy"]), jnp.asarray(x["dsf"])))
    got = KS.ssm_scan_bwd_plain(*(_torch(x[n]) for n in "rwkv"),
                                _torch(u), _torch(s0), _torch(x["dy"]),
                                _torch(x["dsf"]))
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        _close(g.numpy(), np.asarray(w), 1e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_function_matches_autograd_of_the_plain_scan(with_state):
    x = _inputs(2, 50, 8, 12, seed=4)
    args = [torch.from_numpy(x[n]).requires_grad_() for n in "rwkv"]
    args.append(torch.from_numpy(x["u"]).requires_grad_())
    args.append(torch.from_numpy(x["s0"]).requires_grad_()
                if with_state else None)
    before = (KS.launches, KS.bwd_launches)
    y, s_fin = KS.ssm_scan(*args)
    assert "SSMScan" in type(y.grad_fn).__name__
    outs, grads = ((y, s_fin), (torch.from_numpy(x["dy"]),
                                torch.from_numpy(x["dsf"])))
    leaves = [a for a in args if a is not None]
    got = torch.autograd.grad(outs, leaves, grads)
    y2, s2 = KS.ssm_scan_plain(*args)
    want = torch.autograd.grad((y2, s2), leaves, grads)
    assert (KS.launches, KS.bwd_launches) == before   # CPU: no kernel
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy(), 1e-5)


def test_function_with_only_y_used_and_bf16_inputs():
    """The model's use: y only (the final state's gradient is None), r, k
    and v in bf16 (gradients come back in bf16), w in fp32, no u."""
    x = _inputs(2, 40, 8, 8, seed=7)
    r, k, v = (torch.from_numpy(x[n]).to(torch.bfloat16).requires_grad_()
               for n in "rkv")
    w = torch.from_numpy(x["w"]).requires_grad_()
    y, _ = KS.ssm_scan(r, w, k, v)
    got = torch.autograd.grad(y, (r, w, k, v), torch.from_numpy(x["dy"]))
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.bfloat16, torch.bfloat16]
    y2, _ = KS.ssm_scan_plain(r, w, k, v)
    want = torch.autograd.grad(y2, (r, w, k, v), torch.from_numpy(x["dy"]))
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_plain_backward_at_length_zero_and_one():
    x = _inputs(2, 1, 4, 4, seed=8)
    got = KS.ssm_scan_bwd_plain(*(_torch(x[n]) for n in "rwkv"),
                                _torch(x["u"]), _torch(x["s0"]),
                                _torch(x["dy"]), _torch(x["dsf"]))
    r, w, k, v, u, s0, dy, dsf = (_torch(x[n]).double() for n in
                                  ("r", "w", "k", "v", "u", "s0", "dy",
                                   "dsf"))
    # one step: y = r (s0 + diag(u) k^T v), S = diag(w) s0 + k^T v
    ds0 = r[:, 0, :, None] * dy[:, 0, None, :] + w[:, 0, :, None] * dsf
    np.testing.assert_allclose(got[5].numpy(), ds0.numpy(), rtol=1e-5,
                               atol=1e-5)
    dw = (dsf * s0).sum(-1)
    np.testing.assert_allclose(got[1][:, 0].numpy(), dw.numpy(), rtol=1e-5,
                               atol=1e-5)
