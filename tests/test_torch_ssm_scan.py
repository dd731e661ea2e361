"""The port's WKV scan (``repro_torch.kernels.ssm_scan``, plain version on
the CPU) and ``core.linear_attn`` against the JAX reference.

Inputs are numpy arrays from a seed, handed to both packages. Tolerances
are the reference's own: 1e-4 for the scan in fp32 and 5e-2 with bf16
inputs (``tests/test_kernels_pallas.py``), 1e-3 for the chunked form
(``tests/test_linear_attn.py``). The sequential scan sums ``y`` in another
order than the reference's ``jnp.sum``, and the chunked form reassociates
the whole recurrence, hence the tolerances rather than equality.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import linear_attn as RLA
from repro.kernels import ops as rops
from repro.kernels import ref
from repro.kernels.ssm_scan import ssm_scan_pallas
from repro_torch.core import linear_attn as TLA
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssm_scan as TK


def _inputs(b, t, dk, dv, seed, w_lo=None):
    """r, w, k, v, u as fp32 numpy. w = sigmoid(N(0,1) + 2) as in the
    reference's kernel sweep, or uniform(w_lo, 1) when w_lo is given."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(b, t, dk)).astype(np.float32)
    if w_lo is None:
        w = 1 / (1 + np.exp(-(rng.normal(size=(b, t, dk)) + 2.0)))
    else:
        w = rng.uniform(w_lo, 1.0, (b, t, dk))
    k = rng.normal(size=(b, t, dk)).astype(np.float32)
    v = rng.normal(size=(b, t, dv)).astype(np.float32)
    u = (0.1 * rng.normal(size=(dk,))).astype(np.float32)
    return r, w.astype(np.float32), k, v, u


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("b,t,dk,dv,chunk", [
    (1, 32, 16, 16, 8),
    (2, 64, 32, 16, 16),
    (3, 96, 64, 64, 32),
    (2, 128, 8, 24, 64),
])
def test_plain_scan_matches_reference_and_pallas(b, t, dk, dv, chunk):
    r, w, k, v, u = _inputs(b, t, dk, dv, seed=t)
    want_ref = np.asarray(ref.ssm_scan_ref(r, w, k, v, u))
    want_pal = np.asarray(ssm_scan_pallas(r, w, k, v, u, chunk=chunk))
    before = TK.launches
    y, s_fin = TK.ssm_scan(*_t(r, w, k, v, u))
    assert TK.launches == before
    assert y.dtype == torch.float32 and tuple(s_fin.shape) == (b, dk, dv)
    np.testing.assert_allclose(y.numpy(), want_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y.numpy(), want_pal, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_scan_inputs_of_either_dtype(dtype):
    r, w, k, v, _ = _inputs(2, 64, 32, 32, seed=0)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    u = np.zeros((32,), np.float32)
    want = ref.ssm_scan_ref(*(jnp.asarray(x, jd) for x in (r, w, k, v, u)))
    got = tops.ssm_scan(*(torch.as_tensor(x).to(td) for x in (r, w, k, v, u)),
                        chunk=16)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_ops_scan_pads_t():
    """t=50 is not a multiple of 16: the pad (w=1, k=0) changes nothing."""
    r, w, k, v, _ = _inputs(1, 50, 16, 16, seed=1)
    got = tops.ssm_scan(*_t(r, w, k, v), chunk=16)
    want = rops.ssm_scan(*(jnp.asarray(x) for x in (r, w, k, v)), chunk=16)
    assert tuple(got.shape) == (1, 50, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref.ssm_scan_ref(r, w, k, v,
                                                 np.zeros(16, np.float32))),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,t,dk,dv", [(2, 40, 8, 12), (3, 96, 16, 16),
                                       (1, 1, 4, 4)])
def test_scan_with_state_matches_wkv_ref(b, t, dk, dv):
    """The s0 / s_final form, with the caller's clamp (as the model
    applies it) on decays that reach below e^-1."""
    r, w, k, v, u = _inputs(b, t, dk, dv, seed=b * t, w_lo=0.05)
    assert (w < np.exp(-1)).any()
    s0 = np.random.default_rng(7).normal(size=(b, dk, dv)).astype(np.float32)
    want_y, want_s = RLA.wkv_ref(*(jnp.asarray(x) for x in (r, w, k, v, u,
                                                            s0)))
    rt, wt, kt, vt, ut, st = _t(r, w, k, v, u, s0)
    y, s_fin = TK.ssm_scan(rt, TLA.clamp_decay(wt), kt, vt, ut, st)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(want_s), rtol=1e-4,
                               atol=1e-4)
    y2, s2 = TLA.wkv_ref(rt, wt, kt, vt, ut, st)
    np.testing.assert_allclose(y2.numpy(), np.asarray(want_y), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), np.asarray(want_s), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("t,chunk", [(16, 4), (33, 8), (64, 64), (100, 32)])
@pytest.mark.parametrize("with_u", [False, True])
def test_wkv_chunked_matches_reference(t, chunk, with_u):
    r, w, k, v, u = _inputs(2, t, 8, 12, seed=t, w_lo=0.2)
    s0 = np.random.default_rng(t).normal(size=(2, 8, 12)).astype(np.float32)
    uu = u if with_u else None
    want_y, want_s = RLA.wkv_chunked(
        *(jnp.asarray(x) for x in (r, w, k, v)),
        None if uu is None else jnp.asarray(uu), jnp.asarray(s0),
        chunk=chunk)
    y, s_fin = TLA.wkv_chunked(*_t(r, w, k, v),
                               None if uu is None else torch.as_tensor(uu),
                               torch.as_tensor(s0), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(want_s), rtol=1e-3,
                               atol=1e-3)
    # and the chunked form agrees with the kernel's plain version
    yk, sk = TK.ssm_scan(*_t(r), TLA.clamp_decay(torch.as_tensor(w)),
                         *_t(k, v), None if uu is None
                         else torch.as_tensor(uu), torch.as_tensor(s0))
    np.testing.assert_allclose(yk.numpy(), y.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(sk.numpy(), s_fin.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_wkv_chunked_out_dtype_and_fused_variant():
    r, w, k, v, _ = _inputs(1, 20, 4, 4, seed=3, w_lo=0.5)
    y, s = TLA.wkv_chunked(*_t(r, w, k, v), None, chunk=8,
                           out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="tape"):
        TLA.wkv_chunked(*_t(r, w, k, v), None, variant="fused")


def test_wkv_decode_step_matches_reference():
    r, w, k, v, u = _inputs(3, 6, 8, 8, seed=5, w_lo=0.05)
    s = np.random.default_rng(5).normal(size=(3, 8, 8)).astype(np.float32)
    js, ts = jnp.asarray(s), torch.as_tensor(s)
    for i in range(r.shape[1]):
        step = [x[:, i] for x in (r, w, k, v)]
        jy, js = RLA.wkv_decode_step(*(jnp.asarray(x) for x in step),
                                     jnp.asarray(u), js)
        ty, ts = TLA.wkv_decode_step(*_t(*step), torch.as_tensor(u), ts)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-5)


def test_decode_steps_equal_the_scan_with_state():
    """Prefill state handoff: T decode steps == one scan from s0."""
    r, w, k, v, u = _inputs(2, 12, 4, 4, seed=9, w_lo=0.05)
    rt, wt, kt, vt, ut = _t(r, w, k, v, u)
    y_scan, s_scan = TK.ssm_scan(rt, TLA.clamp_decay(wt), kt, vt, ut)
    s = torch.zeros(2, 4, 4)
    ys = []
    for i in range(12):
        y, s = TLA.wkv_decode_step(rt[:, i], wt[:, i], kt[:, i], vt[:, i],
                                   ut, s)
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, 1), y_scan, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(s, s_scan, rtol=1e-4, atol=1e-4)


def test_wrapper_launches_nothing_off_the_card():
    """CPU tensors take the plain version and count no launch; a tensor on
    any other device without a kernel raises (no fallback)."""
    r, w, k, v, u = _t(*_inputs(2, 8, 4, 4, seed=0))
    before = TK.launches
    TK.ssm_scan(r, w, k, v, u)
    tops.ssm_scan(r, w, k, v, u, chunk=16)
    assert TK.launches == before
    meta = [x.to("meta") for x in (r, w, k, v)]
    with pytest.raises(ValueError, match="no kernel"):
        TK.ssm_scan(*meta)
    assert TK.launches == before


# --------------------------------------------------------------------------
# the CUDA kernel's readout order (csrc/ssm_scan.cu), modelled in torch
# --------------------------------------------------------------------------

def _tile_readout_scan(r, w, k, v, u, s0, dk_max=64):
    """ssm_scan.cu's order: dk padded with zero rows to dk_max; row group a
    (one lane per column quad) holds the rows 4a .. 4a+3; the state update
    is the plain version's, element by element; the readout of column j is
    summed per row group over its 4 rows in order, then over the 16 row
    groups as the kernel's half-warp butterfly adds them: xor 8, 4, 2, 1,
    each lane adding what it kept and what it received, and y_j is the sum
    at row group 4 (j mod 4), the lane that writes it. fp32 throughout."""
    b, t, dk = r.shape
    dv = v.shape[-1]
    pad = lambda x: torch.nn.functional.pad(x, (0, dk_max - dk))  # noqa
    r, w, k = pad(r), pad(w), pad(k)
    uu = pad(torch.zeros(dk) if u is None else u)
    s = torch.zeros(b, dk_max, dv)
    if s0 is not None:
        s[:, :dk] = s0
    groups = dk_max // 4
    lane = torch.arange(groups)
    writer = 4 * (torch.arange(dv) % 4)
    ys = []
    for i in range(t):
        kv = k[:, i, :, None] * v[:, i, None, :]
        term = r[:, i, :, None] * (uu[:, None] * kv + s)    # S_{t-1}
        term = term.view(b, groups, 4, dv)                  # (a, e)
        part = ((term[:, :, 0] + term[:, :, 1]) + term[:, :, 2]) \
            + term[:, :, 3]
        for dist in (8, 4, 2, 1):
            part = part + part[:, lane ^ dist]
        ys.append(part.gather(1, writer.expand(b, 1, dv))[:, 0])
        s = w[:, i, :, None] * s + kv
    return torch.stack(ys, 1), s[:, :dk]


@pytest.mark.parametrize("b,t,dk,dv,chunk", [(2, 48, 64, 64, 16),
                                             (3, 33, 8, 24, None),
                                             (1, 17, 1, 1, None),
                                             (2, 64, 16, 128, 32)])
def test_tile_readout_order_matches_plain_and_pallas(b, t, dk, dv, chunk):
    """The kernel's order against the plain scan at 1e-5 (y and the final
    state, from a random state) and against ssm_scan_pallas in interpret
    mode at the reference kernel tests' 1e-4 (zero state, T a multiple of
    the chunk)."""
    r, w, k, v, u = _t(*_inputs(b, t, dk, dv, seed=b * t + dk))
    s0 = torch.as_tensor(np.random.default_rng(dv).normal(
        size=(b, dk, dv)).astype(np.float32))
    y, s_fin = _tile_readout_scan(r, w, k, v, u, s0)
    want_y, want_s = TK.ssm_scan_plain(r, w, k, v, u, s0)
    torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s_fin, want_s, rtol=1e-5, atol=1e-5)
    if chunk is not None:
        y0, _ = _tile_readout_scan(r, w, k, v, u, None)
        want_pal = ssm_scan_pallas(*(x.numpy() for x in (r, w, k, v, u)),
                                   chunk=chunk)
        np.testing.assert_allclose(y0.numpy(), np.asarray(want_pal),
                                   rtol=1e-4, atol=1e-4)
