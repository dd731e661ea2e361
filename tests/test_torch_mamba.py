"""The port's Mamba (S6) scan and block (``core.linear_attn.mamba_*``,
``models.ssm`` Mamba part) against the JAX reference, on the CPU in fp32.

Inputs are made from a seed with numpy and handed to both packages; the
JAX side runs jitted, as its own tests run it. The chunked scans of the two
packages sum in other orders (cumsums, the boundary scan, the readout
contraction), so they agree to rtol 1e-4 / atol 1e-5 rather than bit for
bit; against the sequential oracle the reference's own test allows 1e-3.
The reference has no Pallas kernel for the Mamba scan: there is no kernel
here either, and the port runs this plain code on the card too.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import linear_attn as RLA
from repro.models import ssm as RS
from repro_torch.core import linear_attn as TLA
from repro_torch.models import ssm as TS

TOL = dict(rtol=1e-4, atol=1e-5)
ORACLE_TOL = dict(rtol=1e-3, atol=1e-3)
B, D, N = 2, 6, 4

_r_chunked = jax.jit(RLA.mamba_chunked, static_argnames=("chunk",))
_r_ref = jax.jit(RLA.mamba_ref)
_r_step = jax.jit(RLA.mamba_decode_step)


def _inputs(t, seed, dt_range=(0.01, 0.2), with_h0=False):
    """(x, dt, a, b_in, c_in, d_skip, h0) as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    x = f(B, t, D)
    dt = rng.uniform(*dt_range, (B, t, D)).astype(np.float32)
    a = -rng.uniform(0.5, 1.5, (D, N)).astype(np.float32)
    b_in, c_in, d_skip = f(B, t, N), f(B, t, N), f(D)
    h0 = f(B, D, N) if with_h0 else None
    return x, dt, a, b_in, c_in, d_skip, h0


def _both(args):
    j = [None if z is None else jnp.asarray(z) for z in args]
    t = [None if z is None else torch.as_tensor(z) for z in args]
    return j, t


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0_zero",
                                                        "h0_random"])
@pytest.mark.parametrize("chunk", [8, 64])
@pytest.mark.parametrize("t", [32, 37, 130])
def test_mamba_chunked_matches_the_reference(t, chunk, with_h0):
    j, tt = _both(_inputs(t, seed=t + chunk, with_h0=with_h0))
    want_y, want_h = _r_chunked(*j, chunk=chunk)
    got_y, got_h = TLA.mamba_chunked(*tt, chunk=chunk)
    assert got_y.shape == (B, t, D) and got_h.shape == (B, D, N)
    assert got_y.dtype == got_h.dtype == torch.float32
    _close(got_y, want_y, **TOL)
    _close(got_h, want_h, **TOL)
    # and the sequential oracle of either package, at the reference's 1e-3
    ref_y, ref_h = _r_ref(*j)
    port_y, port_h = TLA.mamba_ref(*tt)
    _close(got_y, ref_y, **ORACLE_TOL)
    _close(got_h, ref_h, **ORACLE_TOL)
    _close(port_y, ref_y, **TOL)
    _close(port_h, ref_h, **TOL)


def test_chunk_above_64_is_refused():
    _, tt = _both(_inputs(8, seed=0))
    with pytest.raises(AssertionError, match="exponent bound"):
        TLA.mamba_chunked(*tt, chunk=128)


def test_decode_steps_carry_the_chunked_state():
    """mamba_decode_step stepped through a sequence: every output and the
    final state agree with mamba_chunked over the whole sequence, and each
    step with the reference's step."""
    t = 37
    args = _inputs(t, seed=5, with_h0=True)
    j, tt = _both(args)
    want_y, want_h = TLA.mamba_chunked(*tt, chunk=8)
    x, dt, a, b_in, c_in, d_skip, h = tt
    jh = j[-1]
    ys = []
    for i in range(t):
        y, h = TLA.mamba_decode_step(x[:, i], dt[:, i], a, b_in[:, i],
                                     c_in[:, i], d_skip, h)
        jy, jh = _r_step(j[0][:, i], j[1][:, i], j[2], j[3][:, i],
                         j[4][:, i], j[5], jh)
        _close(y, jy, **TOL)
        _close(h, jh, **TOL)
        ys.append(y)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), want_y.numpy(),
                               **TOL)
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), **TOL)


def test_the_clamp_bites_where_dt_times_a_is_below_minus_one():
    """dt up to 3 with A down to -1.5: dt*A reaches -4.5. Both packages
    clamp the log decay at -1 (chunked, oracle and step), so they agree,
    and an unclamped recurrence differs from them."""
    t = 40
    args = _inputs(t, seed=9, dt_range=(0.5, 3.0), with_h0=True)
    x, dt, a = args[:3]
    assert (dt[..., None] * a < -1.0).mean() > 0.5
    j, tt = _both(args)
    for chunk in (8, 64):
        want_y, want_h = _r_chunked(*j, chunk=chunk)
        got_y, got_h = TLA.mamba_chunked(*tt, chunk=chunk)
        assert np.isfinite(got_y.numpy()).all()
        _close(got_y, want_y, **TOL)
        _close(got_h, want_h, **TOL)
    ref_y, _ = TLA.mamba_ref(*tt)
    _close(ref_y, _r_ref(*j)[0], **TOL)
    # the same recurrence without the clamp
    x, dt, a, b_in, c_in, d_skip, h = (np.asarray(z, np.float64)
                                       for z in args)
    y_free = np.zeros((B, t, D))
    for i in range(t):
        h = (np.exp(dt[:, i, :, None] * a) * h
             + (dt[:, i] * x[:, i])[:, :, None] * b_in[:, i, None, :])
        y_free[:, i] = np.einsum("bds,bs->bd", h, c_in[:, i]) \
            + d_skip * x[:, i]
    assert np.abs(y_free - ref_y.numpy()).max() > 1e-2


# --------------------------------------------------------------------------
# the block
# --------------------------------------------------------------------------

CFG = dict(d_model=16, d_state=4, expand=2, conv_kernel=4, scan_chunk=8)


def _block_weights(seed=0):
    rcfg, tcfg = RS.MambaConfig(**CFG), TS.MambaConfig(**CFG)
    tree = jax.tree_util.tree_map(
        np.array, RS.init_mamba(jax.random.PRNGKey(seed), rcfg))
    # conv bias and skip are constant at init: make them bite
    rng = np.random.default_rng(seed)
    tree["conv_b"] = rng.normal(size=tree["conv_b"].shape).astype(np.float32)
    tree["d_skip"] = rng.normal(size=tree["d_skip"].shape).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = {k: torch.as_tensor(v) for k, v in tree.items()}
    return rcfg, tcfg, jp, tp


def _state(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"conv": rng.normal(size=(B, cfg.conv_kernel - 1, cfg.d_inner)
                               ).astype(np.float32),
            "h": rng.normal(size=(B, cfg.d_inner, cfg.d_state)
                            ).astype(np.float32)}


def test_init_mamba_matches_the_reference_layout():
    rcfg, tcfg, jp, _ = _block_weights()
    tp = TS.init_mamba(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert tcfg.d_inner == rcfg.d_inner and tcfg.dt_rank == rcfg.dt_rank
    assert sorted(tp) == sorted(jp)
    ref = RS.init_mamba(jax.random.PRNGKey(0), rcfg)
    for k, v in tp.items():
        assert tuple(v.shape) == ref[k].shape and v.dtype == torch.float32, k
    for k in ("conv_b", "a_log", "d_skip"):     # deterministic leaves
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(ref[k]))
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    meta = TS.init_mamba(None, tcfg, "meta")
    assert all(v.device.type == "meta" for v in meta.values())
    st = TS.init_mamba_state(3, tcfg, "cpu")
    want = RS.init_mamba_state(3, rcfg)
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["fresh", "carried"])
def test_mamba_block_matches_the_reference(with_state):
    rcfg, tcfg, jp, tp = _block_weights()
    x = np.random.default_rng(3).normal(size=(B, 21, CFG["d_model"])
                                        ).astype(np.float32)
    st = _state(tcfg, 4) if with_state else None
    jst = None if st is None else {k: jnp.asarray(v) for k, v in st.items()}
    tst = None if st is None else {k: torch.as_tensor(v)
                                   for k, v in st.items()}
    want_y, want_s = jax.jit(RS.mamba_block, static_argnums=1)(
        jp, rcfg, jnp.asarray(x), jst)
    got_y, got_s = TS.mamba_block(tp, tcfg, torch.as_tensor(x), tst)
    _close(got_y, want_y, **TOL)
    assert sorted(got_s) == ["conv", "h"]
    for k in got_s:
        assert got_s[k].dtype == torch.float32
        _close(got_s[k], want_s[k], **TOL)


def test_mamba_block_decode_matches_the_reference_and_the_block():
    """Token by token through mamba_block_decode from a carried state, each
    step against the reference's step, and the whole walk against one
    state-carried mamba_block over the same tokens."""
    rcfg, tcfg, jp, tp = _block_weights(seed=1)
    x = np.random.default_rng(6).normal(size=(B, 9, CFG["d_model"])
                                        ).astype(np.float32)
    st = _state(tcfg, 7)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.as_tensor(v) for k, v in st.items()}
    whole_y, whole_s = TS.mamba_block(tp, tcfg, torch.as_tensor(x), tst)
    step = jax.jit(RS.mamba_block_decode, static_argnums=1)
    ys = []
    for i in range(x.shape[1]):
        want_y, jst = step(jp, rcfg, jnp.asarray(x[:, i:i + 1]), jst)
        y, tst = TS.mamba_block_decode(tp, tcfg,
                                       torch.as_tensor(x[:, i:i + 1]), tst)
        assert y.shape == (B, 1, CFG["d_model"])
        _close(y, want_y, **TOL)
        for k in tst:
            _close(tst[k], jst[k], **TOL)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), whole_y.numpy(),
                               **TOL)
    for k in tst:
        np.testing.assert_allclose(tst[k].numpy(), whole_s[k].numpy(),
                                   **TOL)
