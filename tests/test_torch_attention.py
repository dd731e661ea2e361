"""The port's ``models.attention`` against the JAX package's, on the CPU in
fp32: the same numpy inputs through both. Attention outputs agree to rtol
1e-5 / atol 1e-4 (the two frameworks sum in other orders); cache leaves
are exact, bf16 ``k`` and ``v`` bit for bit and ``pos`` equal, because
they are the same inputs rounded once. The whole model is in
test_torch_attn_lm.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.models import attention as RA
from repro_torch.kernels import flash_attention as KF
from repro_torch.models import attention as TA

TOL = dict(rtol=1e-5, atol=1e-4)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.as_tensor(a) for a in arrays])


def _cache_equal(got, want):
    assert isinstance(got, TA.KVCache)
    for name in ("k", "v"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        np.testing.assert_array_equal(g.to(torch.float32).numpy(),
                                      np.asarray(w, np.float32),
                                      err_msg=name)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))


@pytest.mark.parametrize("kv_block", [8, 16, 512])
@pytest.mark.parametrize("window", [0, 5])
def test_blockwise_attention_with_empty_slots(kv_block, window):
    rng = np.random.default_rng(kv_block + window)
    b, sq, skv, h, kvh, hd = 2, 3, 21, 4, 2, 16
    q, k, v = (_normal(rng, b, sq, h, hd), _normal(rng, b, skv, kvh, hd),
               _normal(rng, b, skv, kvh, hd))
    q_pos = np.array([[14, 15, 16], [7, 8, 9]], np.int32)
    kv_pos = rng.permutation(np.arange(-4, skv - 4)).astype(np.int32)
    kv_pos = np.stack([kv_pos, np.where(kv_pos > 9, -1, kv_pos)])
    (jq, jk, jv, jqp, jkp), (tq, tk, tv, tqp, tkp) = _both(q, k, v, q_pos,
                                                          kv_pos)
    want = RA.blockwise_attention(jq, jk, jv, jqp, jkp, window, kv_block)
    got = TA.blockwise_attention(tq, tk, tv, tqp, tkp, window, kv_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,s,h,kvh,hd,win", [(2, 48, 4, 2, 16, 8),
                                              (1, 33, 2, 2, 8, 12),
                                              (1, 20, 4, 1, 32, 16)])
def test_banded_attention(b, s, h, kvh, hd, win):
    rng = np.random.default_rng(s + win)
    q, k, v = (_normal(rng, b, s, h, hd), _normal(rng, b, s, kvh, hd),
               _normal(rng, b, s, kvh, hd))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    (jq, jk, jv, jp), (tq, tk, tv, tp) = _both(q, k, v, pos.copy())
    want = RA.banded_attention(jq, jk, jv, jp, win)
    got = TA.banded_attention(tq, tk, tv, tp, win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the kernel's function (plain on the CPU) is the same attention
    flash = KF.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                               tv.transpose(1, 2), win).transpose(1, 2)
    np.testing.assert_allclose(flash.numpy(), np.asarray(want), **TOL)


def test_cache_update_scalar_position():
    rng = np.random.default_rng(0)
    tc = TA.make_cache(2, 4, 2, 8)
    jc = RA.make_cache(2, 4, 2, 8)
    for pos in range(6):                    # wraps the ring of 4
        k, v = _normal(rng, 2, 1, 2, 8), _normal(rng, 2, 1, 2, 8)
        jc = RA.cache_update(jc, jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos, jnp.int32))
        tc = TA.cache_update(tc, torch.as_tensor(k), torch.as_tensor(v),
                             pos)
        _cache_equal(tc, jc)
    assert sorted(tc.pos.tolist()) == [2, 3, 4, 5]


@pytest.mark.parametrize("sq", [1, 3, 9])    # 9 > 6 slots: the last 6 stay
def test_cache_update_vector_position(sq):
    rng = np.random.default_rng(sq)
    jc = RA.make_cache(2, 6, 1, 8, per_row_pos=True)
    start = TA.make_cache(2, 6, 1, 8, per_row_pos=True)
    for pos in ([0, 2], [5, 11]):
        k, v = _normal(rng, 2, sq, 1, 8), _normal(rng, 2, sq, 1, 8)
        jc = RA.cache_update(jc, jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos, jnp.int32))
        tc = TA.cache_update(start, torch.as_tensor(k), torch.as_tensor(v),
                             torch.as_tensor(pos))
        _cache_equal(tc, jc)
        assert not torch.equal(tc.pos, start.pos)   # out of place
        start = tc
    with pytest.raises(ValueError, match="per-row"):
        TA.cache_update(TA.make_cache(2, 6, 1, 8), torch.zeros(2, 1, 1, 8),
                        torch.zeros(2, 1, 1, 8), torch.tensor([0, 1]))


@pytest.mark.parametrize("s,slots", [(10, 10), (13, 6), (5, 8)])
def test_build_cache(s, slots):
    rng = np.random.default_rng(s * slots)
    k, v = _normal(rng, 2, s, 2, 8), _normal(rng, 2, s, 2, 8)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (2, s)).copy()
    want = RA.build_cache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                          slots)
    got = TA.build_cache(torch.as_tensor(k), torch.as_tensor(v),
                         torch.as_tensor(pos), slots)
    _cache_equal(got, want)


def _layer(rng, cfg):
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": _normal(rng, d, h * hd) / 4, "wk": _normal(rng, d, kvh * hd) / 4,
         "wv": _normal(rng, d, kvh * hd) / 4,
         "wo": _normal(rng, h * hd, d) / 4}
    if cfg.bias:
        p.update(bq=_normal(rng, h * hd), bk=_normal(rng, kvh * hd),
                 bv=_normal(rng, kvh * hd))
    if cfg.qk_norm:
        p.update(q_norm={"scale": 1 + _normal(rng, hd) / 4},
                 k_norm={"scale": 1 + _normal(rng, hd) / 4})
    to = lambda f: {k: ({kk: f(vv) for kk, vv in x.items()}  # noqa: E731
                        if isinstance(x, dict) else f(x))
                    for k, x in p.items()}
    return to(jnp.asarray), to(torch.as_tensor)


@pytest.mark.parametrize("bias,qk_norm,window", [(False, False, 0),
                                                 (True, False, 0),
                                                 (False, True, 6)])
def test_attention_prefill_decode_and_chunk(bias, qk_norm, window):
    kw = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=16,
              bias=bias, qk_norm=qk_norm, window=window, kv_block=8)
    rcfg, tcfg = RA.AttnConfig(**kw), TA.AttnConfig(**kw)
    rng = np.random.default_rng(int(bias) + 2 * int(qk_norm))
    jp, tp = _layer(rng, rcfg)
    b, s = 2, 11
    x = _normal(rng, b, s + 6, 32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    slots = 16

    # prefill, with the plain path and with the kernel's function
    want, jc = RA.attention(jp, rcfg, jnp.asarray(x[:, :s]), jnp.asarray(pos),
                            make_cache_slots=slots)
    before = KF.launches
    for use in (False, True):
        got, tc = TA.attention(tp, tcfg, torch.as_tensor(x[:, :s]),
                               torch.as_tensor(pos), make_cache_slots=slots,
                               use_kernels=use)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _cache_equal(tc, jc)
    assert KF.launches == before

    # two one-token steps on the shared clock
    for t in (s, s + 1):
        xt, pt = x[:, t:t + 1], np.full((b, 1), t, np.int32)
        want, jc = RA.attention(jp, rcfg, jnp.asarray(xt), jnp.asarray(pt),
                                cache=jc,
                                position_scalar=jnp.asarray(t, jnp.int32))
        got, tc = TA.attention(tp, tcfg, torch.as_tensor(xt),
                               torch.as_tensor(pt), cache=tc,
                               position_scalar=torch.tensor(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _cache_equal(tc, jc)

    # a chunk of 4 on per-row clocks (rows at different depths), over a
    # per-row cache filled by the reference
    jc = RA.make_cache(b, 8, 2, 16, per_row_pos=True)
    jc = RA.cache_update(jc, jnp.asarray(_normal(rng, b, 5, 2, 16)),
                         jnp.asarray(_normal(rng, b, 5, 2, 16)),
                         jnp.asarray([0, 2], jnp.int32))
    tc = TA.KVCache(*(torch.as_tensor(np.array(a, np.float32))
                      for a in jc[:2]), torch.as_tensor(np.array(jc.pos)))
    tc = tc._replace(k=tc.k.to(torch.bfloat16), v=tc.v.to(torch.bfloat16))
    p0 = np.array([5, 7], np.int32)
    pc = p0[:, None] + np.arange(4, dtype=np.int32)[None]
    xc = x[:, s:s + 4]
    want, jc2 = RA.attention(jp, rcfg, jnp.asarray(xc), jnp.asarray(pc),
                             cache=jc, position_scalar=jnp.asarray(p0))
    got, tc2 = TA.attention(tp, tcfg, torch.as_tensor(xc),
                            torch.as_tensor(pc), cache=tc,
                            position_scalar=torch.as_tensor(p0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _cache_equal(tc2, jc2)
    _cache_equal(tc, jc)                    # the input cache is untouched
