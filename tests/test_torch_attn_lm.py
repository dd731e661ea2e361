"""The port's attention LMs against the JAX reference, on the CPU in fp32:
``gemma-2b`` (MQA, GeGLU, tied and scaled embeddings), ``deepseek-7b``
(MHA), ``qwen2.5-14b`` (QKV bias) and ``gemma3-12b`` (a sliding window of
16 with qk-norm) at their ``reduced()`` configs, weights from the
reference's ``init_model`` carried over by ``convert``.

Logits agree to rtol 1e-5 / atol 1e-4 in train, prefill, decode and chunked
decode. Cache positions are equal. The bf16 ``k`` and ``v`` leaves are the
fp32 projections rounded once; those projections differ between the two
frameworks in the last fp32 bits (their matmuls sum in other orders), so a
value that lies on a bf16 rounding boundary can round the other way: the
leaves agree to one bf16 ulp, with at most 1% of the values apart (a few in
ten thousand here). Given the same inputs, the cache functions are bit
exact (test_torch_attention.py). On the CPU every prefill runs the
``flash_attention`` kernel's plain version; no kernel launches.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as RC
from repro.models import transformer as RT
from repro.serve import engine as RE
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.kernels import flash_attention as KF
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as TE

ARCHS = ("gemma-2b", "deepseek-7b", "qwen2.5-14b", "gemma3-12b")
TOL = dict(rtol=1e-5, atol=1e-4)


def _cfgs(arch):
    return (dataclasses.replace(RC.reduced_config(arch), dtype=jnp.float32),
            dataclasses.replace(TC.reduced_config(arch), dtype=torch.float32))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    rcfg, tcfg = _cfgs(arch)
    seed = ARCHS.index(arch)
    tree = jax.tree_util.tree_map(
        np.array, RT.init_model(jax.random.PRNGKey(seed), rcfg))
    if rcfg.qkv_bias:                   # zero at init: make the bias bite
        rng = np.random.default_rng(seed)
        for name in ("bq", "bk", "bv"):
            leaf = tree["blocks"]["p0"]["attn"][name]
            leaf[...] = 0.5 * rng.normal(size=leaf.shape)
    toks = np.random.default_rng(seed + 10).integers(0, rcfg.vocab, (2, 40))
    return (rcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            convert.params_from_numpy(tcfg, tree, device="cpu"), toks)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _caches_close(got, want):
    gl = _leaves(jax.tree_util.tree_map(
        lambda t: t.to(torch.float32).numpy()
        if t.dtype == torch.bfloat16 else t.numpy(), got))
    wl = _leaves(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        w = np.asarray(w)
        assert g.shape == w.shape, path
        if w.dtype == jnp.bfloat16:
            w = w.astype(np.float32)
            mag = np.maximum(np.abs(g), np.abs(w))
            ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
            assert np.all(np.abs(g - w) <= ulp), path
            assert np.mean(g != w) <= 0.01, path
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_train_and_prefill_match_the_reference(model):
    rcfg, tcfg, jparams, tparams, toks = model
    jt, tt = jnp.asarray(toks[:, :24]), torch.as_tensor(toks[:, :24])
    before = KF.launches
    wants = {}
    for mode in ("train", "prefill"):
        want_l, want_aux, want_c = wants[mode] = RT.apply_model(
            jparams, rcfg, tokens=jt, mode=mode, cache_slots=32)
        got_l, got_aux, got_c = TT.apply_model(
            tparams, tcfg, tokens=tt, mode=mode, cache_slots=32)
        assert tuple(got_l.shape) == tuple(want_l.shape)
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
        assert float(got_aux) == float(want_aux) == 0.0
        if mode == "train":
            assert got_c is None and want_c is None
        else:
            _caches_close(got_c, want_c)
    plain, _, _ = TT.apply_model(tparams, tcfg, tokens=tt, mode="train",
                                 use_kernels=False)
    np.testing.assert_allclose(plain.numpy(), np.asarray(wants["train"][0]),
                               **TOL)
    assert KF.launches == before            # CPU: the plain versions only


def test_decode_and_chunks_match_the_reference(model):
    rcfg, tcfg, jparams, tparams, toks = model
    # shared clock: prefill 20, then two one-token steps
    _, _, jc = RT.apply_model(jparams, rcfg, tokens=jnp.asarray(toks[:, :20]),
                              mode="prefill", cache_slots=40)
    _, _, tc = TT.apply_model(tparams, tcfg,
                              tokens=torch.as_tensor(toks[:, :20]),
                              mode="prefill", cache_slots=40)
    for t in (20, 21):
        want, _, jc = RT.apply_model(
            jparams, rcfg, tokens=jnp.asarray(toks[:, t:t + 1]),
            mode="decode", caches=jc, pos_scalar=jnp.asarray(t, jnp.int32))
        got, _, tc = TT.apply_model(
            tparams, tcfg, tokens=torch.as_tensor(toks[:, t:t + 1]),
            mode="decode", caches=tc, pos_scalar=t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _caches_close(tc, jc)
    # per-row clocks: chunks of 8 and 13 and a step, past gemma3's window
    jc = RT.init_caches(rcfg, 2, 40, per_slot_pos=True)
    tc = TT.init_caches(tcfg, 2, 40, per_slot_pos=True, device="cpu")
    _caches_close(tc, jc)
    for lo, hi in ((0, 8), (8, 21), (21, 22)):
        want, _, jc = RT.apply_model(
            jparams, rcfg, tokens=jnp.asarray(toks[:, lo:hi]), mode="decode",
            caches=jc, pos_scalar=jnp.full((2,), lo, jnp.int32))
        got, _, tc = TT.apply_model(
            tparams, tcfg, tokens=torch.as_tensor(toks[:, lo:hi]),
            mode="decode", caches=tc, pos_scalar=torch.full((2,), lo))
        assert tuple(got.shape) == (2, hi - lo, rcfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _caches_close(tc, jc)


def test_generate_is_token_identical_to_the_reference(model):
    rcfg, tcfg, jparams, tparams, _ = model
    rng = np.random.default_rng(7)
    before = KF.launches
    for ln in (5, 27):                      # ragged: 0 and 3 full chunks
        prompt = rng.integers(0, rcfg.vocab, ln).astype(np.int32)
        want, wr = RE.generate(jparams, rcfg, prompt, 8, prefill_chunk=8)
        got, gr = TE.generate(tparams, tcfg, prompt, 8, prefill_chunk=8)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert gr == wr == "length"
    assert KF.launches == before
