"""The port's MoE and hybrid decoders against the JAX reference, on the CPU
in fp32: reduced ``jamba-v0.1-52b`` (Mamba + attention + MoE),
``olmoe-1b-7b`` and ``moonshot-v1-16b-a3b`` (attention + MoE), with the
reference's ``init_model`` weights carried over by ``convert``.

Train and prefill logits agree to atol 1e-4 at the configs' own capacity
factor (both packages drop the same entries), the load-balancing loss to
1e-6. Caches agree leaf for leaf: Mamba's fp32 ``conv`` ring and state
``h`` to 1e-4, attention's bf16 ``k`` and ``v`` to one bf16 ulp (the fp32
projections differ in the last bits, test_torch_attn_lm.py). Decode runs
drop-free (``capacity_factor=16``, the reference's own test), since
capacity is shared across a batch and a chunk sees another batch than a
decode step. moonshot-v1-16b-a3b is olmoe's family at another width and k:
it is held to the reference in train, prefill and its caches, counts and
weights, and olmoe stands for both in the decode walks. The JAX side runs
jitted. The serving paths of these models are in
test_torch_hybrid_serve.py.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as RC
from repro.models import transformer as RT
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import transformer as TT

ARCHS = ("jamba-v0.1-52b", "olmoe-1b-7b", "moonshot-v1-16b-a3b")
TOL = dict(rtol=1e-4, atol=1e-4)
AUX_ATOL = 1e-6
DROP_FREE = 16.0

_rapply = jax.jit(RT.apply_model, static_argnames=("cfg", "mode",
                                                   "cache_slots"))


def _cfgs(arch, **kw):
    return (dataclasses.replace(RC.reduced_config(arch), dtype=jnp.float32,
                                **kw),
            dataclasses.replace(TC.reduced_config(arch), dtype=torch.float32,
                                **kw))


@pytest.fixture(scope="module")
def model():
    """``model(arch)``: (reference params, port params, numpy tree) of the
    reduced ``arch``, from ``PRNGKey(index)``, built once per module. The
    weights do not depend on the capacity factor or the dtype."""
    built = {}

    def get(arch):
        if arch not in built:
            rcfg, tcfg = _cfgs(arch)
            tree = jax.tree_util.tree_map(np.array, RT.init_model(
                jax.random.PRNGKey(ARCHS.index(arch)), rcfg))
            built[arch] = (jax.tree_util.tree_map(jnp.asarray, tree),
                           convert.params_from_numpy(tcfg, tree,
                                                     device="cpu"), tree)
        return built[arch]

    return get


def _caches_close(got, want, ulps=1):
    """Positions exactly, fp32 leaves at TOL, bf16 leaves within ``ulps``
    bf16 ulps with at most 1% of the values apart."""
    gl = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
        lambda t: t.to(torch.float32).numpy()
        if t.dtype == torch.bfloat16 else t.numpy(), got))
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        w = np.asarray(w)
        assert g.shape == w.shape, path
        if w.dtype == jnp.bfloat16:
            w = w.astype(np.float32)
            mag = np.maximum(np.abs(g), np.abs(w))
            ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
            assert np.all(np.abs(g - w) <= ulps * ulp), path
            assert np.mean(g != w) <= 0.01, path
        elif w.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            np.testing.assert_allclose(g, w, err_msg=str(path), **TOL)


def _toks(vocab, seed, shape=(2, 24)):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_and_prefill_match_the_reference(arch, model):
    rcfg, tcfg = _cfgs(arch)
    jparams, tparams, _ = model(arch)
    toks = _toks(rcfg.vocab, 1)
    for mode in ("train", "prefill"):
        want_l, want_aux, want_c = _rapply(
            jparams, cfg=rcfg, tokens=jnp.asarray(toks), mode=mode,
            cache_slots=32)
        got_l, got_aux, got_c = TT.apply_model(
            tparams, tcfg, tokens=torch.as_tensor(toks), mode=mode,
            cache_slots=32)
        assert tuple(got_l.shape) == tuple(want_l.shape)
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
        assert float(want_aux) > 0
        assert abs(float(got_aux) - float(want_aux)) <= AUX_ATOL
        if mode == "prefill":
            _caches_close(got_c, want_c)
    # the reduced configs' 1.25 drops entries at this batch
    xt = TT.L.embed(tparams.embed, torch.as_tensor(toks), torch.float32)
    assert TT.moe_lib.capacity(xt.shape[0] * xt.shape[1],
                               TT._moe_cfg(tcfg)) < xt.shape[0] * xt.shape[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_the_reference(arch):
    rcfg, tcfg = _cfgs(arch)
    for per_slot in (False, True):
        got = TT.init_caches(tcfg, 3, 16, per_slot_pos=per_slot,
                             device="cpu")
        want = RT.init_caches(rcfg, 3, 16, per_slot_pos=per_slot)
        _caches_close(got, want)
        for leaf, w in zip(jax.tree_util.tree_leaves(got),
                           jax.tree_util.tree_leaves(want)):
            assert str(leaf.dtype).replace("torch.", "") == w.dtype.name


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_prefill_then_decode_matches_the_full_forward(arch, model):
    """Two walks over 16 tokens, every step's logits against the
    reference's same step (1e-4) and against the full forward at the
    reference's own test bound (bf16 KV caches): a prefill of 8 then
    one-token steps over the shared-clock caches (the reference's test),
    and, over per-row caches as the scheduler keeps them, chunks of 8 and
    4 (the state-carried Mamba scan) then one-token steps. The caches
    after a walk agree to 4 bf16 ulps: a value read back from a bf16 cache
    that rounded the other way moves the next positions' fp32 k and v by
    more than the last bits (3 ulps on a few in 10^4 values here)."""
    rcfg, tcfg = _cfgs(arch, capacity_factor=DROP_FREE)
    jparams, tparams, _ = model(arch)
    toks = _toks(rcfg.vocab, 2, (2, 16))
    jt, tt = jnp.asarray(toks), torch.as_tensor(toks)
    full, _, _ = TT.apply_model(tparams, tcfg, tokens=tt, mode="train")
    _, _, jc = _rapply(jparams, cfg=rcfg, tokens=jt[:, :8],
                              mode="prefill", cache_slots=16)
    _, _, tc = TT.apply_model(tparams, tcfg, tokens=tt[:, :8],
                              mode="prefill", cache_slots=16)
    walks = [(jc, tc, [(t, t + 1) for t in range(8, 16)], int)]
    walks.append((RT.init_caches(rcfg, 2, 16, per_slot_pos=True),
                  TT.init_caches(tcfg, 2, 16, per_slot_pos=True,
                                 device="cpu"),
                  [(0, 8), (8, 12)] + [(t, t + 1) for t in range(12, 16)],
                  lambda a: np.full((2,), a, np.int32)))
    for jc, tc, spans, pos in walks:
        for a, b in spans:
            want, _, jc = _rapply(
                jparams, cfg=rcfg, tokens=jt[:, a:b], mode="decode",
                caches=jc, pos_scalar=jnp.asarray(pos(a), jnp.int32))
            got, _, tc = TT.apply_model(
                tparams, tcfg, tokens=tt[:, a:b], mode="decode", caches=tc,
                pos_scalar=torch.as_tensor(pos(a), dtype=torch.int64))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                       err_msg=f"{arch} decode at {a}")
            np.testing.assert_allclose(got.numpy(), full[:, a:b].numpy(),
                                       rtol=3e-2, atol=3e-2)
        _caches_close(tc, jc, ulps=4)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_exactly(arch, model):
    _, tcfg = _cfgs(arch)
    _, tparams, tree = model(arch)
    back = convert.params_to_numpy(tcfg, tparams)
    bl = jax.tree_util.tree_leaves_with_path(back)
    wl = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in bl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(bl, wl):
        assert g.dtype == w.dtype == np.float32, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    names = {jax.tree_util.keystr(p) for p, _ in wl}
    want = {"router", "expert_gate", "expert_up", "expert_down"}
    if arch.startswith("jamba"):
        want |= {"w_in", "conv_w", "conv_b", "w_x", "w_dt", "dt_bias",
                 "a_log", "d_skip", "w_out"}
    assert all(any(f"['{n}']" in p for p in names) for n in want)


@pytest.mark.parametrize("arch", ARCHS)
def test_active_param_count_equals_the_reference(arch, model):
    rcfg, tcfg = _cfgs(arch)
    jparams, tparams, _ = model(arch)
    assert TT.param_count(tparams) == RT.param_count(jparams)
    got = TT.active_param_count(tparams, tcfg)
    assert got == RT.active_param_count(jparams, rcfg)
    assert got < TT.param_count(tparams)


@pytest.mark.parametrize("arch,lo,hi", [
    ("olmoe-1b-7b", 6.0e9, 7.5e9), ("jamba-v0.1-52b", 49e9, 56e9),
    ("moonshot-v1-16b-a3b", 0, float("inf"))])
def test_full_configs_build_on_meta_at_the_reference_count(arch, lo, hi):
    cfg = TC.get_config(arch)
    rcfg = RC.get_config(arch)
    m = TT.init_model(cfg, device="meta")
    n = TT.param_count(m)
    shapes = jax.eval_shape(lambda: RT.init_model(jax.random.PRNGKey(0),
                                                  rcfg))
    assert n == RT.param_count(shapes)
    assert lo <= n <= hi
    assert TT.active_param_count(m, cfg) == RT.active_param_count(shapes,
                                                                  rcfg)
