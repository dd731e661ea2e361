"""The port's LM substrate for RWKV6 (configs, ``models.layers``,
``models.ssm``, ``models.transformer``, ``convert``) against the JAX
reference, on the CPU in fp32.

Weights are the reference's ``init_model(PRNGKey)`` moved through numpy
into ``convert.params_from_numpy``, with the decay LoRA (``w_lora_a``,
``w_lora_b``) set to random values large enough that some decays fall
below e^-1, so that a missing clamp would show (at init ``w_lora_b`` is
zero and the clamp never bites). The reference runs its prefill on the
chunked ``wkv_chunked`` and the port on the sequential scan, so logits and
caches agree to rtol/atol 1e-4 rather than bit for bit; the model is never
compared in bf16 (ROADMAP queue 1 item 8).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as RC
from repro.models import layers as RL
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.kernels import ssm_scan as TK
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

ARCH = "rwkv6-1.6b"
TOL = dict(rtol=1e-4, atol=1e-4)
E_INV = float(np.exp(-1.0))


def _cfgs(arch=ARCH, **kw):
    rcfg = dataclasses.replace(RC.reduced_config(arch), dtype=jnp.float32,
                               **kw)
    tcfg = dataclasses.replace(TC.reduced_config(arch), dtype=torch.float32,
                               **kw)
    return rcfg, tcfg


def _perturb(tree, seed=0):
    rng = np.random.default_rng(seed)
    for blk in tree["blocks"].values():
        tm = blk["rwkv"]
        tm["w_lora_a"] = (0.5 * rng.normal(size=tm["w_lora_a"].shape)
                          ).astype(np.float32)
        tm["w_lora_b"] = (0.3 * rng.normal(size=tm["w_lora_b"].shape)
                          ).astype(np.float32)
    return tree


def _weights(rcfg, tcfg, seed=0):
    tree = jax.tree_util.tree_map(
        lambda a: np.array(a), RT.init_model(jax.random.PRNGKey(seed), rcfg))
    tree = _perturb(tree, seed)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            convert.params_from_numpy(tcfg, tree, device="cpu"))


@pytest.fixture(scope="module")
def model():
    rcfg, tcfg = _cfgs()
    jparams, tparams = _weights(rcfg, tcfg)
    toks = np.random.default_rng(1).integers(0, rcfg.vocab, (2, 24))
    return rcfg, tcfg, jparams, tparams, toks


def _close_trees(got, want, **tol):
    gl = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), got))
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, np.asarray(w), err_msg=str(path),
                                   **tol)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["dtype"] = (str(cfg.dtype).replace("torch.", "")
                    if isinstance(cfg.dtype, torch.dtype)
                    else jnp.dtype(cfg.dtype).name)
    return out


@pytest.mark.parametrize("arch", RC.ARCH_NAMES)
def test_every_config_equals_the_reference(arch):
    for rc, tc in ((RC.get_config(arch), TC.get_config(arch)),
                   (RC.reduced_config(arch), TC.reduced_config(arch))):
        assert _fields(tc) == _fields(rc)
        assert tc.num_periods == rc.num_periods
        for name, shape in TC.SHAPES.items():
            assert dataclasses.asdict(shape) == dataclasses.asdict(
                RC.SHAPES[name])
            assert TC.shape_applicable(tc, shape) == RC.shape_applicable(
                rc, RC.SHAPES[name])
    assert TC.ARCH_NAMES == RC.ARCH_NAMES
    with pytest.raises(KeyError):
        TC.get_config("no-such-arch")


def _builds_as_the_reference(arch):
    """The reduced ``arch`` on ``meta`` has the reference's parameter count,
    and its decode caches equal the reference's leaf for leaf."""
    cfg, rcfg = TC.reduced_config(arch), RC.reduced_config(arch)
    model = TT.init_model(cfg, device="meta")
    assert TT.param_count(model) == RT.param_count(jax.eval_shape(
        lambda: RT.init_model(jax.random.PRNGKey(0), rcfg)))
    got = TT.init_caches(cfg, 2, 8, device="cpu")
    want = RT.init_caches(rcfg, 2, 8)
    _close_trees(jax.tree_util.tree_map(lambda t: t.float(), got),
                 jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                        want), rtol=0, atol=0)
    return cfg, got


@pytest.mark.parametrize("arch,what", [("jamba-v0.1-52b", "Mamba")])
def test_families_of_later_slices_raise(arch, what):
    """The families that waited for a later slice (Mamba, MoE) now build:
    jamba's Mamba layers carry their O(1) conv ring and state."""
    cfg, caches = _builds_as_the_reference(arch)
    mixers = {s.mixer for s in cfg.pattern}
    assert what.lower() in mixers
    for i, spec in enumerate(cfg.pattern):
        if spec.mixer == "mamba":
            assert sorted(caches[f"p{i}"]["mamba"]) == ["conv", "h"]


def test_moe_still_waits_but_its_attention_caches_build():
    """olmoe's reduced layers are attention + MoE: the model builds with
    the reference's parameter count, and its caches are attention caches
    only."""
    cfg, caches = _builds_as_the_reference("olmoe-1b-7b")
    assert {(s.mixer, s.mlp) for s in cfg.pattern} == {("attn", "moe")}
    assert all(sorted(c) == ["attn"] for c in caches.values())


def test_gemma_2b_builds():
    cfg = TC.reduced_config("gemma-2b")
    model = TT.init_model(cfg, device="meta")
    assert TT.param_count(model) == RT.param_count(jax.eval_shape(
        lambda k: RT.init_model(k, RC.reduced_config("gemma-2b")),
        jax.random.PRNGKey(0)))
    caches = TT.init_caches(cfg, 1, 8, per_slot_pos=True, device="cpu")
    kv = caches["p0"]["attn"]
    assert tuple(kv.k.shape) == (cfg.num_layers, 1, 8, 1, 32)
    assert kv.k.dtype == torch.bfloat16
    assert bool((kv.pos == -1).all()) and tuple(kv.pos.shape) == (2, 1, 8)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_layers_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    scale = rng.normal(size=(32,)).astype(np.float32)
    bias = rng.normal(size=(32,)).astype(np.float32)
    p = {"scale": scale, "bias": bias}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    np.testing.assert_allclose(TL.rmsnorm(tp, tx).numpy(),
                               np.asarray(RL.rmsnorm(jp, jx)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(TL.groupnorm(tp, tx, 4).numpy(),
                               np.asarray(RL.groupnorm(jp, jx, 4)),
                               rtol=1e-5, atol=1e-5)
    q = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 5))
    np.testing.assert_allclose(
        TL.rope(torch.as_tensor(q), torch.as_tensor(pos), 1e4).numpy(),
        np.asarray(RL.rope(jnp.asarray(q), jnp.asarray(pos), 1e4)),
        rtol=1e-5, atol=1e-5)
    m = {k: rng.normal(size=s).astype(np.float32) / 4 for k, s in
         (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    for act in ("swiglu", "geglu"):
        np.testing.assert_allclose(
            TL.mlp({k: torch.as_tensor(v) for k, v in m.items()}, tx,
                   act).numpy(),
            np.asarray(RL.mlp({k: jnp.asarray(v) for k, v in m.items()},
                              jx, act)), rtol=1e-5, atol=1e-5)
    table = rng.normal(size=(50, 32)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 5))
    np.testing.assert_array_equal(
        TL.embed({"table": torch.as_tensor(table)}, torch.as_tensor(toks),
                 torch.float32).numpy(),
        np.asarray(RL.embed({"table": jnp.asarray(table)},
                            jnp.asarray(toks), jnp.float32)))
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        got = TL.logits({"table": torch.as_tensor(table)},
                        torch.as_tensor(x).to(td))
        want = RL.logits({"table": jnp.asarray(table)},
                         jnp.asarray(x).astype(jd))
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_init_draws_truncated_normals_from_the_generator():
    g = torch.Generator().manual_seed(0)
    a = TL.truncated_normal(g, (20000,), 0.5)
    b = TL.truncated_normal(torch.Generator().manual_seed(0), (20000,), 0.5)
    assert torch.equal(a, b)
    assert float(a.abs().max()) <= 1.0
    # std of a normal truncated at +-2 sigma is 0.8796 sigma
    assert abs(float(a.std()) - 0.5 * 0.8796) < 0.01
    he = TL.he_init(g, (64, 8), 64)
    assert float(he.abs().max()) <= 2 * (2 / 64) ** 0.5


# --------------------------------------------------------------------------
# RWKV blocks
# --------------------------------------------------------------------------

def _layer0(rcfg, tcfg, jparams, tparams):
    return (jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["p0"]),
            tparams.layers[0])


def test_time_mix_and_channel_mix_match_the_reference(model):
    rcfg, tcfg, jparams, tparams, _ = model
    jp, tp = _layer0(rcfg, tcfg, jparams, tparams)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 17, rcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    jr = RS.RWKVConfig(rcfg.d_model, rcfg.rwkv_head_dim)
    tr = TS.RWKVConfig(tcfg.d_model, tcfg.rwkv_head_dim)

    # the perturbed decay reaches both sides of the clamp
    *_, w = TS._time_mix_inputs(tp["rwkv"], tx, TS._token_shift(tx, None))
    assert (w < E_INV).any() and (w > E_INV).any()

    state = {"s": rng.normal(size=(2, jr.num_heads, 16, 16)).astype(
        np.float32), "x_prev": rng.normal(size=(2, 64)).astype(np.float32)}
    for st in (None, state):
        want_y, want_s = jax.jit(
            lambda p, x, s: RS.rwkv_time_mix(p, jr, x, s))(
                jp["rwkv"], jx, None if st is None else
                jax.tree_util.tree_map(jnp.asarray, st))
        got_y, got_s = TS.rwkv_time_mix(
            tp["rwkv"], tr, tx, None if st is None else
            {k: torch.as_tensor(v) for k, v in st.items()})
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
        _close_trees(got_s, want_s, **TOL)

    want_y, want_s = RS.rwkv_time_mix_decode(
        jp["rwkv"], jr, jx[:, :1], jax.tree_util.tree_map(jnp.asarray,
                                                          state))
    got_y, got_s = TS.rwkv_time_mix_decode(
        tp["rwkv"], tr, tx[:, :1],
        {k: torch.as_tensor(v) for k, v in state.items()})
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    _close_trees(got_s, want_s, **TOL)

    for xp in (None, state["x_prev"]):
        want = RS.rwkv_channel_mix(jp["rwkv_ffn"], jx,
                                   None if xp is None else jnp.asarray(xp))
        got = TS.rwkv_channel_mix(tp["rwkv_ffn"], tx,
                                  None if xp is None else torch.as_tensor(xp))
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), **TOL)


# --------------------------------------------------------------------------
# the whole model
# --------------------------------------------------------------------------

def test_apply_model_train_and_prefill_match_the_reference(model):
    rcfg, tcfg, jparams, tparams, toks = model
    jt, tt = jnp.asarray(toks), torch.as_tensor(toks)
    before = TK.launches
    for mode in ("train", "prefill"):
        want_l, want_aux, want_c = jax.jit(
            lambda p, t, m=mode: RT.apply_model(p, rcfg, tokens=t, mode=m))(
                jparams, jt)
        got_l, got_aux, got_c = TT.apply_model(tparams, tcfg, tokens=tt,
                                               mode=mode)
        assert tuple(got_l.shape) == tuple(want_l.shape)
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
        assert float(got_aux) == float(want_aux) == 0.0
        if mode == "train":
            assert got_c is None and want_c is None
        else:
            _close_trees(got_c, want_c, **TOL)
    assert TK.launches == before          # CPU: the plain version only


def test_apply_model_decode_and_chunk_match_the_reference(model):
    rcfg, tcfg, jparams, tparams, toks = model
    npre = 8
    jstep = jax.jit(lambda p, c, t, pos: RT.apply_model(
        p, rcfg, tokens=t, mode="decode", caches=c, pos_scalar=pos))
    _, _, jc = RT.apply_model(jparams, rcfg, tokens=jnp.asarray(toks[:, :npre]),
                              mode="prefill")
    _, _, tc = TT.apply_model(tparams, tcfg,
                              tokens=torch.as_tensor(toks[:, :npre]),
                              mode="prefill")
    # one token, then a chunk of 7, then one more token
    for lo, hi in ((npre, npre + 1), (npre + 1, npre + 8),
                   (npre + 8, npre + 9)):
        want_l, _, jc = jstep(jparams, jc, jnp.asarray(toks[:, lo:hi]),
                              jnp.asarray(lo, jnp.int32))
        got_l, _, tc = TT.apply_model(tparams, tcfg,
                                      tokens=torch.as_tensor(toks[:, lo:hi]),
                                      mode="decode", caches=tc, pos_scalar=lo)
        assert tuple(got_l.shape) == (2, hi - lo, rcfg.vocab)
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
        _close_trees(tc, jc, **TOL)


def test_prefill_then_decode_matches_full_forward(model):
    """As tests/test_models_smoke.py: teacher-forced decode after a
    prefill reproduces the full-sequence logits (here at 1e-4 in fp32)."""
    _, tcfg, _, tparams, toks = model
    tt = torch.as_tensor(toks[:, :16])
    full, _, _ = TT.apply_model(tparams, tcfg, tokens=tt, mode="train")
    npre = 8
    pre, _, caches = TT.apply_model(tparams, tcfg, tokens=tt[:, :npre],
                                    mode="prefill", cache_slots=16)
    torch.testing.assert_close(pre[:, -1], full[:, npre - 1], **TOL)
    for t in range(npre, 16):
        logits, _, caches = TT.apply_model(tparams, tcfg,
                                           tokens=tt[:, t:t + 1],
                                           mode="decode", caches=caches,
                                           pos_scalar=t)
        torch.testing.assert_close(logits[:, 0], full[:, t], **TOL)


def test_init_caches_match_the_reference():
    rcfg, tcfg = _cfgs()
    want = RT.init_caches(rcfg, batch=3, slots=10, per_slot_pos=True)
    got = TT.init_caches(tcfg, batch=3, slots=10, per_slot_pos=True,
                         device="cpu")
    _close_trees(got, want, rtol=0, atol=0)


def test_use_kernels_flag_and_bf16_config_on_cpu(model):
    _, tcfg, _, tparams, toks = model
    tt = torch.as_tensor(toks)
    on, _, c_on = TT.apply_model(tparams, tcfg, tokens=tt, mode="prefill")
    off, _, c_off = TT.apply_model(tparams, tcfg, tokens=tt, mode="prefill",
                                   use_kernels=False)
    assert torch.equal(on, off)
    bf = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    lg, _, caches = TT.apply_model(tparams, bf, tokens=tt, mode="prefill")
    assert lg.dtype == torch.float32 and bool(torch.isfinite(lg).all())
    assert caches["p0"]["rwkv"]["s"].dtype == torch.float32


def test_full_width_init_on_meta_has_the_reference_shapes():
    rcfg, tcfg = RC.get_config(ARCH), TC.get_config(ARCH)
    model = TT.init_model(tcfg, device="meta")
    assert TT.param_count(model) == 1_583_990_784
    want = jax.eval_shape(lambda k: RT.init_model(k, rcfg),
                          jax.random.PRNGKey(0))
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                 convert.reference_layout(tcfg, model))
    assert got == jax.tree_util.tree_map(lambda s: tuple(s.shape), want)
    assert RT.param_count(want) == TT.param_count(model)


def test_params_round_trip_through_numpy():
    rcfg, tcfg = _cfgs()
    tree = jax.tree_util.tree_map(
        np.asarray, RT.init_model(jax.random.PRNGKey(4), rcfg))
    back = convert.params_to_numpy(tcfg,
                                   convert.params_from_numpy(tcfg, tree,
                                                             device="cpu"))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch,dtype", [(1, torch.bfloat16), (1, torch.float32),
                                         (3, torch.bfloat16)])
def test_time_mix_hands_the_kernel_what_it_takes(model, monkeypatch, batch,
                                                 dtype):
    """The wrapper raises on the card for non-contiguous inputs (it checks
    after its fp32 cast). On the CPU it takes the plain version, so spy on
    the call: every tensor the time mix hands it must already be
    contiguous, and w clamped, at batch 1 too (where the head fold is a
    strided view)."""
    _, tcfg, _, tparams, toks = model
    cfg = dataclasses.replace(tcfg, dtype=dtype)
    seen = []

    def spy(*args):
        seen.append(args)
        return TK.ssm_scan_plain(*args)

    monkeypatch.setattr(TK, "ssm_scan", spy)
    tt = torch.as_tensor(toks[:batch])
    _, _, caches = TT.apply_model(tparams, cfg, tokens=tt, mode="prefill")
    TT.apply_model(tparams, cfg, tokens=tt[:, :5], mode="decode",
                   caches=caches)
    assert len(seen) == 2 * tcfg.num_layers
    for r, w, k, v, u, s0 in seen:
        for x in (r, w, k, v) + (() if s0 is None else (s0,)):
            assert x.is_contiguous()
            assert x.to(torch.float32).is_contiguous()
        assert u is None and bool((w >= E_INV * (1 - 1e-6)).all())
        assert w.dtype == torch.float32
