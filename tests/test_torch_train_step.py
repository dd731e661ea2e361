"""The port's train step against the JAX reference's on the CPU, in fp32,
for the ten configs' ``reduced_config``: the reference's parameters
(``init_model``) carried over by ``convert.params_from_numpy``, the same
numpy batch (tokens, or embeddings for the embeds configs, a mask with
zeros), and

  * the loss (CE + z-loss + aux), the MoE aux loss and the gradient norm,
    at rtol 1e-5;
  * every gradient before clipping, per leaf, within 1e-4 of the leaf's
    largest |g| (the two frameworks sum in other orders; the errors seen
    are near 1e-6).

The reference's gradients come from ``jax.value_and_grad`` of its step's
loss (``repro.train.step``: ``apply_model`` in train mode, ``lm_loss``,
plus the aux loss), jitted as its launcher jits the step; the port's from
``train.step.loss_and_grads`` (on the CPU ``flash_attention`` and
``ssm_scan`` run their plain forward and backward). AdamW on identical
gradients is held in test_torch_optim.py and on a whole step here only
where |g| is clear of zero (Adam's first update is g / (|g| + eps), whose
sign flips with |g| near 0).

The configs are split over this file and test_torch_train_step_more.py
so that each file runs in about 40 s.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as RC
from repro.models import transformer as RT
from repro.optim import adamw as RA
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as TA
from repro_torch.train import step as TS

ARCHS = ("gemma-2b", "deepseek-7b", "qwen2.5-14b", "gemma3-12b",
         "rwkv6-1.6b")
B, S = 2, 24


def cfgs(arch):
    return (dataclasses.replace(RC.reduced_config(arch), dtype=jnp.float32),
            dataclasses.replace(TC.reduced_config(arch), dtype=torch.float32))


def make_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab, (B, S)),
             "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if cfg.input_mode == "embeds":
        batch["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S))
    return batch


def reference_grads(rcfg, params, batch):
    """(loss, aux, grads) of the reference step's loss, jitted."""
    def loss_for(p, mb):
        logits, aux, _ = RT.apply_model(p, rcfg, tokens=mb.get("tokens"),
                                        embeds=mb.get("embeds"),
                                        mode="train")
        loss, _ = RT.lm_loss(logits, mb["labels"], mb.get("mask"))
        return loss + aux, aux
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
          for k, v in batch.items()}
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_for, has_aux=True))(
        params, jb)
    return float(loss), float(aux), grads


def nest(named):
    """{name: tensor} of a Model's parameters -> the tree Model() takes."""
    tree, layers = {}, {}
    for name, g in named.items():
        parts = name.split(".")
        d = tree
        if parts[0] == "layers":
            d = layers.setdefault(int(parts[1]), {})
            parts = parts[2:]
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = g
    tree["layers"] = [layers[i] for i in sorted(layers)]
    return tree


def port_setup(arch, seed):
    rcfg, tcfg = cfgs(arch)
    tree = jax.tree_util.tree_map(
        np.array, RT.init_model(jax.random.PRNGKey(seed), rcfg))
    params = convert.params_from_numpy(tcfg, tree, device="cpu")
    params.requires_grad_(True)
    batch = make_batch(rcfg, seed + 100)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return rcfg, tcfg, tree, params, batch, tb


def check_grads(tcfg, named, want_tree, tol=1e-4):
    got = convert.params_to_numpy(tcfg, TT.Model(nest(named)))
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want_tree)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        w = np.asarray(w)
        assert g.shape == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-8)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (jax.tree_util.keystr(path), err, scale)


def step_parity(arch, seed):
    rcfg, tcfg, tree, params, batch, tb = port_setup(arch, seed)
    want_loss, want_aux, want = reference_grads(
        rcfg, jax.tree_util.tree_map(jnp.asarray, tree), batch)
    loss, metrics, aux, grads = TS.loss_and_grads(params, tcfg, tb)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5, atol=1e-7)
    _, want_norm = RA.clip_by_global_norm(want, 1.0)
    _, got_norm = TA.clip_by_global_norm(dict(grads), float("inf"))
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-5)
    check_grads(tcfg, grads, want)
    return rcfg, tcfg, tree, params, batch, tb, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_gradients_match_reference(arch):
    step_parity(arch, ARCHS.index(arch))


def test_whole_step_matches_reference_where_the_gradient_is_clear_of_zero():
    """One reference make_train_step against the port's, gemma-2b: the
    metrics, and the updated parameters wherever |g| > 1e-3 of the leaf's
    largest (elsewhere Adam's g / (|g| + eps) may flip sign)."""
    from repro.train import step as RS
    rcfg, tcfg, tree, params, batch, tb = port_setup("gemma-2b", 0)
    opt = dict(peak_lr=1e-2, warmup_steps=0, decay_steps=10)
    rstate = RS.TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, tree),
        opt=RA.init_opt_state(jax.tree_util.tree_map(jnp.asarray, tree)),
        step=jnp.zeros((), jnp.int32))
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
          for k, v in batch.items()}
    rnew, rm = jax.jit(RS.make_train_step(rcfg, RA.AdamWConfig(**opt)))(
        rstate, jb)
    _, _, _, grads = TS.loss_and_grads(params, tcfg, tb)
    gtree = convert.params_to_numpy(tcfg, TT.Model(nest(grads)))
    tstate = TS.TrainState(params=params, opt=TA.init_opt_state(params),
                           step=torch.zeros((), dtype=torch.int32))
    tnew, tm = TS.make_train_step(tcfg, TA.AdamWConfig(**opt))(tstate, tb)
    assert int(tnew.step) == 1
    for k in ("loss", "ce", "z_loss", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-5,
                                   atol=1e-8, err_msg=k)
    got = convert.params_to_numpy(tcfg, tnew.params)
    for (path, g), (_, w), (_, gr) in zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(rnew.params),
            jax.tree_util.tree_leaves_with_path(gtree)):
        clear = np.abs(gr) > 1e-3 * max(np.abs(gr).max(), 1e-30)
        w = np.asarray(w)
        np.testing.assert_allclose(g[clear], w[clear], rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("policy", ["off", "full", "dots"])
def test_remat_policies_give_the_same_gradients(policy):
    """cfg.remat off, full recompute and remat_policy="dots" (matrix
    products saved): one gradient, bit for bit on the CPU."""
    _, tcfg, _, params, _, tb = port_setup("gemma3-12b", 7)
    base = dataclasses.replace(tcfg, remat=False)
    _, _, _, want = TS.loss_and_grads(params, base, tb)
    cfg = dataclasses.replace(tcfg, remat=policy != "off",
                              remat_policy="dots" if policy == "dots"
                              else "full")
    _, _, _, got = TS.loss_and_grads(params, cfg, tb)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_gradient_accumulation_matches_the_single_pass():
    """accum_steps=2: microbatches of half the batch, gradients averaged in
    fp32 (the mask keeps the per-microbatch CE means equal in weight only
    when both halves keep as many tokens, so the mask is all ones)."""
    _, tcfg, _, params, _, tb = port_setup("deepseek-7b", 3)
    tb["mask"] = torch.ones_like(tb["mask"])
    l1, m1, _, g1 = TS.loss_and_grads(params, tcfg, tb)
    l2, m2, _, g2 = TS.loss_and_grads(params, tcfg, tb, accum_steps=2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    for name in g1:
        scale = float(g1[name].abs().max()) + 1e-12
        assert float((g2[name] - g1[name]).abs().max()) <= 1e-5 * scale, name
    with pytest.raises(ValueError):
        TS.loss_and_grads(params, tcfg, tb, accum_steps=3)
