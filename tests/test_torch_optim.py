"""The port's loss and optimizer against the JAX reference on the CPU, in
fp32, on the same numpy inputs (mirroring tests/test_optim.py):
``lm_loss`` (masked CE plus z-loss), the warmup + cosine schedule,
global-norm clipping, AdamW (several steps, the bias correction in fp32 as
the reference computes it) and int8 gradient compression with error
feedback (``torch.round`` and ``jnp.round`` both round half to even, so
the int8 codes are equal). Tolerances: 1e-6 relative for the schedule,
the norm and the loss; 1e-6 of the largest value for AdamW's updated
parameters and moments (the two frameworks may fuse the update's
multiply-adds differently); the int8 codes exactly.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.models import transformer as RT
from repro.optim import adamw as RA
from repro.train import grad_compress as RGC
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as TA
from repro_torch.train import grad_compress as TGC


def _tree(seed, shapes=((4, 3), (7,), (2, 5, 2))):
    rng = np.random.default_rng(seed)
    return {f"p{i}": rng.normal(size=s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("with_mask", [False, True])
def test_lm_loss_matches_reference(with_mask):
    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(2, 9, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9))
    mask = (rng.random((2, 9)) < 0.6).astype(np.float32) if with_mask \
        else None
    want, wm = RT.lm_loss(jnp.asarray(logits), jnp.asarray(labels, jnp.int32),
                          None if mask is None else jnp.asarray(mask))
    got, gm = TT.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                         None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for k in ("ce", "z_loss"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6)


def test_lm_loss_all_masked_is_zero_and_bf16_logits_upcast():
    logits = torch.randn(1, 4, 10, dtype=torch.bfloat16)
    loss, m = TT.lm_loss(logits, torch.zeros(1, 4, dtype=torch.int64),
                         torch.zeros(1, 4))
    assert float(loss) == 0.0 and loss.dtype == torch.float32


def test_lr_schedule_matches_reference():
    cfg = dict(peak_lr=1e-3, warmup_steps=10, decay_steps=100,
               min_lr_ratio=0.1)
    rc, tc = RA.AdamWConfig(**cfg), TA.AdamWConfig(**cfg)
    got = [float(TA.lr_at(tc, s)) for s in range(0, 120, 3)]
    want = [float(RA.lr_at(rc, s)) for s in range(0, 120, 3)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 0.0


def test_clip_by_global_norm_matches_reference():
    g = _tree(1)
    for max_norm in (1.0, 1e9):
        want, wn = RA.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        got, gn = TA.clip_by_global_norm(_t(g), max_norm)
        np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("warmup", [0, 3])
def test_adamw_matches_reference_over_steps(warmup):
    cfg = dict(peak_lr=1e-2, warmup_steps=warmup, decay_steps=20,
               weight_decay=0.1)
    rc, tc = RA.AdamWConfig(**cfg), TA.AdamWConfig(**cfg)
    p = _tree(2)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    ropt = RA.init_opt_state(rp)
    tp = _t(p)
    topt = TA.init_opt_state(tp)
    for step in range(5):
        g = _tree(10 + step)
        rp, ropt, rlr = RA.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, ropt, rp, rc)
        tp, topt, tlr = TA.adamw_update(_t(g), topt, tp, tc)
        np.testing.assert_allclose(float(tlr), float(rlr), rtol=1e-6)
        assert int(topt["count"]) == int(ropt["count"]) == step + 1
        for k in p:
            for got, want in ((tp[k], rp[k]), (topt["mu"][k], ropt["mu"][k]),
                              (topt["nu"][k], ropt["nu"][k])):
                want = np.asarray(want)
                scale = max(1e-30, float(np.abs(want).max()))
                assert np.abs(got.numpy() - want).max() <= 1e-6 * scale


def test_adamw_numpy_oracle_and_in_place():
    """test_optim.py's oracle at count 1; the update is in place."""
    cfg = TA.AdamWConfig(peak_lr=1e-2, warmup_steps=0, decay_steps=10**9,
                         weight_decay=0.1)
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    ref = p["w"]
    opt = TA.init_opt_state(p)
    newp, _, lr = TA.adamw_update({"w": torch.tensor([0.1, 0.2, -0.3])},
                                  opt, p, cfg)
    assert newp["w"] is ref
    gn, pn = np.array([0.1, 0.2, -0.3]), np.array([1.0, -2.0, 3.0])
    m, v = (1 - cfg.b1) * gn, (1 - cfg.b2) * gn ** 2
    step = (m / (1 - cfg.b1)) / (np.sqrt(v / (1 - cfg.b2)) + cfg.eps) \
        + cfg.weight_decay * pn
    np.testing.assert_allclose(ref.numpy(), pn - float(lr) * step,
                               rtol=1e-5)


def test_adamw_on_a_model_keeps_fp32_moments_for_bf16_params():
    from torch import nn
    m = nn.Linear(3, 2).to(torch.bfloat16)
    opt = TA.init_opt_state(m)
    assert all(t.dtype == torch.float32 for t in opt["mu"].values())
    grads = {n: torch.full_like(p, 0.1) for n, p in m.named_parameters()}
    TA.adamw_update(grads, opt, m, TA.AdamWConfig(warmup_steps=0))
    assert m.weight.dtype == torch.bfloat16


def test_int8_quantization_matches_reference():
    x = np.linspace(-5, 5, 101).astype(np.float32)
    x[7] = 0.5 * 5 / 127 * 3          # exactly half-way codes
    rq, rs = RGC.quantize_int8(jnp.asarray(x))
    tq, ts = TGC.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(ts), float(rs), rtol=1e-7)
    dq = TGC.dequantize_int8(tq, ts)
    np.testing.assert_allclose(dq.numpy(), x, atol=float(ts) + 1e-6)


def test_compress_decompress_matches_reference():
    g, e = _tree(3), _tree(4)
    e = {k: 0.01 * v for k, v in e.items()}
    rg, re_ = RGC.compress_decompress(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in e.items()})
    tg, te = TGC.compress_decompress(_t(g), _t(e))
    for k in g:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(rg[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(te[k].numpy(), np.asarray(re_[k]),
                                   rtol=1e-5, atol=1e-7)


def test_error_feedback_reduces_bias():
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=32).astype(np.float32) * 0.01
             for _ in range(50)]
    ef = {"g": torch.zeros(32)}
    total = np.zeros(32)
    for g in grads:
        cg, ef = TGC.compress_decompress({"g": torch.from_numpy(g)}, ef)
        total += cg["g"].numpy()
    resid = np.abs(total - np.sum(grads, axis=0)).max()
    assert resid <= np.abs(ef["g"].numpy()).max() + 1e-6 + 1e-4
