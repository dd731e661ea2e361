"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
reference's single-device path (``_moe_gspmd``), on the CPU in fp32.

Weights come from the reference's ``init_moe`` and inputs from numpy, so
both packages route the very same tokens. Routing is discrete: the port
must pick the same top-k experts, rank them in the same token-major order
and drop the same (token, expert) pairs when capacity is tight, exactly;
the outputs then agree to atol 1e-5 (the expert products sum in another
order) and the load-balancing loss to 1e-6.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.models import moe as RM
from repro_torch.models import moe as TM

ATOL = 1e-5
AUX_ATOL = 1e-6


def _cfgs(**kw):
    d = dict(d_model=16, d_ff=32, num_experts=4, experts_per_token=2,
             capacity_factor=8.0)
    d.update(kw)
    return RM.MoEConfig(**d), TM.MoEConfig(**d)


def _weights(rcfg, seed=0):
    tree = jax.tree_util.tree_map(
        np.array, RM.init_moe(jax.random.PRNGKey(seed), rcfg))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            {k: torch.as_tensor(v) for k, v in tree.items()})


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _dropped(flat_e, keep, k):
    """{(token, expert)} of the entries past capacity, from a dispatch's
    ``flat_e`` and ``keep`` and the k of its routing."""
    flat_e, keep = np.asarray(flat_e), np.asarray(keep)
    return {(i // k, int(flat_e[i])) for i in np.flatnonzero(~keep)}


def _routes(jp, tp, rcfg, tcfg, x):
    n = x.shape[0] * x.shape[1]
    xt = x.reshape(n, -1)
    c = TM.capacity(n, tcfg)
    k = tcfg.experts_per_token
    _, jtp, jte = RM._router(jp, rcfg, jnp.asarray(xt))
    _, (jfe, _, jkeep, _) = jax.jit(RM._local_dispatch, static_argnums=(
        3, 4))(jnp.asarray(xt), jte, jtp, rcfg.num_experts, c)
    _, ttp, tte = TM._router(tp, tcfg, torch.as_tensor(xt))
    _, (tfe, _, tkeep, _) = TM._local_dispatch(
        torch.as_tensor(xt), tte, ttp, tcfg.num_experts, c)
    np.testing.assert_array_equal(tte.numpy(), np.asarray(jte))
    return _dropped(tfe, tkeep, k), _dropped(jfe, jkeep, k)


@pytest.mark.parametrize("cfg_kw", [
    dict(num_experts=4, experts_per_token=2, capacity_factor=1.25),
    dict(num_experts=64, experts_per_token=8, capacity_factor=1.25),
    dict(num_experts=16, experts_per_token=2, capacity_factor=1.25),
    dict(num_experts=64, experts_per_token=6, capacity_factor=16.0),
    dict(num_experts=4, experts_per_token=2, capacity_factor=0.1)],
    ids=["e4k2", "olmoe", "jamba", "moonshot_drop_free", "tight"])
def test_capacity_equals_the_reference(cfg_kw):
    rcfg, tcfg = _cfgs(**cfg_kw)
    got = [TM.capacity(n, tcfg) for n in range(1, 301)]
    assert got == [RM.capacity(n, rcfg) for n in range(1, 301)]
    assert all(c % 4 == 0 and c >= 4 for c in got)


@pytest.mark.parametrize("factor", [8.0, 0.1], ids=["drop_free", "tight"])
def test_moe_matches_the_reference(factor):
    rcfg, tcfg = _cfgs(capacity_factor=factor)
    jp, tp = _weights(rcfg)
    x = _x((2, 24, rcfg.d_model), seed=1)
    want_y, want_aux = jax.jit(RM._moe_gspmd, static_argnums=1)(
        jp, rcfg, jnp.asarray(x))
    got_y, got_aux = TM.moe(tp, tcfg, torch.as_tensor(x))
    assert got_y.shape == x.shape and got_y.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0,
                               atol=ATOL)
    assert got_aux.dtype == torch.float32 and got_aux.dim() == 0
    assert abs(float(got_aux) - float(want_aux)) <= AUX_ATOL
    got_drop, want_drop = _routes(jp, tp, rcfg, tcfg, x)
    assert got_drop == want_drop
    if factor < 1:
        assert len(got_drop) > 0
        # a token whose every entry was dropped comes out as zeros
        gone = {t for t, _ in got_drop
                if sum(1 for u, _ in got_drop if u == t) == 2}
        for t in gone:
            assert not np.any(got_y.numpy().reshape(-1, rcfg.d_model)[t])
    else:
        assert got_drop == set()


def _dense_oracle(params, cfg, x):
    """Dense (no-capacity) MoE in float64: every token reaches its top-k
    experts (tests/test_moe.py's oracle, on the port's weights)."""
    n, d = x.shape
    p = {k: v.numpy().astype(np.float64) for k, v in params.items()}
    logits = x.astype(np.float64) @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    k = cfg.experts_per_token
    out = np.zeros((n, d))
    for t in range(n):
        top = np.argsort(-probs[t])[:k]
        pt = probs[t][top] / probs[t][top].sum()
        for e, pe in zip(top, pt):
            h = x[t].astype(np.float64)
            g = h @ p["expert_gate"][e]
            out[t] += pe * (((g / (1 + np.exp(-g))) * (h @ p["expert_up"][e]))
                            @ p["expert_down"][e])
    return out


def test_moe_matches_the_dense_oracle_drop_free():
    rcfg, tcfg = _cfgs()
    _, tp = _weights(rcfg)
    x = _x((1, 12, rcfg.d_model), seed=2)
    y, _ = TM.moe(tp, tcfg, torch.as_tensor(x))
    np.testing.assert_allclose(y[0].numpy().astype(np.float64),
                               _dense_oracle(tp, tcfg, x[0]), rtol=1e-4,
                               atol=1e-5)


def test_a_dropped_entry_that_collides_with_a_kept_one_adds_nothing():
    """Every token routed to expert 0 (k = 1) with capacity 4: tokens 0-3
    fill ranks 0-3, every later token is clamped onto rank 3, the slot of
    kept token 3. The scatter must add zeros there: token 3 keeps its
    drop-free output (an overwriting scatter would zero it), the dropped
    tokens come out as zeros, and both packages agree."""
    rcfg, tcfg = _cfgs(num_experts=2, experts_per_token=1,
                       capacity_factor=0.1)
    jp, tp = _weights(rcfg, seed=3)
    router = np.zeros((rcfg.d_model, 2), np.float32)
    router[:, 0] = 10.0
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.as_tensor(router))
    x = np.abs(_x((1, 16, rcfg.d_model), seed=4))   # logits of 10 * sum|x|
    assert TM.capacity(16, tcfg) == 4
    got, _ = TM.moe(tp, tcfg, torch.as_tensor(x))
    free, _ = TM.moe(tp, _cfgs(num_experts=2, experts_per_token=1)[1],
                     torch.as_tensor(x))
    got, free = got[0].numpy(), free[0].numpy()
    np.testing.assert_allclose(got[:4], free[:4], rtol=0, atol=ATOL)
    assert np.abs(got[3]).max() > 1e-2
    assert not np.any(got[4:])
    want, _ = RM._moe_gspmd(jp, rcfg, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want[0]), rtol=0, atol=ATOL)
    got_drop, want_drop = _routes(jp, tp, rcfg, tcfg, x)
    assert got_drop == want_drop == {(t, 0) for t in range(4, 16)}


def test_aux_loss_penalizes_imbalance_as_the_reference_does():
    rcfg, tcfg = _cfgs(num_experts=2, experts_per_token=1)
    jp, tp = _weights(rcfg, seed=2)
    x = np.abs(_x((1, 32, rcfg.d_model), seed=3))  # all to expert 0 skewed
    router = np.zeros((rcfg.d_model, 2), np.float32)
    router[:, 0] = 10.0
    auxes = {}
    for name, r in (("balanced", None), ("skewed", router)):
        jpp = jp if r is None else dict(jp, router=jnp.asarray(r))
        tpp = tp if r is None else dict(tp, router=torch.as_tensor(r))
        _, want = RM._moe_gspmd(jpp, rcfg, jnp.asarray(x))
        _, got = TM.moe(tpp, tcfg, torch.as_tensor(x))
        assert abs(float(got) - float(want)) <= AUX_ATOL, name
        auxes[name] = float(got)
    assert auxes["skewed"] > auxes["balanced"]
    # everything on expert 0: me = ce = (1, 0), aux = 0.01 * 2 * 1
    assert auxes["skewed"] == pytest.approx(0.02, abs=AUX_ATOL)


def test_capacity_is_shared_across_the_batch():
    """Capacity comes from B*S tokens: a row's drops depend on the other
    rows, as in the reference (the scheduler's pool rows compete)."""
    rcfg, tcfg = _cfgs(capacity_factor=0.5)
    jp, tp = _weights(rcfg, seed=5)
    x = _x((3, 8, rcfg.d_model), seed=6)
    both, _ = TM.moe(tp, tcfg, torch.as_tensor(x))
    alone, _ = TM.moe(tp, tcfg, torch.as_tensor(x[1:2]))
    want, _ = RM._moe_gspmd(jp, rcfg, jnp.asarray(x))
    np.testing.assert_allclose(both.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert not np.allclose(both[1:2].numpy(), alone.numpy(), atol=1e-3)


def test_bf16_keeps_the_dtype_and_routes_in_fp32():
    rcfg, tcfg = _cfgs(capacity_factor=1.25)
    _, tp = _weights(rcfg, seed=7)
    x = torch.as_tensor(_x((2, 16, rcfg.d_model), seed=8))
    y16, aux16 = TM.moe(tp, tcfg, x.to(torch.bfloat16))
    assert y16.dtype == torch.bfloat16 and aux16.dtype == torch.float32
    y32, _ = TM.moe(tp, tcfg, x.to(torch.bfloat16).to(torch.float32))
    scale = float(y32.abs().max())
    assert float((y16.float() - y32).abs().max()) <= 3e-2 * scale
