"""The port's slot pool (``repro_torch.serve.slots``, contiguous backing)
against the JAX reference's SlotManager on the CPU, fp32 reduced models.

Pool layout and reset state equal the reference's leaf for leaf. A pooled
chunk over a sub-batch of slots leaves logits and caches within 1e-4 of the
reference's (absolute and relative; the RWKV chunk scans sum in another
order; attention k/v rounded to bf16 agree to one bf16 ulp). Gather,
scatter and reset are exact. Free slots run in every pooled decode at
position 0 and a live slot past ``cache_slots`` wraps its ring: every write
stays in bounds (PyTorch raises on an out-of-range index where JAX clamps).
The sub-batches that reach ``kernels.ssm_scan`` are contiguous, as the
kernel's wrapper demands on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RC
from repro.models import transformer as RT
from repro.serve import slots as RSL
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.kernels import ssm_scan as TK
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serve import Scheduler, SchedulerConfig, SlotManager, generate
from repro_torch.serve import slots as TSL

ARCHS = ["gemma-2b", "rwkv6-1.6b", "gemma3-12b"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _jleaves(tree):
    """The reference's cache tree in the port's leaf order (KVCache fields
    k, v, pos; dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _jleaves(tree[k])]
    if hasattr(tree, "_fields"):
        return [x for t in tree for x in _jleaves(t)]
    return [np.asarray(tree)]


@pytest.fixture(scope="module")
def model():
    """``model(arch)``: (reference config, port config, JAX params, port
    params) of the reduced fp32 ``arch``, one set of weights from
    ``PRNGKey(0)`` for both packages, built once per module."""
    built = {}

    def get(arch):
        if arch not in built:
            rcfg = dataclasses.replace(RC.reduced_config(arch),
                                       dtype=jnp.float32)
            tcfg = dataclasses.replace(TC.reduced_config(arch),
                                       dtype=torch.float32)
            tree = jax.tree_util.tree_map(
                np.array, RT.init_model(jax.random.PRNGKey(0), rcfg))
            built[arch] = (rcfg, tcfg,
                           jax.tree_util.tree_map(jnp.asarray, tree),
                           convert.params_from_numpy(tcfg, tree,
                                                     device="cpu"))
        return built[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_pool_layout_equals_the_reference(arch, model):
    rcfg, tcfg, _, _ = model(arch)
    want = RSL.SlotManager(rcfg, num_slots=3, cache_slots=24)
    got = SlotManager(tcfg, num_slots=3, cache_slots=24, device="cpu")
    wl, gl = _jleaves(want.caches), _leaves(got.caches)
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.float().numpy(),
                                      w.astype(np.float32))
    assert got.metrics() == want.metrics()
    assert got.total_rows == want.total_rows
    assert got.stats()["allocator"] == "contiguous"


def test_alloc_release_reset(model):
    _, tcfg, _, _ = model("rwkv6-1.6b")
    sm = SlotManager(tcfg, num_slots=3, cache_slots=16, device="cpu")
    a = sm.alloc(owner=10)
    b = sm.alloc(owner=11)
    assert {a, b} == {0, 1} and sm.free_count == 1
    assert sm.valid[a] and sm.owner[b] == 11 and sm.live == [0, 1]
    # dirty slot a, release, realloc: its rows are zeroed again
    dirty = TSL._tree_map(lambda l: l + 1, sm.gather([a]))
    sm.scatter(dirty, [a])
    assert all(bool((x[:, a] != 0).all()) for x in _leaves(sm.caches))
    sm.release(a)
    assert not sm.valid[a] and sm.free_count == 2 and sm.owner[a] is None
    with pytest.raises(RuntimeError, match="not live"):
        sm.release(a)
    # released rows keep their stale values until the next alloc
    assert all(bool((x[:, a] != 0).all()) for x in _leaves(sm.caches))
    a2 = sm.alloc(owner=12)
    assert a2 == a                      # LIFO free list reuses the slot
    zeros = TT.init_caches(tcfg, 1, 16, per_slot_pos=True, device="cpu")
    for x, z in zip(_leaves(sm.gather([a2])), _leaves(zeros)):
        assert torch.equal(x, z)
    assert sm.alloc(owner=13) == 2 and sm.alloc(owner=14) is None


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma3-12b"])
def test_gather_scatter_roundtrip(arch, model):
    _, tcfg, _, _ = model(arch)
    sm = SlotManager(tcfg, num_slots=4, cache_slots=8, device="cpu")
    ref = [x.clone() for x in _leaves(sm.caches)]
    sub = sm.gather([3, 1])
    assert all(x.is_contiguous() and x.shape[1] == 2 for x in _leaves(sub))
    marked = TSL._tree_map(lambda l: l + 2, sub)
    sm.scatter(marked, [3, 1])
    for g, r in zip(_leaves(sm.caches), ref):
        assert torch.equal(g[:, [0, 2]], r[:, [0, 2]])
        assert torch.equal(g[:, [1, 3]], r[:, [1, 3]] + 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_pooled_chunk_matches_the_reference(arch, model):
    """One chunk over slots [2, 0] of a pool of 3, after a first chunk over
    slot 0 alone: the port's run_chunk against the reference's."""
    rcfg, tcfg, jparams, tparams = model(arch)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, rcfg.vocab, (2, 8)).astype(np.int32)
    first = rng.integers(0, rcfg.vocab, (1, 8)).astype(np.int32)
    want = RSL.SlotManager(rcfg, num_slots=3, cache_slots=24)
    got = SlotManager(tcfg, num_slots=3, cache_slots=24, device="cpu")
    for s in range(3):
        want.alloc(owner=s)
        got.alloc(owner=s)
    want.run_chunk(jparams, [0], first, np.zeros(1, np.int32))
    got.run_chunk(tparams, [0], torch.as_tensor(first, dtype=torch.int64),
                  torch.zeros(1, dtype=torch.int64))
    pos = np.asarray([0, 8], np.int32)
    wl = want.run_chunk(jparams, [2, 0], toks, pos)
    gl = got.run_chunk(tparams, [2, 0], torch.as_tensor(toks).long(),
                       torch.as_tensor(pos).long())
    assert tuple(gl.shape) == (2, 8, rcfg.vocab)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-4,
                               atol=1e-4)
    for w, g in zip(_jleaves(want.caches), _leaves(got.caches)):
        ulp = 2.0 ** -7 if g.dtype == torch.bfloat16 else 0.0
        g, w = g.float().numpy(), w.astype(np.float32)
        assert np.all(np.abs(g - w) <= 1e-4 + (1e-4 + ulp) * np.abs(w))


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma3-12b", "rwkv6-1.6b"])
def test_free_slots_in_the_pooled_decode_stay_in_bounds(arch, model):
    """One live slot decoding at cache_slots - 1 and past it (the ring
    wraps), free slots beside it at position 0 as the scheduler feeds them:
    every write is in bounds, the live row's ring holds the newest
    positions, and its logits equal a pool of one."""
    _, tcfg, _, tparams = model(arch)
    slots = 8
    sm = SlotManager(tcfg, num_slots=3, cache_slots=slots, device="cpu")
    one = SlotManager(tcfg, num_slots=1, cache_slots=slots, device="cpu")
    live = sm.alloc(owner=0)
    one.alloc(owner=0)
    rng = np.random.default_rng(4)
    zeros = torch.zeros(3)
    for p in range(slots + 5):
        tok = int(rng.integers(0, tcfg.vocab))
        toks = torch.zeros((3, 1), dtype=torch.int64)
        toks[live, 0] = tok
        pos = torch.zeros(3, dtype=torch.int64)
        pos[live] = p
        nxt, lg = sm.run_decode(tparams, toks, pos, zeros, None)
        n1, l1 = one.run_decode(tparams, toks[live:live + 1],
                                pos[live:live + 1], zeros[:1], None)
        assert tuple(lg.shape) == (3, 1, tcfg.vocab)
        assert bool(torch.isfinite(lg).all())
        torch.testing.assert_close(lg[live], l1[0], rtol=1e-5, atol=1e-5)
    for i, spec in enumerate(tcfg.pattern):
        if spec.mixer != "attn":
            continue
        kv = sm.caches[f"p{i}"]["attn"]
        assert isinstance(kv, TA.KVCache)
        ring = kv.pos.shape[-1]
        newest = sorted(kv.pos[0, live].tolist())
        assert newest == list(range(slots + 5 - ring, slots + 5))
        free = [s for s in range(3) if s != live]
        assert kv.pos[0, free, 0].tolist() == [0, 0]   # junk at position 0


def test_scheduler_fills_the_cache_with_free_slots_beside(model):
    """Requests that end exactly at max_len run beside free slots."""
    _, tcfg, _, tparams = model("gemma3-12b")
    sc = SchedulerConfig(num_slots=3, max_len=24, prefill_chunk=8,
                         cache_requests=False)
    sched = Scheduler(tcfg, tparams, sc)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab, ln).astype(np.int32)
               for ln in (18, 20)]
    rids = sched.submit(prompts[:1], max_new_tokens=6)
    rids += sched.submit(prompts[1:], max_new_tokens=4)
    done = {c.rid: c for c in sched.drain()}
    for rid, p, n in zip(rids, prompts, (6, 4)):
        want, reason = generate(tparams, tcfg, p, n, prefill_chunk=8,
                                cache_slots=24)
        assert done[rid].tokens.tolist() == want.tolist()
        assert done[rid].reason == reason == "length"


def test_chunks_hand_ssm_scan_contiguous_sub_batches(monkeypatch, model):
    """Pooled chunks over sub-batches of 1 and 2 slots out of 4: every
    tensor that reaches kernels.ssm_scan is contiguous, and there are
    num_layers calls per chunk step."""
    _, tcfg, _, tparams = model("rwkv6-1.6b")
    seen = []

    def spy(*args):
        seen.append(args)
        return TK.ssm_scan_plain(*args)

    monkeypatch.setattr(TK, "ssm_scan", spy)
    sched = Scheduler(tcfg, tparams, SchedulerConfig(
        num_slots=4, max_len=48, prefill_chunk=8, cache_requests=False))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, tcfg.vocab, ln).astype(np.int32)
               for ln in (26, 10, 3, 17)]
    sched.submit(prompts, max_new_tokens=3)
    sched.drain()
    assert sched.counters["chunk_steps"] == 3      # widths 3, 2, 1
    assert len(seen) == tcfg.num_layers * 3
    widths = sorted({args[0].shape[0] for args in seen})
    h = tcfg.d_model // tcfg.rwkv_head_dim
    assert widths == [h, 2 * h, 3 * h]
    for r, w, k, v, u, s0 in seen:
        for x in (r, w, k, v, s0):
            assert x.is_contiguous() and x.dtype == torch.float32
