"""The port's sharded paged pool under the scheduler
(``SchedulerConfig(mesh_shards=n)``) against the port's unsharded pool and
the JAX reference's sharded Scheduler on the CPU, on reduced gemma-2b and
gemma3-12b (a window ring group beside the global group), in fp32 with
one set of weights through ``convert.params_from_numpy``. RWKV-6 (zero
page-table groups) is held to the reference in
``tests/test_torch_sharded_steps.py``.

The cases are the reference's own (``tests/test_sharded.py``): at one
shard the pool is bitwise the unsharded one, sampled streams included; at
2 and 4 shards greedy streams equal the unsharded run's and the
reference's sharded run's, through forced swap, prefix sharing, window
rings and speculation; score rows are bitwise the unsharded port's and
within rtol / atol 1e-5 of the reference's; placement, stealing, migration
counters and the ``serve.shard`` gauges equal the reference's. The
reference's hypothesis variant of the invariant checks is not ported (it
draws infeasible requests now and then); the seeded traces are.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RC
from repro.models import transformer as RT
from repro.serve import Scheduler as JScheduler
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.launch.mesh import WorkerMesh
from repro_torch.obs import schema
from repro_torch.serve import Scheduler, SchedulerConfig

_LENS = [3, 17, 9, 24, 5, 12]
_MNTS = [6, 4, 8, 5, 7, 3]
_BASE = dict(num_slots=4, max_len=64, prefill_chunk=8, allocator="paged",
             block_size=8, num_blocks=24, eos_token=5, cache_requests=False)
COUNTER_KEYS = ("admitted", "preempted", "chunk_steps", "decode_steps",
                "prefill_tokens", "generated_tokens", "swapped_in",
                "swapped_out", "recomputed_decode_steps",
                "prefix_shared_tokens", "steals")
SWAP_KEYS = ("swapped_held", "swap_bytes_held", "swap_bytes_out",
             "swap_bytes_in", "swap_rejected", "swap_migrated_out",
             "swap_migrated_in", "blocks_used", "blocks_total", "num_shards")


@pytest.fixture(scope="module")
def model():
    """``model(arch)``: (reference config, port config, JAX params, port
    params) of the reduced fp32 ``arch``, one set of weights for both."""
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


def _prompts(vocab, lens, seed=1, prefix=0):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    if prefix:
        shared = rng.integers(0, vocab, prefix).astype(np.int32)
        out = [np.concatenate([shared, p]) for p in out]
    return out


def _run(sched, prompts, mnts, placement_fn=None):
    """The reference's staggered trace (submit, step) then drain; returns
    [(tokens, reason)] in submission order, and the scheduler."""
    sched.placement_fn = placement_fn
    rids = []
    for p, m in zip(prompts, mnts):
        rids += sched.submit([p], max_new_tokens=m)
        sched.step()
    sched.drain()
    return [(list(map(int, sched.results[r].tokens)),
             sched.results[r].reason) for r in rids], sched


def _port(model, arch, prompts, mnts, mesh=None, placement_fn=None, **kw):
    _, tcfg, _, tparams = model(arch)
    return _run(Scheduler(tcfg, tparams,
                          SchedulerConfig(**{**_BASE, **kw}), mesh=mesh),
                prompts, mnts, placement_fn)


def _ref(model, arch, prompts, mnts, placement_fn=None, **kw):
    rcfg, _, jparams, _ = model(arch)
    return _run(JScheduler(rcfg, jparams,
                           JSchedulerConfig(**{**_BASE, **kw})),
                prompts, mnts, placement_fn)


def _same_control(a, b, keys=COUNTER_KEYS):
    for k in keys:
        assert a.counters[k] == b.counters[k], k


def _cpu_mesh(n):
    return WorkerMesh((torch.device("cpu"),) * n, ("slots",))


@pytest.mark.parametrize("mesh", [None, 1], ids=["stacked", "cpu_mesh"])
def test_mesh1_bit_identical_to_unsharded(model, mesh):
    """At one shard (stacked, or on a mesh of one device) the pool runs the
    unsharded step on the same slots: streams, reasons and control
    counters equal the unsharded scheduler's."""
    prompts = _prompts(128, _LENS)
    a, sa = _port(model, "gemma-2b", prompts, _MNTS)
    b, sb = _port(model, "gemma-2b", prompts, _MNTS, mesh_shards=1,
                  mesh=None if mesh is None else _cpu_mesh(1))
    assert a == b
    _same_control(sa, sb)
    assert sb.slots.num_shards == 1 and sb._shard_placed == [6]


def test_mesh1_bit_identical_with_sampling(model):
    """At one shard a sampled tick draws from the scheduler's generator
    unchanged, so sampled streams are bitwise the unsharded ones."""
    prompts = _prompts(128, _LENS[:4])
    kw = dict(temperature=0.8, top_k=8, seed=3)
    a, _ = _port(model, "gemma-2b", prompts, _MNTS[:4], **kw)
    b, _ = _port(model, "gemma-2b", prompts, _MNTS[:4], mesh_shards=1, **kw)
    assert a == b


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_tokens_match_unsharded_and_the_reference(model, n):
    """Equal total blocks split over n shards: greedy streams equal the
    unsharded run's and the reference's sharded run's; so do placements,
    steals and the control counters."""
    prompts = _prompts(128, _LENS)
    a, _ = _port(model, "gemma-2b", prompts, _MNTS)
    kw = dict(mesh_shards=n, num_blocks=24 // n)
    b, sb = _port(model, "gemma-2b", prompts, _MNTS, **kw)
    c, sc = _ref(model, "gemma-2b", prompts, _MNTS, **kw)
    assert a == b == c
    assert sb.slots.num_shards == n
    assert sb._shard_placed == sc._shard_placed
    assert sb._shard_steals == sc._shard_steals
    _same_control(sb, sc)


def test_sharded_forced_swap_matches_oracle(model):
    """Per-shard pools small enough that decode growth preempts under
    preempt='swap': streams equal the unsharded swap run's, and the swap
    and migration counters equal the reference's."""
    prompts = _prompts(128, _LENS)
    mnts = [20, 16, 20, 12, 18, 14]
    a, sa = _port(model, "gemma-2b", prompts, mnts, num_blocks=10,
                  preempt="swap")
    kw = dict(mesh_shards=2, num_blocks=5, preempt="swap")
    b, sb = _port(model, "gemma-2b", prompts, mnts, **kw)
    c, sc = _ref(model, "gemma-2b", prompts, mnts, **kw)
    assert sa.counters["swapped_out"] > 0 and sb.counters["swapped_out"] > 0
    assert [t for t, _ in a] == [t for t, _ in b] == [t for t, _ in c]
    _same_control(sb, sc)
    st, rst = sb.stats(), sc.stats()
    for k in SWAP_KEYS:
        assert st[k] == rst[k], k
    assert st["swap_migrated_in"] == st["swap_migrated_out"]


def test_sharded_prefix_sharing_matches_oracle(model):
    """Prefix sharing stays inside a shard: requests pinned to the shard
    holding the prefix hit the index, and streams equal the unshared
    oracle's and the reference's; the sharing counters equal its."""
    prompts = _prompts(128, [5, 7, 9, 6], prefix=16)
    mnts = [4, 4, 4, 4]
    a, _ = _port(model, "gemma-2b", prompts, mnts)
    kw = dict(prefix_sharing=True, mesh_shards=2, num_blocks=12)
    b, sb = _port(model, "gemma-2b", prompts, mnts,
                  placement_fn=lambda sched, st: 0, **kw)
    c, sc = _ref(model, "gemma-2b", prompts, mnts,
                 placement_fn=lambda sched, st: 0, **kw)
    assert sb.counters["prefix_shared_tokens"] > 0
    assert a == b == c
    _same_control(sb, sc)
    st, rst = sb.stats(), sc.stats()
    for k in ("shared_blocks", "cow_copies", "prefix_shared_chunks",
              "prefix_entries", "prefix_hit_chunks", "prefix_published"):
        assert st[k] == rst[k], k


def test_sharded_windowed_rings_match_oracle(model):
    """Two page-table groups a shard (ring and global KV): streams equal
    the unsharded pool's and the reference's."""
    prompts = _prompts(128, _LENS)
    a, _ = _port(model, "gemma3-12b", prompts, _MNTS, block_size=4,
                 num_blocks=48)
    kw = dict(block_size=4, mesh_shards=2, num_blocks=24)
    b, sb = _port(model, "gemma3-12b", prompts, _MNTS, **kw)
    c, sc = _ref(model, "gemma3-12b", prompts, _MNTS, **kw)
    assert a == b == c
    assert sb.stats()["page_groups"] == 2
    _same_control(sb, sc)


def test_sharded_speculative_matches_oracle(model):
    """speculate=2 over two shards: greedy streams equal the unsharded
    speculative run's and the reference's sharded speculative run's."""
    prompts = _prompts(128, _LENS[:4])
    a, _ = _port(model, "gemma-2b", prompts, _MNTS[:4], speculate=2)
    kw = dict(speculate=2, mesh_shards=2, num_blocks=12)
    b, sb = _port(model, "gemma-2b", prompts, _MNTS[:4], **kw)
    c, sc = _ref(model, "gemma-2b", prompts, _MNTS[:4], **kw)
    assert a == b == c
    _same_control(sb, sc, COUNTER_KEYS + ("spec.drafted_tokens",
                                          "spec.accepted_tokens"))


def test_sharded_score_rows_match_oracle(model):
    """Scoring rides the chunk path: per-token logprobs from two shards
    equal the unsharded port's bitwise (chunk logits come back in input
    order) and the reference's at rtol 1e-5 / atol 1e-5, the tolerance of
    the unsharded score tests (``tests/test_torch_scheduler.py``)."""
    prompts = _prompts(128, [19, 25, 10])
    rcfg, tcfg, jparams, tparams = model("gemma-2b")

    def score(sched):
        rids = sched.score(prompts)
        sched.drain()
        return [np.asarray(sched.results[r].logprobs) for r in rids]

    sharded = dict(_BASE, mesh_shards=2, num_blocks=12)
    a = score(Scheduler(tcfg, tparams, SchedulerConfig(**_BASE)))
    b = score(Scheduler(tcfg, tparams, SchedulerConfig(**sharded)))
    c = score(JScheduler(rcfg, jparams, JSchedulerConfig(**sharded)))
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(y, z, rtol=1e-5, atol=1e-5)


def test_placement_round_robin_and_pluggable(model):
    """round_robin alternates the queues; a placement_fn pins every
    request; queue lengths and per-shard placements equal the
    reference's."""
    rcfg, tcfg, jparams, tparams = model("gemma-2b")
    kw = dict(_BASE, mesh_shards=2, num_blocks=12, placement="round_robin")
    prompts = _prompts(128, [4, 4, 4, 4])
    for fn, queued in ((None, [2, 2]), (lambda sched, st: 1, [0, 4])):
        got = []
        for sched in (Scheduler(tcfg, tparams, SchedulerConfig(**kw)),
                      JScheduler(rcfg, jparams, JSchedulerConfig(**kw))):
            sched.placement_fn = fn
            for p in prompts:
                sched.submit([p], max_new_tokens=2)
            assert [len(q) for q in sched._queues] == queued
            sched.drain()
            got.append(list(sched._shard_placed))
        assert got[0] == got[1]
    assert got[0] == [0, 4]
    with pytest.raises(ValueError, match="placement_fn returned shard 2"):
        s = Scheduler(tcfg, tparams, SchedulerConfig(**kw))
        s.placement_fn = lambda sched, st: 2
        s.submit([prompts[0]], max_new_tokens=2)


@pytest.mark.parametrize("steal", [True, False])
def test_steal_rebalance_beats_head_of_line(model, steal):
    """Arrivals skewed onto shard 0 of a 2 x 1-slot pool: with stealing
    the second head moves to the idle shard and both decode at once;
    without it the head blocks (the control). Equal to the reference."""
    rcfg, tcfg, jparams, tparams = model("gemma-2b")
    kw = dict(_BASE, num_slots=2, mesh_shards=2, num_blocks=12,
              max_new_tokens=24, steal=steal)
    prompts = _prompts(128, [8, 8])
    seen = []
    for sched in (Scheduler(tcfg, tparams, SchedulerConfig(**kw)),
                  JScheduler(rcfg, jparams, JSchedulerConfig(**kw))):
        sched.placement_fn = lambda sched, st: 0
        sched.submit([prompts[0]], max_new_tokens=24)
        sched.step()
        sched.submit([prompts[1]], max_new_tokens=24)
        sched.step()
        seen.append((sched.counters["steals"], sched.live,
                     list(sched._shard_steals)))
        sched.drain()
    assert seen[0] == seen[1]
    assert seen[0][:2] == ((1, 2) if steal else (0, 1))


def test_steal_swapped_preserves_prefill_progress(model):
    """A swap-preempted request stolen to another shard moves its host
    swap entry and resumes at its saved position: streams equal the
    unsharded swap oracle's, and steals and migration counters the
    reference's."""
    prompts = _prompts(128, [20, 20, 8])
    mnts = [12, 12, 6]
    a, _ = _port(model, "gemma-2b", prompts, mnts, num_slots=2,
                 num_blocks=8, preempt="swap")
    kw = dict(num_slots=4, mesh_shards=2, num_blocks=4, preempt="swap")
    pin = lambda sched, st: 0       # noqa: E731 (every arrival on shard 0)
    b, sb = _port(model, "gemma-2b", prompts, mnts, placement_fn=pin, **kw)
    c, sc = _ref(model, "gemma-2b", prompts, mnts, placement_fn=pin, **kw)
    assert [t for t, _ in a] == [t for t, _ in b] == [t for t, _ in c]
    _same_control(sb, sc)
    st, rst = sb.stats(), sc.stats()
    for k in SWAP_KEYS:
        assert st[k] == rst[k], k
    assert st["swap_migrated_in"] == st["swap_migrated_out"]


def test_shard_metrics_equal_the_reference(model):
    """The ``serve.shard`` provider's snapshot equals the reference's key
    by key, passes ``validate_shard_metrics``, and stats() passes the
    scheduler and paging schemas."""
    prompts = _prompts(128, _LENS[:3])
    kw = dict(mesh_shards=2, num_blocks=12)
    _, sb = _port(model, "gemma-2b", prompts, _MNTS[:3], **kw)
    _, sc = _ref(model, "gemma-2b", prompts, _MNTS[:3], **kw)
    got, want = sb._shard_obs.metrics(), sc._shard_obs.metrics()
    assert got == want
    assert schema.validate_shard_metrics(got, 2) == []
    assert schema.validate_stats(sb.stats(), schema.SCHEDULER_STATS) == []
    assert schema.validate_stats(sb.stats(), schema.PAGED_STATS) == []
    assert sum(got[f"shard{i}.placed"] for i in range(2)) == 3
    assert Scheduler(model("gemma-2b")[1], model("gemma-2b")[3],
                     SchedulerConfig(**_BASE))._shard_obs is None


def _check_shard_invariants(s):
    """Every request lives in exactly one place (a slot of its home shard,
    its home queue, a swap entry on its home shard's store only), and each
    shard's block accounting closes: free + mapped + index-held == total
    in every group."""
    sm = s.slots
    owners = {}
    for slot, st in s._by_slot.items():
        assert sm.shard_of_slot(slot) == st.shard
        owners[st.rid] = owners.get(st.rid, 0) + 1
    for i, q in enumerate(s._queues):
        for st in q:
            assert st.shard == i
            owners[st.rid] = owners.get(st.rid, 0) + 1
            if sm.is_swapped(st.rid):
                held = [j for j, sh in enumerate(sm.backing.shards)
                        if st.rid in sh.swaps]
                assert held == [i]
    assert all(v == 1 for v in owners.values()), owners
    for i, sh in enumerate(sm.backing.shards):
        holds = sh.prefix_holds()
        for vl, g in sh.groups.items():
            g.pt.check_invariants(holds[vl])
            free = g.pool.num_blocks - g.pool.used_count
            assert free == int(np.sum(~g.pool.allocated))
        assert sm.shard_free_blocks(i) == sum(
            g.pool.num_blocks - g.pool.used_count
            for g in sh.groups.values())


@pytest.mark.parametrize("preempt", ["recompute", "swap"])
def test_shard_invariants_seeded(model, preempt):
    """The reference's seeded random serving traces (seeds 0 and 1, two
    shards, random pools, placement, prefix sharing): the invariants hold
    after every step, and the drained pool holds no block but the prefix
    index's."""
    _, tcfg, _, tparams = model("gemma-2b")
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        sc = SchedulerConfig(**dict(
            _BASE, num_slots=4, mesh_shards=2,
            num_blocks=int(rng.integers(4, 9)), preempt=preempt,
            placement=str(rng.choice(["least_blocks", "round_robin"])),
            steal=True, prefix_sharing=bool(rng.integers(0, 2))))
        s = Scheduler(tcfg, tparams, sc)
        for _ in range(int(rng.integers(4, 10))):
            k = int(rng.integers(1, 3))
            lens = rng.integers(2, 28, size=k)
            s.submit([rng.integers(0, tcfg.vocab, ln).astype(np.int32)
                      for ln in lens],
                     max_new_tokens=int(rng.integers(1, 10)))
            for _ in range(int(rng.integers(0, 3))):
                s.step()
                _check_shard_invariants(s)
        s.drain()
        _check_shard_invariants(s)
        assert s.pending == 0 and s.live == 0
        for i, sh in enumerate(s.slots.backing.shards):
            total = sum(g.pool.num_blocks for g in sh.groups.values())
            held = sum(int(h.sum()) for h in sh.prefix_holds().values())
            assert s.slots.shard_free_blocks(i) + held == total
