"""The port's paged scheduler (``SchedulerConfig(allocator="paged")``) against
the port's contiguous scheduler and the JAX reference's paged Scheduler on
the CPU, on reduced gemma-2b, gemma3-12b (a window-16 ring group beside the
global group) and rwkv6-1.6b (no KV: zero page-table groups), in fp32 with
one set of weights through ``convert.params_from_numpy``.

The cases are the reference's own (``tests/test_scheduler.py``: paged vs
contiguous, reserved admission, the swap-budget fallback, shared
prefixes). Greedy streams and finish reasons are token for token the
contiguous run's and the reference's; the scheduler's preemption counters
and every block, copy-on-write, prefix and swap-byte count of ``stats()``
equal the reference's. The byte counts match exactly: the port's caches
have the reference's dtypes (bf16 k and v, int32 positions, fp32 RWKV
state), so no count differs by a dtype's width.
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
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import Scheduler, SchedulerConfig

# the paging and scheduler keys of stats() held equal to the reference's
PAGING_KEYS = (
    "page_groups", "blocks_total", "blocks_used", "blocks_free",
    "block_size", "block_utilization", "shared_blocks", "cow_copies",
    "prefix_shared_chunks", "prefix_entries", "prefix_lookups",
    "prefix_hit_chunks", "prefix_published", "prefix_evicted",
    "swapped_held", "swap_bytes_held", "swap_bytes_budget", "swap_rejected",
    "swap_bytes_out", "swap_bytes_in", "position_capacity", "total_rows")
COUNTER_KEYS = ("submitted", "admitted", "completed", "steps",
                "decode_steps", "chunk_steps", "generated_tokens",
                "prefill_tokens", "live_decode_slots", "preempted",
                "swapped_in", "swapped_out", "recomputed_decode_steps",
                "prefix_shared_tokens")

_TRACE = dict(lens=[3, 17, 9, 24, 5, 12], mnts=[6, 4, 8, 5, 7, 3], eos=5)


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


def _prompts(rng, vocab, lens):
    return [rng.integers(0, vocab, ln).astype(np.int32) for ln in lens]


def _shared_prefix_prompts(vocab, prefix_len, suffix_lens, seed=21):
    """Prompts sharing one system-prompt prefix, with their own suffixes."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len).astype(np.int32)
    return [np.concatenate([prefix,
                            rng.integers(0, vocab, n).astype(np.int32)])
            for n in suffix_lens]


def _run_trace(sched, prompts, mnts):
    """Replay the reference's staggered trace (one submission every other
    step, slots reused); returns {request index: (tokens, reason)}, each
    completion handed out once across step() and drain()."""
    rid2i, submitted, steps, done = {}, 0, 0, []
    while submitted < len(prompts) or sched.pending or sched.live:
        if submitted < len(prompts) and steps % 2 == 0:
            rid2i[sched.submit([prompts[submitted]],
                               max_new_tokens=mnts[submitted])[0]] = submitted
            submitted += 1
        done += sched.step()
        steps += 1
    done += sched.drain()
    assert len({c.rid for c in done}) == len(done) == len(prompts)
    return {rid2i[c.rid]: (c.tokens.tolist(), c.reason) for c in done}


def _three_ways(model, arch, prompts, mnts, eos, **kw):
    """The trace through the port's contiguous scheduler, the port's
    scheduler under ``kw`` and the reference's under ``kw``: (contiguous
    streams, port streams, port scheduler, reference scheduler), after
    checking that the two paged runs agree on streams, counters and
    paging stats."""
    rcfg, tcfg, jparams, tparams = model(arch)
    base = dict(num_slots=3, max_len=48, prefill_chunk=8, eos_token=eos,
                cache_requests=False)
    contiguous = _run_trace(Scheduler(tcfg, tparams,
                                      SchedulerConfig(**base)),
                            prompts, mnts)
    sched = Scheduler(tcfg, tparams, SchedulerConfig(**base, **kw))
    got = _run_trace(sched, prompts, mnts)
    ref = JScheduler(rcfg, jparams, JSchedulerConfig(**base, **kw))
    want = _run_trace(ref, prompts, mnts)
    assert got == want
    for k in COUNTER_KEYS:
        assert sched.counters[k] == ref.counters[k], k
    st, rst = sched.stats(), ref.stats()
    for k in PAGING_KEYS + tuple(k for k in rst if k.startswith("ring")):
        assert st[k] == rst[k], k
    return contiguous, got, sched, ref


@pytest.mark.parametrize("arch,block_size,num_blocks,num_window_blocks,"
                         "preempt", [
    ("gemma-2b", 8, None, None, "recompute"),
    ("gemma-2b", 8, 6, None, "recompute"),
    ("gemma-2b", 8, 6, None, "swap"),
    # window 16 over blocks of 2: 8 blocks per ring; under-provisioned
    # global and ring pools both run out during ramp-up
    ("gemma3-12b", 2, None, None, "recompute"),
    ("gemma3-12b", 2, 16, 9, "recompute"),
    ("gemma3-12b", 2, 16, 9, "swap"),
    # window 16 under a block of 24: the ring is one partial block
    ("gemma3-12b", 24, 3, None, "swap"),
])
def test_paged_matches_contiguous_and_the_reference(
        model, arch, block_size, num_blocks, num_window_blocks, preempt):
    """Equal memory (no preemption) and pools small enough that growth
    preempts, under recompute and swap; swap resumes every victim with no
    decode step recomputed, and retire frees every block."""
    rcfg = model(arch)[0]
    prompts = _prompts(np.random.default_rng(7), rcfg.vocab, _TRACE["lens"])
    contiguous, got, sched, _ = _three_ways(
        model, arch, prompts, _TRACE["mnts"], _TRACE["eos"],
        allocator="paged", block_size=block_size, num_blocks=num_blocks,
        num_window_blocks=num_window_blocks, preempt=preempt)
    assert got == contiguous
    c, st = sched.counters, sched.stats()
    if num_blocks is None:
        assert c["preempted"] == 0
    else:
        assert c["preempted"] >= 1
    if preempt == "swap":
        assert c["recomputed_decode_steps"] == 0
        assert c["swapped_in"] == c["swapped_out"] >= 1
        assert st["swap_bytes_in"] == st["swap_bytes_out"] > 0
        assert st["swapped_held"] == 0
    elif num_blocks is not None:
        assert c["recomputed_decode_steps"] >= 1
    assert st["blocks_used"] == 0
    if arch == "gemma3-12b":
        assert st["page_groups"] == 2 and "ring16_blocks_total" in st


def test_reserved_admission_never_preempts(model):
    """admission='reserved' books blocks for prompt + max_new: the pool
    that preempts under optimistic admission runs the trace with none."""
    rcfg = model("gemma-2b")[0]
    prompts = _prompts(np.random.default_rng(7), rcfg.vocab, _TRACE["lens"])
    contiguous, got, sched, _ = _three_ways(
        model, "gemma-2b", prompts, _TRACE["mnts"], _TRACE["eos"],
        allocator="paged", block_size=8, num_blocks=6, admission="reserved")
    assert got == contiguous
    assert sched.counters["preempted"] == 0
    assert sched.counters["recomputed_decode_steps"] == 0
    assert sched.stats()["blocks_used"] == 0


def test_swap_budget_rejection_falls_back_to_recompute(model):
    """A swap budget of 1 byte rejects every eviction: each victim is
    recomputed instead, the store counts the rejections, holds nothing."""
    rcfg = model("gemma3-12b")[0]
    prompts = _prompts(np.random.default_rng(7), rcfg.vocab, _TRACE["lens"])
    contiguous, got, sched, _ = _three_ways(
        model, "gemma3-12b", prompts, _TRACE["mnts"], _TRACE["eos"],
        allocator="paged", block_size=2, num_blocks=16,
        num_window_blocks=9, preempt="swap", swap_bytes_budget=1)
    assert got == contiguous
    c, st = sched.counters, sched.stats()
    assert c["swapped_out"] == 0
    assert c["preempted"] >= 1 and c["recomputed_decode_steps"] >= 1
    assert st["swap_rejected"] >= 1
    assert st["swap_bytes_held"] == 0 and st["swap_bytes_budget"] == 1


@pytest.mark.parametrize("arch,block_size,num_blocks,num_window_blocks,"
                         "preempt,prefix_len,suffix_lens,mnts", [
    ("gemma-2b", 8, None, None, "recompute", 24, [3, 6, 1, 5, 2],
     [4, 6, 3, 5, 4]),
    ("gemma-2b", 8, 8, None, "recompute", 24, [3, 6, 1, 5, 2],
     [4, 6, 3, 5, 4]),
    ("gemma-2b", 8, 8, None, "swap", 24, [3, 6, 1, 5, 2], [4, 6, 3, 5, 4]),
    # the ring group shares only when the whole span fits the window (16)
    ("gemma3-12b", 2, None, None, "recompute", 8, [2, 4, 1, 3],
     [4, 3, 5, 4]),
    ("gemma3-12b", 2, 20, 12, "swap", 8, [2, 4, 1, 3], [4, 3, 5, 4]),
])
def test_shared_prefix_streams_equal_unshared(
        model, arch, block_size, num_blocks, num_window_blocks, preempt,
        prefix_len, suffix_lens, mnts):
    """prefix_sharing=True maps shared chunks and is invisible in the
    streams: they equal the unshared run's (and the contiguous run's),
    through preemption by recompute and swap and through ring groups;
    copy-on-write copies and prefix counters equal the reference's, and
    flushing the index frees every block."""
    _, tcfg, _, tparams = model(arch)
    prompts = _shared_prefix_prompts(tcfg.vocab, prefix_len, suffix_lens)
    kw = dict(allocator="paged", block_size=block_size,
              num_blocks=num_blocks, num_window_blocks=num_window_blocks,
              preempt=preempt)
    unshared = _run_trace(Scheduler(tcfg, tparams, SchedulerConfig(
        num_slots=3, max_len=48, prefill_chunk=8, eos_token=_TRACE["eos"],
        cache_requests=False, **kw)), prompts, mnts)
    contiguous, got, sched, ref = _three_ways(
        model, arch, prompts, mnts, _TRACE["eos"], prefix_sharing=True,
        **kw)
    assert got == unshared == contiguous
    st = sched.stats()
    assert sched.counters["prefix_shared_tokens"] > 0
    assert st["prefix_shared_chunks"] > 0 and st["prefix_published"] > 0
    if preempt == "swap":
        assert sched.counters["recomputed_decode_steps"] == 0
    assert st["blocks_used"] > 0            # the index holds blocks
    assert sched.slots.flush_prefix() == ref.slots.flush_prefix() > 0
    assert sched.stats()["blocks_used"] == 0
    assert sched.stats()["shared_blocks"] == 0


def test_rwkv_pages_with_zero_groups(model):
    """RWKV has no KV to page: the paged backing runs with no page-table
    group, every leaf dense, and its streams are the contiguous run's."""
    rcfg = model("rwkv6-1.6b")[0]
    prompts = _prompts(np.random.default_rng(7), rcfg.vocab, _TRACE["lens"])
    contiguous, got, sched, _ = _three_ways(
        model, "rwkv6-1.6b", prompts, _TRACE["mnts"], _TRACE["eos"],
        allocator="paged", block_size=8, num_blocks=6, preempt="swap")
    assert got == contiguous
    st = sched.stats()
    assert st["page_groups"] == 0 and st["blocks_total"] == 0
    assert sched.slots.backing.paged == {}
    assert sched.counters["preempted"] == 0


def test_prefix_sharing_counters_zero_when_off(model):
    """A plain paged run reports every sharing key as an exact zero."""
    _, tcfg, _, tparams = model("gemma-2b")
    sched = Scheduler(tcfg, tparams, SchedulerConfig(
        num_slots=2, max_len=32, prefill_chunk=8, cache_requests=False,
        allocator="paged", block_size=8))
    sched.submit(_prompts(np.random.default_rng(5), tcfg.vocab, [6, 6]),
                 max_new_tokens=2)
    sched.drain()
    st = sched.stats()
    assert sched.counters["prefix_shared_tokens"] == 0
    for k in ("shared_blocks", "cow_copies", "prefix_shared_chunks",
              "prefix_entries", "prefix_lookups", "prefix_hit_chunks",
              "prefix_published", "prefix_evicted"):
        assert st[k] == 0, k


def test_submit_checks_the_pool_atomically(model):
    """A request that could never fit the whole block pool raises
    ValueError at submit, and the whole batch is refused with it."""
    _, tcfg, _, tparams = model("gemma-2b")
    sched = Scheduler(tcfg, tparams, SchedulerConfig(
        num_slots=1, max_len=64, prefill_chunk=8, cache_requests=False,
        allocator="paged", block_size=8, num_blocks=2))
    good = np.arange(4, dtype=np.int32)
    with pytest.raises(ValueError, match="blocks > pool"):
        sched.submit([good, np.arange(20, dtype=np.int32)],
                     max_new_tokens=8)
    with pytest.raises(ValueError, match="blocks > pool"):
        sched.score([np.arange(20, dtype=np.int32)])
    assert sched.pending == 0 and sched.counters["submitted"] == 0
    rids = sched.submit([good], max_new_tokens=4)
    assert [c.rid for c in sched.drain()] == rids


def test_preemption_timeline_and_trace_events(model):
    """Swap and recompute preemptions leave their marks: the tracer's
    preempt / swap-out / swap-in events on the slot tracks, and the
    completions' preemption count, swapped time and recomputed steps."""
    rcfg, tcfg, _, tparams = model("gemma-2b")
    prompts = _prompts(np.random.default_rng(7), rcfg.vocab, _TRACE["lens"])
    seen = {}
    for preempt in ("swap", "recompute"):
        tracer = obs_trace.Tracer(enabled=True)
        sched = Scheduler(tcfg, tparams, SchedulerConfig(
            num_slots=3, max_len=48, prefill_chunk=8, cache_requests=False,
            allocator="paged", block_size=8, num_blocks=6, preempt=preempt),
            tracer=tracer)
        rids = sched.submit(prompts, max_new_tokens=8)
        sched.drain()
        comps = [sched.results[r] for r in rids]
        names = [e.name for e in tracer.events]
        seen[preempt] = (names, comps, sched.counters)
    names, comps, c = seen["swap"]
    assert names.count("swap-out") == names.count("swap-in") \
        == c["swapped_out"] >= 1
    assert sum(x.preemptions for x in comps) == c["preempted"]
    assert any(x.swapped_s > 0 for x in comps)
    assert all(x.recomputed_steps == 0 for x in comps)
    names, comps, c = seen["recompute"]
    assert names.count("preempt") == c["preempted"] >= 1
    assert sum(x.recomputed_steps for x in comps) \
        == c["recomputed_decode_steps"]
