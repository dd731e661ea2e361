"""The port's continuous-batching scheduler (``repro_torch.serve``) against
the JAX reference's Scheduler on the CPU, on reduced gemma-2b, rwkv6-1.6b
and gemma3-12b (sliding-window rings) in fp32 with the same weights.

Greedy streams under staggered arrivals are token for token (and reason for
reason) the reference scheduler's and the port's per-request ``generate``
(same chunk policy). ``score()`` logprobs agree with the reference's at
rtol 1e-5 / atol 1e-5 for the attention models (as the reference holds its
own scoring paths to each other) and at 1e-4 for RWKV, whose chunk scans
sum in another order. Sampling at a temperature draws from the port's
``torch.Generator``, not from JAX keys: it is checked for its own
properties. The reference's randomized property test fails on some draws,
so the port is held to fixed examples.
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
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import KernelService, Request
from repro_torch.serve import (Completion, RequestCache, Scheduler,
                               SchedulerConfig, SlotManager, generate)

ARCHS = ["gemma-2b", "rwkv6-1.6b", "gemma3-12b"]
SCORE_TOL = {"gemma-2b": dict(rtol=1e-5, atol=1e-5),
             "gemma3-12b": dict(rtol=1e-5, atol=1e-5),
             "rwkv6-1.6b": dict(rtol=1e-4, atol=1e-4)}

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


LENS = [3, 11, 20, 33, 9, 5]
MNTS = [4, 7, 3, 6, 9, 5]


def _staggered(sched, prompts, mnts):
    """Three requests at once, then one every 3 steps; every completion is
    handed out once. Returns {request index: (tokens, reason)}."""
    rid2i, done, steps = {}, [], 0
    for i in range(3):
        rid2i[sched.submit([prompts[i]], max_new_tokens=mnts[i])[0]] = i
    submitted = 3
    while sched.pending or sched.live or submitted < len(prompts):
        done += sched.step()
        steps += 1
        if steps % 3 == 0 and submitted < len(prompts):
            rid2i[sched.submit([prompts[submitted]],
                               max_new_tokens=mnts[submitted])[0]] = \
                submitted
            submitted += 1
    done += sched.drain()
    assert len({c.rid for c in done}) == len(done) == len(prompts)
    return {rid2i[c.rid]: (c.tokens.tolist(), c.reason) for c in done}


@pytest.mark.parametrize("arch", ARCHS)
def test_staggered_arrivals_match_generate_and_the_reference(arch, model):
    """Mixed prompt lengths (0 to 4 chunks), arrivals mid-stream, more
    requests than slots (slot reuse), an EOS that ends some streams early."""
    rcfg, tcfg, jparams, tparams = model(arch)
    prompts = _prompts(np.random.default_rng(1), rcfg.vocab, LENS)
    # EOS: the 4th token of request 4's stream, so it stops early
    eos = int(generate(tparams, tcfg, prompts[4], MNTS[4],
                       prefill_chunk=8)[0][3])
    kw = dict(num_slots=2, max_len=64, prefill_chunk=8, eos_token=eos)
    sched = Scheduler(tcfg, tparams, SchedulerConfig(**kw))
    got = _staggered(sched, prompts, MNTS)
    want = _staggered(JScheduler(rcfg, jparams, JSchedulerConfig(**kw)),
                      prompts, MNTS)
    assert got == want
    reasons = []
    for i, p in enumerate(prompts):
        toks, reason = generate(tparams, tcfg, p, MNTS[i], eos_token=eos,
                                prefill_chunk=8)
        assert got[i] == (toks.tolist(), reason), i
        reasons.append(reason)
    assert "eos" in reasons and "length" in reasons
    st = sched.stats()
    assert st["completed"] == len(prompts) and st["live"] == 0
    assert st["generated_tokens"] == sum(len(t) for t, _ in got.values())
    assert st["chunk_steps"] > 0 and 0 < st["mean_occupancy"] <= 2


def test_pool_exhaustion_queues_fcfs(model):
    _, tcfg, _, tparams = model("gemma-2b")
    sched = Scheduler(tcfg, tparams, SchedulerConfig(
        num_slots=1, max_len=32, prefill_chunk=8, cache_requests=False))
    rids = sched.submit(_prompts(np.random.default_rng(2), tcfg.vocab,
                                 [4, 4, 4]), max_new_tokens=2)
    done = sched.step()
    assert sched.live == 1 and sched.pending == 2        # FCFS backlog
    done += sched.drain()
    assert [c.rid for c in done] == sorted(rids)         # completion order
    admits = [c.admit_t for c in done]
    assert admits == sorted(admits)
    assert all(c.queue_wait >= 0 and c.ttft <= c.latency for c in done)


def test_static_admission_waits_for_an_empty_pool(model):
    """admit='static' admits a batch only into an empty pool; streams equal
    the continuous scheduler's and the reference's static scheduler's."""
    rcfg, tcfg, jparams, tparams = model("gemma-2b")
    prompts = _prompts(np.random.default_rng(7), tcfg.vocab,
                       [5, 12, 7, 9, 4])
    mnts = [2, 8, 3, 4, 6]
    kw = dict(num_slots=2, max_len=32, prefill_chunk=8,
              cache_requests=False)
    out = {}
    for admit in ("static", "continuous"):
        sched = Scheduler(tcfg, tparams, SchedulerConfig(admit=admit, **kw))
        rids = [sched.submit([p], max_new_tokens=n)[0]
                for p, n in zip(prompts, mnts)]
        live = []
        while sched.pending or sched.live:
            before = sched.live
            sched.step()
            live.append((before, sched.counters["admitted"]))
        out[admit] = ([sched.results[r].tokens.tolist() for r in rids],
                      sched.counters["decode_steps"], live)
    toks, steps, live = out["static"]
    assert toks == out["continuous"][0]
    assert steps > out["continuous"][1]      # pad-to-slowest costs ticks
    admitted = 0
    for before, after in live:
        if after > admitted:                 # admissions only into an
            assert before == 0               # empty pool
        admitted = after
    jsched = JScheduler(rcfg, jparams, JSchedulerConfig(admit="static",
                                                        **kw))
    jr = [jsched.submit([p], max_new_tokens=n)[0]
          for p, n in zip(prompts, mnts)]
    jsched.drain()
    assert [jsched.results[r].tokens.tolist() for r in jr] == toks
    assert jsched.counters["decode_steps"] == steps


def test_request_cache_keys_hits_and_eviction():
    a = np.asarray([1, 0], np.int32)
    b = np.asarray([1], np.int64)
    assert a.tobytes() == b.tobytes()
    assert RequestCache.key(a, 4, None) != RequestCache.key(b, 4, None)
    assert RequestCache.key(a, 4, None) == RequestCache.key(a.copy(), 4,
                                                            None)
    assert RequestCache.key(a, 4, None) != RequestCache.key(
        a, 4, None, mode="score")
    rc = RequestCache(maxsize=2)
    k1 = RequestCache.key(np.asarray([1, 2], np.int32), 4, None)
    k2 = RequestCache.key(np.asarray([1, 2], np.int32), 5, None)
    assert k1 != k2 and rc.get(k1) is None
    src = np.asarray([9], np.int32)
    rc.put(k1, src, "length")
    src[:] = 0                               # the memo holds its own copy
    got = rc.get(k1)
    assert got[0].tolist() == [9] and not got[0].flags.writeable
    rc.put(k2, np.asarray([8], np.int32), "length")
    rc.put(RequestCache.key(np.asarray([3], np.int32), 4, None),
           np.asarray([7], np.int32), "length")
    assert rc.get(k1) is None                # LRU evicted (maxsize=2)
    assert rc.hit_rate == pytest.approx(1 / 3)


def test_scheduler_serves_repeats_from_the_cache(model):
    _, tcfg, _, tparams = model("rwkv6-1.6b")
    sched = Scheduler(tcfg, tparams, SchedulerConfig(
        num_slots=2, max_len=32, prefill_chunk=8))
    hot = _prompts(np.random.default_rng(3), tcfg.vocab, [6])[0]
    (r1,) = sched.submit([hot], max_new_tokens=3)
    sched.drain()
    first = sched.results[r1]
    want = first.tokens.tolist()
    first.tokens[:] = -1                     # the requester scribbles
    r2 = sched.submit([hot, hot], max_new_tokens=3)
    steps = sched.counters["decode_steps"]
    sched.drain()
    assert sched.counters["decode_steps"] == steps       # no decode
    for r in r2:
        assert sched.results[r].reason == "cached"
        assert sched.results[r].tokens.tolist() == want
    # identical requests in flight coalesce: one decode for both
    cold = _prompts(np.random.default_rng(4), tcfg.vocab, [7])[0]
    r3 = sched.submit([cold, cold], max_new_tokens=2)
    sched.drain()
    assert [sched.results[r].reason for r in r3] == ["length", "cached"]
    assert sched.request_cache.hit_rate > 0
    # sampled requests bypass the memo
    (r4,) = sched.submit([hot], max_new_tokens=3, temperature=0.9)
    sched.drain()
    assert sched.results[r4].reason != "cached"


def test_submit_validation(model):
    """User input raises ValueError before anything is enqueued, with the
    reference's checks and messages; every option of the reference's
    scheduler builds, the sharded pool included."""
    _, tcfg, _, tparams = model("gemma-2b")
    _, rwkv_cfg, _, rwkv_params = model("rwkv6-1.6b")
    sched = Scheduler(tcfg, tparams, SchedulerConfig(
        num_slots=1, max_len=16, prefill_chunk=8, cache_requests=False))
    good = np.arange(4, dtype=np.int32)
    with pytest.raises(ValueError, match="max_new_tokens"):
        sched.submit([good], max_new_tokens=0)
    with pytest.raises(ValueError, match="exceeds"):
        sched.submit([good, np.arange(14, dtype=np.int32)],
                     max_new_tokens=4)
    with pytest.raises(ValueError, match="temperature"):
        sched.submit([good], temperature=-1.0)
    with pytest.raises(ValueError, match="score prompt length"):
        sched.score([np.arange(1, dtype=np.int32)])
    with pytest.raises(ValueError, match="score prompt length"):
        sched.score([np.arange(17, dtype=np.int32)])
    # the batch is atomic: nothing leaked
    assert sched.pending == 0 and sched.counters["submitted"] == 0
    assert sched.drain() == [] and sched.results == {}
    rids = sched.submit([good], max_new_tokens=4)
    assert [c.rid for c in sched.drain()] == rids

    def make(cfg=tcfg, params=tparams, **kw):
        return Scheduler(cfg, params, SchedulerConfig(**kw))

    for kw, match in ((dict(preempt="restart"), "SchedulerConfig.preempt"),
                      (dict(allocator="blocks"), "allocator"),
                      (dict(admission="lazy"), "admission"),
                      (dict(admit="eager"), "admit"),
                      (dict(placement="random"), "placement"),
                      (dict(prefix_sharing=True), "prefix_sharing"),
                      (dict(mesh_shards=2), "mesh_shards"),
                      (dict(speculate=-1), "speculate"),
                      (dict(temperature=-0.5), "temperature")):
        with pytest.raises(ValueError, match=match):
            make(**kw)
    with pytest.raises(ValueError, match="attention-only"):
        make(rwkv_cfg, rwkv_params, speculate=2)
    with pytest.raises(ValueError, match="mesh_shards"):
        Scheduler(tcfg, tparams, SchedulerConfig(), mesh=object())
    # the paged allocator, prefix sharing, speculation and the sharded
    # pool are ported (a speculative scheduler serves a greedy request)
    assert make(allocator="paged").slots.paged
    assert make(allocator="paged", prefix_sharing=True).slots.paged
    spec = make(speculate=2, num_slots=2, max_len=32, prefill_chunk=8)
    (rid,) = spec.submit([good], max_new_tokens=4)
    (done,) = spec.drain()
    assert done.rid == rid and len(done.tokens) == 4
    assert spec.counters["spec.drafted_tokens"] > 0
    assert make(allocator="paged", mesh_shards=2).slots.num_shards == 2
    assert SlotManager(tcfg, 2, 16, paged=True, mesh_shards=2,
                       device="cpu").sharded
    assert SlotManager(tcfg, 2, 16, paged=True, device="cpu").paged


def test_per_slot_sampling_policies(model):
    """A pool mixing greedy and sampled rows: greedy rows keep generate's
    stream, one seed gives one sampled stream, top_k=1 is greedy."""
    _, tcfg, _, tparams = model("gemma-2b")
    prompts = _prompts(np.random.default_rng(8), tcfg.vocab, [6, 9, 5])

    def run(seed):
        sched = Scheduler(tcfg, tparams, SchedulerConfig(
            num_slots=4, max_len=32, prefill_chunk=8, seed=seed))
        g = sched.submit(prompts[:1], max_new_tokens=8)
        s = sched.submit(prompts[1:2], max_new_tokens=8, temperature=1.5)
        k1 = sched.submit(prompts[2:], max_new_tokens=8, temperature=2.0,
                          top_k=1)
        sched.drain()
        return [sched.results[r[0]].tokens.tolist() for r in (g, s, k1)]

    a, b, c = run(0), run(0), run(1)
    assert a == b
    greedy = [generate(tparams, tcfg, p, 8, prefill_chunk=8)[0].tolist()
              for p in prompts]
    assert a[0] == greedy[0] and c[0] == greedy[0]
    assert a[2] == greedy[2]                 # top-1 sampling is greedy
    assert a[1] != greedy[1] or c[1] != greedy[1]
    assert all(0 <= t < tcfg.vocab for t in a[1] + c[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_score_matches_the_reference(arch, model):
    """Prompts through chunks and decode steps (lengths 2 to 33, chunk 8)
    beside a generate request; a repeat is served from the memo."""
    rcfg, tcfg, jparams, tparams = model(arch)
    prompts = _prompts(np.random.default_rng(9), rcfg.vocab, [2, 9, 17, 33])
    kw = dict(num_slots=3, max_len=48, prefill_chunk=8)
    sched = Scheduler(tcfg, tparams, SchedulerConfig(**kw))
    gen = sched.submit(prompts[2:3], max_new_tokens=5)
    rids = sched.score(prompts)
    sched.drain()
    jsched = JScheduler(rcfg, jparams, JSchedulerConfig(**kw))
    jrids = jsched.score(prompts)
    jsched.drain()
    for p, r, jr in zip(prompts, rids, jrids):
        got, want = sched.results[r], jsched.results[jr]
        assert got.reason == want.reason == "score"
        assert got.logprobs.dtype == np.float32
        assert got.logprobs.shape == (len(p) - 1,) and len(got.tokens) == 0
        assert bool((got.logprobs <= 0).all())
        np.testing.assert_allclose(got.logprobs, want.logprobs,
                                   **SCORE_TOL[arch])
    assert sched.results[gen[0]].tokens.tolist() == generate(
        tparams, tcfg, prompts[2], 5, prefill_chunk=8)[0].tolist()
    (again,) = sched.score(prompts[3:])
    sched.drain()
    assert sched.results[again].reason == "cached"
    np.testing.assert_array_equal(sched.results[again].logprobs,
                                  sched.results[rids[3]].logprobs)


def test_interleaved_step_drain_delivers_each_completion_once(model):
    _, tcfg, _, tparams = model("gemma-2b")
    sched = Scheduler(tcfg, tparams, SchedulerConfig(
        num_slots=2, max_len=32, prefill_chunk=8, cache_requests=False))
    rng = np.random.default_rng(11)
    delivered = []
    r1 = sched.submit(_prompts(rng, tcfg.vocab, [3, 5]), max_new_tokens=2)
    for _ in range(8):
        delivered += sched.step()
    assert sorted(c.rid for c in delivered) == sorted(r1)
    assert sched.drain() == []
    r2 = sched.submit(_prompts(rng, tcfg.vocab, [4]), max_new_tokens=2)
    assert [c.rid for c in sched.drain()] == r2
    assert sorted(sched.results) == sorted(r1 + r2)
    assert all(isinstance(c, Completion) for c in sched.results.values())


def test_metrics_provider_and_trace_events(model):
    _, tcfg, _, tparams = model("rwkv6-1.6b")
    tracer = obs_trace.Tracer(enabled=True)
    sched = Scheduler(tcfg, tparams, SchedulerConfig(
        num_slots=2, max_len=32, prefill_chunk=8), tracer=tracer)
    sched.submit(_prompts(np.random.default_rng(12), tcfg.vocab, [12, 4]),
                 max_new_tokens=3)
    sched.drain()
    snap = obs_metrics.REGISTRY.snapshot()
    assert snap["serve.completed"] == 2 and snap["serve.slots.free"] == 2
    assert snap["serve.ttft_ms.count"] == 2
    names = {(e.name, e.track.startswith("slot")) for e in tracer.events}
    for name in ("admit", "prefill", "decode", "retire"):
        assert (name, True) in names, name
    for name in ("decode-tick", "prefill-chunk", "submit"):
        assert (name, False) in names, name


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "gemma-2b"])
def test_kernel_service_generate_and_score(arch, model):
    _, tcfg, _, tparams = model(arch)
    kw = dict(num_slots=2, max_len=32, prefill_chunk=8)
    svc = KernelService(lm=Scheduler(tcfg, tparams, SchedulerConfig(**kw)),
                        device="cpu")
    assert {"generate", "score"} <= set(svc.kernels)
    prompts = _prompts(np.random.default_rng(4), tcfg.vocab, [5, 9, 13])
    got = svc.submit([Request("generate", {"prompt": prompts[0],
                                           "max_new_tokens": 4}),
                      Request("score", {"prompt": prompts[1]}),
                      Request("generate", {"prompt": prompts[2],
                                           "max_new_tokens": 3})])
    direct = Scheduler(tcfg, tparams, SchedulerConfig(**kw))
    g = direct.submit(prompts[:1], max_new_tokens=4)
    g += direct.submit(prompts[2:], max_new_tokens=3)
    (s,) = direct.score(prompts[1:2])
    direct.drain()
    for out, rid in ((got[0], g[0]), (got[2], g[1])):
        assert out["tokens"].tolist() == direct.results[rid].tokens.tolist()
        assert out["reason"] == direct.results[rid].reason == "length"
    np.testing.assert_array_equal(got[1]["logprobs"],
                                  direct.results[s].logprobs)
    assert got[1]["reason"] == "score"
    assert svc.lm.results == {}              # popped on delivery
    st = svc.stats()
    assert st["lm"]["num_slots"] == 2 and st["lm"]["allocator"] == \
        "contiguous"
    assert "lm" not in KernelService(device="cpu").stats()
