"""The port's speculative decoding (``SchedulerConfig(speculate=k)``) against
the JAX reference's on the CPU, on reduced gemma-2b and gemma3-12b
(sliding-window rings paged through a ring group), with one set of weights
through ``convert.params_from_numpy``; the cases are the reference's own
(``tests/test_spec.py``).

Chunk (verify) and step logits are not bitwise equal in either package: a
chunk attends over its own k and v unrounded, a step over them rounded in
the bf16 cache, so in fp32 the two paths end about 1e-3 apart (the seam of
ROADMAP queue 3). Speculation is therefore held to what it can equal:

  * in fp32, to the reference's speculation, token for token, with equal
    ``spec.*`` counters (both packages carry the same seam);
  * in bf16, to the port's own ``speculate=0`` run.

In both, where a stream first differs, the two tokens' logits must be a
near-tie (within 1e-3 of max |logit| of one forward of the prompt and the
common prefix); the tests report how many near-ties they saw. ``score()``
with speculation equals the reference's speculative ``score()`` in fp32
and the port's plain ``score()`` in bf16, at rtol 1e-5 / atol 1e-5.
Rejected and inactive verify rows leave the cache pools bitwise as they
were.
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
from repro_torch.serve import Scheduler, SchedulerConfig, SlotManager, engine

SPEC_KEYS = ("spec.drafted_tokens", "spec.accepted_tokens",
             "spec.rejected_tokens", "spec.rollbacks")
TIE_RTOL = 1e-3             # a first difference must be a near-tie
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    """``model(arch, dtype)``: (reference config, port config, JAX params,
    port params) of the reduced ``arch``, one set of weights from
    ``PRNGKey(0)`` for both packages, built once per module. dtype
    "float32" builds both packages; "bfloat16" only the port (its
    reference params are None)."""
    built = {}

    def get(arch, dtype="float32"):
        if (arch, dtype) not in built:
            rcfg = dataclasses.replace(RC.reduced_config(arch),
                                       dtype=jnp.float32)
            tcfg = dataclasses.replace(TC.reduced_config(arch),
                                       dtype=getattr(torch, dtype))
            tree = jax.tree_util.tree_map(
                np.array, RT.init_model(jax.random.PRNGKey(0), rcfg))
            jparams = (jax.tree_util.tree_map(jnp.asarray, tree)
                       if dtype == "float32" else None)
            built[arch, dtype] = (rcfg, tcfg, jparams,
                                  convert.params_from_numpy(tcfg, tree,
                                                            device="cpu"))
        return built[arch, dtype]

    return get


def _prompts(rng, vocab, lens):
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _serve(scheduler, config, cfg, params, prompts, mnts, **kw):
    sc = config(num_slots=2, max_len=64, prefill_chunk=8, eos_token=7,
                cache_requests=False, **kw)
    sched = scheduler(cfg, params, sc)
    rids = [sched.submit([p], max_new_tokens=m)[0]
            for p, m in zip(prompts, mnts)]
    sched.drain()
    return [sched.results[r] for r in rids], sched


def _port(tcfg, tparams, prompts, mnts, **kw):
    return _serve(Scheduler, SchedulerConfig, tcfg, tparams, prompts, mnts,
                  **kw)


def _reference(rcfg, jparams, prompts, mnts, **kw):
    return _serve(JScheduler, JSchedulerConfig, rcfg, jparams, prompts,
                  mnts, **kw)


def _near_ties(tcfg, tparams, prompts, got, want):
    """Streams ``got`` against ``want`` (completions): equal, or first
    different where the two tokens' logits are within TIE_RTOL of max
    |logit| of one port forward of the prompt and the common prefix (a
    stream may stop early at an EOS there). Returns the near-ties seen."""
    prefill = engine.make_prefill_step(tcfg, 0, use_kernels=False)
    ties = []
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        a, b = g.tokens.tolist(), w.tokens.tolist()
        if a == b:
            assert g.reason == w.reason, i
            continue
        j = next(j for j in range(min(len(a), len(b)) + 1)
                 if j == min(len(a), len(b)) or a[j] != b[j])
        assert j < min(len(a), len(b)), f"request {i}: {a} vs {b}"
        ctx = np.concatenate([p, np.asarray(a[:j], np.int32)])
        lg, _ = prefill(tparams, {"tokens": torch.as_tensor(
            ctx, dtype=torch.int64)[None]})
        lg = lg[0, -1].float()
        gap = float((lg[a[j]] - lg[b[j]]).abs())
        scale = float(lg.abs().max())
        assert gap <= TIE_RTOL * scale, (
            f"request {i} differs at token {j} ({a[j]} vs {b[j]}) with a "
            f"logit gap {gap} > {TIE_RTOL} * {scale}")
        ties.append((i, j, gap / scale))
    return ties


ARMS = [
    ("gemma-2b", "contiguous", {}),
    ("gemma-2b", "paged", dict(allocator="paged", block_size=8)),
    ("gemma-2b", "paged-swap", dict(allocator="paged", block_size=8,
                                    num_blocks=14, preempt="swap")),
    ("gemma3-12b", "windowed", dict(allocator="paged", block_size=4)),
]


@pytest.mark.parametrize("arch,arm,kw", ARMS, ids=[a[1] for a in ARMS])
@pytest.mark.parametrize("k", [1, 3])
def test_speculative_streams_match_the_reference(model, arch, arm, kw, k):
    """speculate=k greedy streams and finish reasons equal the reference's
    speculative run token for token (a first difference only at a
    near-tie), and so do the spec counters and each completion's drafted /
    accepted counts, on every backing; real drafts flow."""
    rcfg, tcfg, jparams, tparams = model(arch)
    rng = np.random.default_rng(5)
    prompts = _prompts(rng, rcfg.vocab, [5, 12, 9, 20, 7])
    mnts = [8, 5, 10, 6, 9]
    got, sched = _port(tcfg, tparams, prompts, mnts, speculate=k, **kw)
    want, ref = _reference(rcfg, jparams, prompts, mnts, speculate=k, **kw)
    ties = _near_ties(tcfg, tparams, prompts, got, want)
    print(f"{arm} k={k}: {len(ties)} near-ties {ties}")
    if not ties:
        for key in SPEC_KEYS + ("decode_steps", "generated_tokens",
                                "preempted", "recomputed_decode_steps"):
            assert sched.counters[key] == ref.counters[key], key
        assert [(c.drafted, c.accepted) for c in got] == \
            [(c.drafted, c.accepted) for c in want]
    assert sched.counters["spec.drafted_tokens"] > 0
    assert sum(c.drafted for c in got) == \
        sched.counters["spec.drafted_tokens"]
    assert sum(c.accepted for c in got) == \
        sched.counters["spec.accepted_tokens"]
    if "swap" in arm:
        assert sched.counters["recomputed_decode_steps"] == 0


def test_speculative_prefix_sharing_matches_the_reference(model):
    """Speculation with copy-on-write prefix sharing: rollback never writes
    into a shared prefix block; streams, spec counters and shared tokens
    equal the reference's."""
    rcfg, tcfg, jparams, tparams = model("gemma-2b")
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, rcfg.vocab, 24).astype(np.int32)
    prompts = [np.concatenate([prefix, s]) for s in
               _prompts(rng, rcfg.vocab, [3, 6, 1, 5])]
    mnts = [5, 4, 6, 5]
    kw = dict(allocator="paged", block_size=8, prefix_sharing=True,
              speculate=2)
    got, sched = _port(tcfg, tparams, prompts, mnts, **kw)
    want, ref = _reference(rcfg, jparams, prompts, mnts, **kw)
    plain, _ = _port(tcfg, tparams, prompts, mnts,
                     **dict(kw, speculate=0))
    ties = (_near_ties(tcfg, tparams, prompts, got, want)
            + _near_ties(tcfg, tparams, prompts, got, plain))
    print(f"prefix sharing: {len(ties)} near-ties {ties}")
    assert sched.counters["prefix_shared_tokens"] > 0
    assert sched.counters["spec.drafted_tokens"] > 0
    for key in SPEC_KEYS + ("prefix_shared_tokens",):
        assert sched.counters[key] == ref.counters[key], key
    assert sched.stats()["cow_copies"] == ref.stats()["cow_copies"]


def test_speculative_sampled_rows_still_one_token_per_tick(model):
    """Sampled rows never accept a draft: one token per tick past the
    prompt, and their spec counters stay at 0."""
    _, tcfg, _, tparams = model("gemma-2b")
    rng = np.random.default_rng(7)
    prompts = _prompts(rng, tcfg.vocab, [6, 11])
    sched = Scheduler(tcfg, tparams, SchedulerConfig(
        num_slots=2, max_len=64, prefill_chunk=8, cache_requests=False,
        speculate=3, temperature=0.8))
    rids = sched.submit(prompts, max_new_tokens=6)
    while sched.pending or sched.live:
        before = sched.counters["generated_tokens"]
        live = sched.live
        sched.step()
        assert sched.counters["generated_tokens"] - before <= live
    for r in rids:
        c = sched.results[r]
        assert c.drafted == 0 and c.accepted == 0
        assert len(c.tokens) == 6 and c.reason == "length"
    assert all(sched.counters[k] == 0 for k in SPEC_KEYS)


def _raised(make):
    with pytest.raises(ValueError) as e:
        make()
    return str(e.value)


def test_speculate_validation_is_the_reference(model):
    """The ValueErrors of a bad speculate config read as the reference's:
    recurrent layers, a verify span past the smallest window, k < 0."""
    rcfg_r, tcfg_r, jp_r, tp_r = model("rwkv6-1.6b")
    rcfg3, tcfg3, jp3, tp3 = model("gemma3-12b")
    rcfg, tcfg, jp, tp = model("gemma-2b")
    window = min(s.window for s in rcfg3.pattern if s.window)
    cases = [((rcfg_r, jp_r), (tcfg_r, tp_r), dict(speculate=2)),
             ((rcfg3, jp3), (tcfg3, tp3),
              dict(num_slots=2, max_len=64, speculate=window)),
             ((rcfg, jp), (tcfg, tp), dict(speculate=-1))]
    for (rc, jparams), (tc, tparams), kw in cases:
        want = _raised(lambda: JScheduler(rc, jparams,
                                          JSchedulerConfig(**kw)))
        got = _raised(lambda: Scheduler(tc, tparams, SchedulerConfig(**kw)))
        assert got == want
    # one step below the window serves
    sched = Scheduler(tcfg3, tp3, SchedulerConfig(
        num_slots=2, max_len=64, speculate=window - 1))
    sched.submit([np.arange(1, 6, dtype=np.int32)], max_new_tokens=3)
    assert len(sched.drain()[0].tokens) == 3


def _scores(sched, prompts):
    rids = sched.score(prompts)
    sched.drain()
    return [sched.results[r].logprobs for r in rids]


@pytest.mark.parametrize("kw", [{}, dict(allocator="paged", block_size=8)],
                         ids=["contiguous", "paged"])
def test_score_speculative_matches_plain(model, kw):
    """score() under speculate=3 (verify rows: log-softmax over chunk
    logits) equals score() without it (the ramp's step logits) in bf16,
    where the two paths agree to about 3e-8, and the reference's
    speculative score() in fp32, at the scheduler tests' tolerance. (In
    fp32 the chunk/step seam puts plain and speculative scores about 1e-3
    apart, in both packages.)"""
    rcfg, tcfg, jparams, tparams = model("gemma-2b")
    _, bcfg, _, bparams = model("gemma-2b", "bfloat16")
    prompts = _prompts(np.random.default_rng(9), rcfg.vocab, [4, 13, 21])
    sc = dict(num_slots=2, max_len=64, prefill_chunk=8,
              cache_requests=False, **kw)
    spec = _scores(Scheduler(tcfg, tparams, SchedulerConfig(
        speculate=3, **sc)), prompts)
    ref = _scores(JScheduler(rcfg, jparams, JSchedulerConfig(
        speculate=3, **sc)), prompts)
    spec16 = _scores(Scheduler(bcfg, bparams, SchedulerConfig(
        speculate=3, **sc)), prompts)
    plain16 = _scores(Scheduler(bcfg, bparams, SchedulerConfig(**sc)),
                      prompts)
    for p, a, b, c, d in zip(prompts, spec, ref, spec16, plain16):
        assert a.shape == b.shape == c.shape == d.shape == (len(p) - 1,)
        np.testing.assert_allclose(a, b, **SCORE_TOL)
        np.testing.assert_allclose(c, d, **SCORE_TOL)


@pytest.mark.parametrize("kw", [{}, dict(allocator="paged", block_size=8)],
                         ids=["contiguous", "paged"])
def test_bf16_speculation_against_plain_decode(model, kw):
    """In bf16 (the serving dtype) speculate=3 streams equal the port's own
    speculate=0 streams, a first difference only at a near-tie."""
    _, tcfg, _, tparams = model("gemma-2b", "bfloat16")
    rng = np.random.default_rng(5)
    prompts = _prompts(rng, tcfg.vocab, [5, 12, 9, 20, 7, 30])
    mnts = [8, 5, 10, 6, 9, 12]
    plain, _ = _port(tcfg, tparams, prompts, mnts, **kw)
    spec, sched = _port(tcfg, tparams, prompts, mnts, speculate=3, **kw)
    ties = _near_ties(tcfg, tparams, prompts, spec, plain)
    print(f"bf16 {kw}: {len(prompts) - len(ties)} of {len(prompts)} "
          f"streams equal, near-ties {ties}")
    assert sched.counters["spec.drafted_tokens"] > 0


def _pools(sm):
    """Every cache leaf of a SlotManager as a flat list of copies; paged
    pools without their trash block (written by every unmapped view
    position, always read masked)."""
    b = sm.backing
    out = []
    if sm.paged:
        for leaf in _leaves(b.dense):
            out.append(leaf.clone())
        for c in b.paged.values():
            live = c.k.shape[1] - b.block_size
            out += [c.k[:, :live].clone(), c.v[:, :live].clone(),
                    c.pos[:, :live].clone()]
    else:
        out = [leaf.clone() for leaf in _leaves(b.caches)]
    return out


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return list(tree)
    return [tree]


@pytest.mark.parametrize("kw", [{}, dict(paged=True, block_size=4,
                                         num_blocks=32)],
                         ids=["contiguous", "paged"])
def test_verify_rolls_rejected_and_inactive_rows_back(model, kw):
    """make_verify_step alone, through SlotManager.run_verify on a pool
    with two prefilled slots: an inactive verify leaves every pool bitwise
    as it was; with drafts that all disagree, only position pos is
    committed; with the model's own greedy chain as drafts all k accept,
    and positions pos..pos+k change while every other row stays bitwise."""
    _, tcfg, _, tparams = model("gemma3-12b")
    k, b = 3, 2
    sm = SlotManager(tcfg, b, 32, device="cpu", **kw)
    rng = np.random.default_rng(11)
    ctx = [8, 16]
    for owner, n in enumerate(ctx):
        s = sm.alloc(owner=owner, prompt_len=n + k + 1)
        toks = rng.integers(0, tcfg.vocab, (1, n))
        for c0 in range(0, n, 8):
            sm.run_chunk(tparams, [s], torch.as_tensor(toks[:, c0:c0 + 8]),
                         torch.as_tensor([c0]))
    pos = torch.as_tensor(ctx)
    first = torch.as_tensor(rng.integers(0, tcfg.vocab, (b, 1)))

    def verify(drafts, active):
        return sm.run_verify(
            tparams, torch.cat([first, drafts], dim=1), pos,
            torch.ones(b, dtype=torch.int64), pos + 100,
            torch.zeros(b, dtype=torch.bool), torch.as_tensor(active),
            torch.zeros(b), None, None, None)

    before = _pools(sm)
    drafts = torch.zeros((b, k), dtype=torch.int64)
    # each row's greedy chain, one token per inactive verify: the
    # prediction after slot i is the chain's once drafts[:i] are
    for i in range(k):
        out_tok, n, _ = verify(drafts, [False, False])
        assert n.tolist() == [0, 0]
        for x, y in zip(_pools(sm), before):
            assert torch.equal(x, y)
        drafts[:, i] = out_tok[:, i]
    # every draft rejected: row 0 commits position pos only, row 1
    # (inactive) nothing
    _, n, _ = verify((drafts + 1) % tcfg.vocab, [True, False])
    assert n.tolist() == [0, 0]
    rejected = _pools(sm)
    _same_outside(sm, before, rejected, row=0, lo=ctx[0], hi=ctx[0])
    # the greedy chain: all k accept on row 1, row 0 (inactive) unchanged
    out_tok, n, _ = verify(drafts, [False, True])
    assert n.tolist() == [0, k]
    assert torch.equal(out_tok[1, :k], drafts[1])
    _same_outside(sm, rejected, _pools(sm), row=1, lo=ctx[1],
                  hi=ctx[1] + k)


def _same_outside(sm, old, new, row, lo, hi):
    """Every element of ``new`` equals ``old`` except slot ``row``'s
    positions lo..hi (contiguous: ring rows of that slot; paged: the pool
    rows its page table maps them to)."""
    b = sm.backing
    if not sm.paged:
        for x, y in zip(old, new):
            if x.dim() < 3:
                assert torch.equal(x, y)
                continue
            mask = torch.ones(x.shape[:3], dtype=torch.bool)
            for p in range(lo, hi + 1):
                mask[:, row, p % x.shape[2]] = False
            assert torch.equal(x[mask], y[mask])
        return
    dense = len(_leaves(b.dense))
    for x, y in zip(old[:dense], new[:dense]):
        assert torch.equal(x, y)
    i = dense
    for key, c in b.paged.items():
        g = b.groups[b.key_view[key]]
        rows = g.pt.rows([row])[0]
        hit = {int(rows[p % len(rows)]) for p in range(lo, hi + 1)}
        for x, y in zip(old[i:i + 3], new[i:i + 3]):
            mask = torch.ones(x.shape[:2], dtype=torch.bool)
            for r in hit:
                if r < x.shape[1]:
                    mask[:, r] = False
            assert torch.equal(x[mask], y[mask])
        i += 3
