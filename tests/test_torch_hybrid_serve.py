"""The serving paths of the port's MoE and hybrid decoders against the JAX
reference, on the CPU in fp32: greedy ``generate`` streams, the
continuous-batching scheduler on contiguous slots and on the paged pool
(Mamba state stays dense beside the paged KV), and speculation refused for
a pattern with Mamba layers, on reduced ``jamba-v0.1-52b`` and
``olmoe-1b-7b`` with the reference's weights carried over by ``convert``.

Everything runs drop-free (``capacity_factor=16``, the reference's own
test): capacity is computed from the tokens of one call, so the rows of a
pool and the chunks of a prompt compete for it, and at a tight factor the
streams legitimately depend on the batch. Drop-free, greedy streams are
the reference's and per-request ``generate``'s token for token.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as RC
from repro.models import transformer as RT
from repro.serve import Scheduler as JScheduler
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import engine as RE
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.serve import Scheduler, SchedulerConfig, generate

ARCHS = ("jamba-v0.1-52b", "olmoe-1b-7b")
DROP_FREE = 16.0


def _cfgs(arch, **kw):
    return (dataclasses.replace(RC.reduced_config(arch), dtype=jnp.float32,
                                **kw),
            dataclasses.replace(TC.reduced_config(arch), dtype=torch.float32,
                                **kw))


@pytest.fixture(scope="module")
def model():
    """``model(arch)``: (reference params, port params) of the reduced
    ``arch`` from ``PRNGKey(index)``, built once per module."""
    built = {}

    def get(arch):
        if arch not in built:
            rcfg, tcfg = _cfgs(arch)
            tree = jax.tree_util.tree_map(np.array, RT.init_model(
                jax.random.PRNGKey(ARCHS.index(arch)), rcfg))
            built[arch] = (jax.tree_util.tree_map(jnp.asarray, tree),
                           convert.params_from_numpy(tcfg, tree,
                                                     device="cpu"))
        return built[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_streams_match_the_reference(arch, model):
    rcfg, tcfg = _cfgs(arch, capacity_factor=DROP_FREE)
    jparams, tparams = model(arch)
    rng = np.random.default_rng(3)
    for ln, n in ((19, 6), (5, 4)):
        prompt = rng.integers(0, rcfg.vocab, ln).astype(np.int32)
        want, wr = RE.generate(jparams, rcfg, prompt, n, prefill_chunk=8)
        got, gr = generate(tparams, tcfg, prompt, n, prefill_chunk=8)
        assert got.tolist() == np.asarray(want).tolist() and gr == wr


def _staggered(sched, prompts, mnts):
    """Two requests at once, then one every 3 steps: {index: (tokens,
    reason)}."""
    rid2i, done, steps, sub = {}, [], 0, 2
    for i in range(2):
        rid2i[sched.submit([prompts[i]], max_new_tokens=mnts[i])[0]] = i
    while sched.pending or sched.live or sub < len(prompts):
        done += sched.step()
        steps += 1
        if steps % 3 == 0 and sub < len(prompts):
            rid2i[sched.submit([prompts[sub]],
                               max_new_tokens=mnts[sub])[0]] = sub
            sub += 1
    done += sched.drain()
    return {rid2i[c.rid]: (c.tokens.tolist(), c.reason) for c in done}


@pytest.mark.parametrize("allocator", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_matches_the_reference(arch, allocator, model):
    """4 requests on 2 slots, drop-free: the port's scheduler, the
    reference's and per-request generate give the same greedy streams; in
    the paged pool Mamba state stays dense beside the paged KV."""
    rcfg, tcfg = _cfgs(arch, capacity_factor=DROP_FREE)
    jparams, tparams = model(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, rcfg.vocab, ln).astype(np.int32)
               for ln in (13, 4, 21, 9)]
    mnts = [5, 7, 4, 6]
    kw = dict(num_slots=2, max_len=40, prefill_chunk=8)
    if allocator == "paged":
        kw.update(allocator="paged", block_size=4)
    sched = Scheduler(tcfg, tparams, SchedulerConfig(**kw))
    got = _staggered(sched, prompts, mnts)
    want = _staggered(JScheduler(rcfg, jparams, JSchedulerConfig(**kw)),
                      prompts, mnts)
    assert got == want
    for i, p in enumerate(prompts):
        toks, reason = generate(tparams, tcfg, p, mnts[i], prefill_chunk=8)
        assert got[i] == (toks.tolist(), reason), i
    if allocator == "paged":
        dense = sched.slots.backing.dense
        kinds = {k: sorted(v) for k, v in dense.items()}
        for i, spec in enumerate(tcfg.pattern):
            if spec.mixer == "mamba":
                assert kinds[f"p{i}"] == ["mamba"]
                assert dense[f"p{i}"]["mamba"]["h"].shape[1] == 2
            else:
                assert dense[f"p{i}"]["attn"] is None


def test_speculation_on_jamba_raises_the_reference_error(model):
    rcfg, tcfg = _cfgs("jamba-v0.1-52b")
    jparams, tparams = model("jamba-v0.1-52b")
    kw = dict(num_slots=2, max_len=32, prefill_chunk=8, speculate=2)
    with pytest.raises(ValueError) as want:
        JScheduler(rcfg, jparams, JSchedulerConfig(**kw))
    with pytest.raises(ValueError) as got:
        Scheduler(tcfg, tparams, SchedulerConfig(**kw))
    assert str(got.value) == str(want.value)
    assert "attention-only" in str(got.value)
