"""The port's observability schemas (``repro_torch.obs.schema``) against the
reference's, and the port's ``stats()`` and Chrome trace against them, on
the CPU.

The documented key sets (scheduler, slot pool, paged backing, shard gauges)
equal the reference's key for key and type for type; the validators give
the reference's answers on the same inputs. A reduced gemma-2b served by
the port's contiguous and paged schedulers (with speculation, and prefix
sharing on the paged pool) has ``stats()`` that pass ``validate_stats`` and
whose key set and value types equal the reference scheduler's on the same
requests; a traced port run exports a trace that ``validate_chrome_trace``
accepts.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RC
from repro.models import transformer as RT
from repro.obs import schema as R
from repro.serve import Scheduler as JScheduler
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.obs import Sampler, Tracer, schema, set_sampler
from repro_torch.serve import Scheduler, SchedulerConfig

TABLES = ("SCHEDULER_STATS", "SLOTS_STATS", "PAGED_STATS", "SHARD_TOTALS")


@pytest.mark.parametrize("name", TABLES)
def test_stats_schemas_equal_the_reference(name):
    got, want = getattr(schema, name), getattr(R, name)
    assert list(got) == list(want)
    assert got == want


def test_histogram_and_shard_names_equal_the_reference():
    assert schema.SCHEDULER_LATENCY_HISTS == R.SCHEDULER_LATENCY_HISTS
    assert schema.SHARD_GAUGE_SUFFIXES == R.SHARD_GAUGE_SUFFIXES
    ok = {"num_shards": 2, "steals": 0,
          **{f"shard{s}.{x}": 1 for s in range(2)
             for x in R.SHARD_GAUGE_SUFFIXES}}
    bad = dict(ok, steals=0.5)
    del bad["shard1.queued"]
    for stats in (ok, bad):
        assert schema.validate_shard_metrics(stats, 2) == \
            R.validate_shard_metrics(stats, 2)
    assert schema.validate_shard_metrics(ok, 2) == []


def test_validators_give_the_reference_answers():
    tab = {"a": int, "b": float, "c": str}
    for stats in ({"a": 1, "b": 2, "c": "x"}, {"a": True, "b": 1.5},
                  {"a": 1.0, "b": "no", "c": 3}):
        assert schema.validate_stats(stats, tab) == \
            R.validate_stats(stats, tab)
    span = {"ph": "X", "name": "s", "pid": 1, "tid": 1, "ts": 0.0,
            "dur": 10.0}
    traces = [
        {"traceEvents": [span], "otherData": {"dropped_events": 0}},
        {"traceEvents": [span, dict(span, ts=5.0, dur=10.0)],
         "otherData": {"dropped_events": 0}},          # partial overlap
        {"traceEvents": [span, dict(span, ts=2.0, dur=3.0)],
         "otherData": {"dropped_events": 0}},          # nested: fine
        {"traceEvents": [{"ph": "C", "name": "c", "pid": 1, "tid": 1,
                          "ts": 1.0, "args": {}}]},    # empty counter
        {"traceEvents": [dict(span, ph="Q")],
         "otherData": {"dropped_events": -1}},
        [],
    ]
    for tr in traces:
        assert schema.validate_chrome_trace(tr) == \
            R.validate_chrome_trace(tr)
    assert schema.validate_chrome_trace(traces[0]) == []
    assert schema.validate_chrome_trace(traces[2]) == []


@pytest.fixture(scope="module")
def gemma():
    rcfg = dataclasses.replace(RC.reduced_config("gemma-2b"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(TC.reduced_config("gemma-2b"),
                               dtype=torch.float32)
    tree = jax.tree_util.tree_map(
        np.array, RT.init_model(jax.random.PRNGKey(0), rcfg))
    return (rcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg,
            convert.params_from_numpy(tcfg, tree, device="cpu"))


def _requests(vocab):
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, vocab, 16).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, n)
                            .astype(np.int32)]) for n in (3, 9, 1)]


ARMS = {"contiguous": dict(speculate=2),
        "paged": dict(allocator="paged", block_size=8, prefix_sharing=True,
                      speculate=2, preempt="swap")}


@pytest.mark.parametrize("arm", list(ARMS))
def test_port_stats_pass_the_schema_and_equal_the_reference_keys(gemma,
                                                                 arm):
    rcfg, jparams, tcfg, tparams = gemma
    prompts = _requests(rcfg.vocab)
    got = {}
    for name, make, cfg, params in (
            ("port", lambda kw: Scheduler(tcfg, tparams,
                                          SchedulerConfig(**kw)),
             tcfg, tparams),
            ("reference", lambda kw: JScheduler(rcfg, jparams,
                                                JSchedulerConfig(**kw)),
             rcfg, jparams)):
        sched = make(dict(num_slots=2, max_len=48, prefill_chunk=8,
                          **ARMS[arm]))
        sched.submit(prompts, max_new_tokens=5)
        sched.score(prompts[:1])
        sched.drain()
        got[name] = sched.stats()
    st = got["port"]
    tab = {**schema.SCHEDULER_STATS, **schema.SLOTS_STATS}
    if arm == "paged":
        tab.update(schema.PAGED_STATS)
    assert schema.validate_stats(st, tab) == []
    assert set(st) == set(got["reference"])
    assert {k: type(v) for k, v in st.items()} == \
        {k: type(v) for k, v in got["reference"].items()}
    assert st["allocator"] == ("paged" if arm == "paged" else "contiguous")
    assert st["spec.drafted_tokens"] > 0
    assert st["spec.accept_len.count"] > 0
    if arm == "paged":
        assert st["prefix_shared_tokens"] > 0


def test_traced_port_run_passes_validate_chrome_trace(gemma, tmp_path):
    """A speculative paged run with the tracer on and a sampler ticking:
    per-slot phase spans, scheduler spans, instants and counter tracks
    (metrics and spec.accept_len) export to a valid Chrome trace."""
    _, _, tcfg, tparams = gemma
    tr = Tracer(enabled=True)
    smp = Sampler(tracer=tr, counter_tracks=(
        ("serve.generated_tokens", "rate"), ("serve.live", "value")))
    prev = set_sampler(smp)
    try:
        sched = Scheduler(tcfg, tparams, SchedulerConfig(
            num_slots=2, max_len=48, prefill_chunk=8, speculate=2,
            allocator="paged", block_size=8, num_blocks=7, preempt="swap",
            cache_requests=False), tracer=tr)
        sched.submit(_requests(tcfg.vocab), max_new_tokens=8)
        sched.drain()
    finally:
        set_sampler(prev)
    data = tr.chrome_trace()
    assert schema.validate_chrome_trace(data) == []
    names = {e["name"] for e in data["traceEvents"]}
    assert {"admit", "prefill", "decode", "decode-tick", "prefill-chunk",
            "retire", "spec.accept_len"} <= names
    assert sched.counters["preempted"] >= 1
    assert {"preempt", "swap-out", "swap-in"} & names
    tr.export_chrome(str(tmp_path / "trace.json"))
