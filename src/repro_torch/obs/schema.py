"""Copy of the reference package's ``obs.schema`` (pure Python).

Documented schemas for the observability surface.

Two things are pinned here so they can't drift silently:

  * ``SCHEDULER_STATS``, ``SLOTS_STATS``, ``PAGED_STATS`` — the
    documented ``stats()`` keys and their types. Every key must be
    present (counters are pre-declared at zero, not grown lazily) and
    correctly typed for BOTH slot backings; ``tests/test_torch_obs_schema.py``
    holds them to the reference's and the port's ``stats()`` to them.
  * ``validate_chrome_trace`` — structural validation of the exported
    Chrome trace-event JSON (the thing the CI smoke run gates on): known
    phases, required fields, non-negative durations, and per-track spans
    that either nest properly or don't overlap at all. A trace that
    passes loads in Perfetto with one named track per slot plus
    scheduler/dispatcher tracks.
"""

from __future__ import annotations

from typing import Any, Dict, List

# -- documented stats() keys -------------------------------------------------

#: serve.Scheduler.stats() — scheduler-owned keys (slots keys merge in).
#: Counts are int, ratios float; every key present from construction.
SCHEDULER_STATS: Dict[str, type] = {
    "submitted": int, "admitted": int, "completed": int, "steps": int,
    "decode_steps": int, "chunk_steps": int, "generated_tokens": int,
    "prefill_tokens": int, "live_decode_slots": int, "preempted": int,
    "swapped_in": int, "swapped_out": int, "recomputed_decode_steps": int,
    # prompt positions admitted already-written via prefix sharing
    # (0 unless SchedulerConfig.prefix_sharing)
    "prefix_shared_tokens": int,
    # work-stealing rebalance: queue heads migrated off a full shard
    # (0 unless SchedulerConfig.mesh_shards >= 2)
    "steals": int,
    "pending": int, "live": int, "coalesced_waiting": int,
    "cache_hits": int, "cache_misses": int,
    "cache_hit_rate": float, "mean_occupancy": float,
    # the live overload signal the SLO layer monitors: how long the
    # current queue head has been waiting (0.0 when the queue is empty)
    "queue_head_wait_s": float,
    # backpressure-controller knobs, surfaced so every actuation is
    # visible in the same snapshot the monitors read (-1 = uncapped)
    "admit_cap": int, "preempt_policy": str,
    # speculative decoding (SchedulerConfig.speculate=k; all 0 when
    # speculation is off — pre-declared so the keys never appear
    # lazily). Teacher-forced ramp positions are excluded: these count
    # REAL drafts only, so accepted/drafted is a true acceptance rate.
    "spec.drafted_tokens": int, "spec.accepted_tokens": int,
    "spec.rejected_tokens": int, "spec.rollbacks": int,
}

#: per-request latency histograms the scheduler owns (flattened into
#: stats() as ``<name>.<field>`` — lifetime count/sum, windowed
#: percentiles): the series SLO rules like ``ttft_p95 < X`` read.
#: ``spec.accept_len`` observes accepted REAL draft length per slot per
#: verify tick (unit: tokens, not ms; only observed while speculating).
SCHEDULER_LATENCY_HISTS = ("queue_wait_ms", "ttft_ms", "itl_ms",
                           "spec.accept_len")
_HIST_FIELDS: Dict[str, type] = {"count": int, "sum": float, "p50": float,
                                 "p95": float, "max": float}
SCHEDULER_STATS.update({f"{h}.{f}": t for h in SCHEDULER_LATENCY_HISTS
                        for f, t in _HIST_FIELDS.items()})

#: serve.SlotManager.stats() — present for BOTH backings.
SLOTS_STATS: Dict[str, type] = {
    "num_slots": int, "live": int, "free": int, "cache_slots": int,
    "position_capacity": int, "total_rows": int, "allocator": str,
}

#: additional SlotManager.stats() keys for the paged backing
#: (per-window ``ring<L>_blocks_*`` keys are workload-dependent extras).
PAGED_STATS: Dict[str, type] = {
    "page_groups": int, "blocks_total": int, "blocks_used": int,
    "blocks_free": int, "block_size": int, "block_utilization": float,
    # prefix sharing / copy-on-write (all 0 when sharing is off —
    # pre-declared so the keys never appear lazily)
    "shared_blocks": int, "cow_copies": int, "prefix_shared_chunks": int,
    "prefix_entries": int, "prefix_lookups": int, "prefix_hit_chunks": int,
    "prefix_published": int, "prefix_evicted": int,
    "swapped_held": int, "swap_bytes_held": int, "swap_bytes_budget": int,
    "swap_rejected": int, "swap_bytes_out": int, "swap_bytes_in": int,
    # cross-shard work-stealing migrations of parked SwapEntries
    # (0 unless the pool is sharded; host bytes change owner, so these
    # are NOT counted in swap_bytes_out/in)
    "swap_migrated_out": int, "swap_migrated_in": int,
}

#: registry ``serve.shard.*`` gauges (sharded pools only; absent
#: otherwise). Per-shard keys are ``shard<i>.<suffix>`` for suffixes
#: SHARD_GAUGE_SUFFIXES, plus the pool-wide totals below. Pinned here so
#: dashboards can rely on the names (``serve/scheduler._ShardObs``).
SHARD_GAUGE_SUFFIXES = (
    "live_slots", "free_slots",         # slot occupancy per shard
    "blocks_free", "blocks_used",       # block-pool levels per shard
    "swapped_held",                     # parked SwapEntries per shard
    "placed",                           # admissions placed on the shard
    "steals",                           # heads stolen TO the shard
    "queued",                           # current queue depth
)
SHARD_TOTALS: Dict[str, type] = {"num_shards": int, "steals": int}


def validate_shard_metrics(metrics: Dict[str, Any],
                           num_shards: int) -> List[str]:
    """Problems with a ``serve.shard`` provider snapshot (empty ==
    valid): every pinned per-shard gauge present for every shard, ints
    throughout, totals present."""
    schema = dict(SHARD_TOTALS)
    for s in range(num_shards):
        for suffix in SHARD_GAUGE_SUFFIXES:
            schema[f"shard{s}.{suffix}"] = int
    return validate_stats(metrics, schema)


def validate_stats(stats: Dict[str, Any],
                   schema: Dict[str, type]) -> List[str]:
    """Problems with ``stats`` against ``schema`` (empty == valid).
    ints must be real ints (bool excluded); floats accept ints too."""
    problems = []
    for key, typ in schema.items():
        if key not in stats:
            problems.append(f"missing key {key!r}")
            continue
        v = stats[key]
        if isinstance(v, bool):
            problems.append(f"{key!r} is bool, wanted {typ.__name__}")
        elif typ is float:
            if not isinstance(v, (int, float)):
                problems.append(f"{key!r} is {type(v).__name__}, "
                                f"wanted float")
        elif not isinstance(v, typ):
            problems.append(f"{key!r} is {type(v).__name__}, "
                            f"wanted {typ.__name__}")
    return problems


# -- chrome trace validation -------------------------------------------------

_PHASES = {"X", "i", "M", "C"}


def validate_chrome_trace(data: Any) -> List[str]:
    """Structural problems with a Chrome trace-event JSON object (empty
    list == valid). Checks: top-level shape, per-event required fields,
    non-negative ts/dur, counter ('C') events carrying numeric series,
    the ``otherData.dropped_events`` loss metadata (a trace whose ring
    overflowed silently is not trustworthy — the count must be present),
    and per-(pid, tid) 'X' spans that either nest properly (a span
    entirely inside another — how jit-compile sits inside
    bucket-dispatch) or are disjoint; partial overlap on one track is
    corruption."""
    problems: List[str] = []
    if not isinstance(data, dict) or "traceEvents" not in data:
        return ["top level must be a dict with 'traceEvents'"]
    evs = data["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' must be a list"]
    other = data.get("otherData")
    if not isinstance(other, dict):
        problems.append("'otherData' metadata missing")
    else:
        dropped = other.get("dropped_events")
        if not isinstance(dropped, int) or isinstance(dropped, bool) \
                or dropped < 0:
            problems.append(
                f"otherData.dropped_events must be a non-negative int, "
                f"got {dropped!r}")
    spans: Dict[Any, List] = {}
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not a dict")
            continue
        ph = e.get("ph")
        if ph not in _PHASES:
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        if "name" not in e or "pid" not in e or "tid" not in e:
            problems.append(f"event {i}: missing name/pid/tid")
            continue
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i} ({e['name']}): bad ts {ts!r}")
            continue
        if ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) and not isinstance(v, bool)
                    for v in args.values()):
                problems.append(f"event {i} ({e['name']}): counter args "
                                f"must be a non-empty numeric dict")
            continue
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} ({e['name']}): bad dur "
                                f"{dur!r}")
                continue
            spans.setdefault((e["pid"], e["tid"]), []).append(
                (ts, ts + dur, e["name"]))
    eps = 1e-3          # µs slop for float round-trips
    for key, ss in spans.items():
        ss.sort(key=lambda s: (s[0], -s[1]))
        stack: List = []            # open span end-times
        for t0, t1, name in ss:
            while stack and t0 >= stack[-1][0] - eps:
                stack.pop()
            if stack and t1 > stack[-1][0] + eps:
                problems.append(
                    f"track {key}: span {name!r} [{t0:.1f}, {t1:.1f}] "
                    f"partially overlaps {stack[-1][1]!r} "
                    f"(ends {stack[-1][0]:.1f})")
                continue
            stack.append((t1, name))
    return problems
