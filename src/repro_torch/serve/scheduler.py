"""Continuous-batching LM scheduler on the slot pool (port of
``repro.serve.scheduler``, contiguous slots).

Decode is serving's request-scale 1-D dependency-bound recurrence: each
step consumes the previous step's cache. A static batch pads every request
to the slowest member; this scheduler admits, interleaves and retires
requests per decode step:

  admit    - FCFS queue; a request claims a free cache slot the moment one
             exists (SlotManager.alloc zeroes the slot rows).
  prefill  - prompts are consumed as full ``prefill_chunk`` chunks through
             the chunk step (exact: chunks are never padded); the < chunk
             remainder rides the decode ramp as teacher-forced tokens. On
             the card an RWKV chunk runs the ``ssm_scan`` kernel in every
             layer.
  decode   - ONE step over the whole pool each tick: per-slot position
             vector, per-slot sampling policy; free slots compute junk
             that is never read.
  retire   - EOS / max-tokens eviction frees the slot at once; the next
             queued request is admitted on the next tick.

Under greedy sampling the streams are token-identical to per-request
``engine.generate`` with the same ``prefill_chunk`` (same chunk policy,
same steps), up to what a batched matmul may round otherwise than a batch
of one. ``score(prompts)`` teacher-forces prompts through the same chunk
and decode steps and collects every position's logprob
(``Completion.logprobs``); the log-softmax runs on the device and only the
scored tokens' values come to the host. Sampling at a temperature draws
from a ``torch.Generator`` seeded with ``SchedulerConfig.seed``, so a seed
gives one stream, which is not the reference's (JAX keys).

A memoizing request cache (prompt + params -> tokens) fronts the pool for
repeated greedy requests, and identical requests in flight coalesce.

With ``allocator='paged'`` the pool stores attention KV at block
granularity (``serve.paging``): admission gates on free blocks in every
page-table group (global KV and, with ``paged_window_attn``, one ring group
per window length), live slots map blocks as their write position grows,
retire frees them, and a growth failure preempts the youngest slot back to
the front of the queue. At the equal-memory defaults (``num_blocks`` and
``num_window_blocks`` None) scheduling is the contiguous scheduler's;
smaller pools admit more concurrent requests per byte at the cost of
preemptions. What a preemption discards is the ``preempt`` policy:
``recompute`` restarts the victim from scratch (counted in
``recomputed_decode_steps``); ``swap`` copies its blocks to host tensors
and resumes it at its saved position on re-admission, unless the swap
budget rejects them (then it recomputes). ``admission='reserved'`` books
blocks for prompt + max_new at admission, so admitted requests are never
preempted. ``prefix_sharing`` maps indexed chunk-aligned prompt prefixes
read-shared, with copy-on-write.

Observability: the scheduler registers as the ``serve`` provider of the
metrics registry, stamps each request's timeline (queue wait, time to
first token, inter-token latency, time swapped out, recomputed steps) and,
when a Tracer is enabled, records ``admit`` / ``prefill`` / ``decode`` /
``preempt`` / ``swap-out`` / ``swap-in`` / ``retire`` events per slot
track and ``decode-tick`` / ``prefill-chunk`` spans on the scheduler
track.

``speculate=k`` replaces the one-token decode tick with a verify tick
(attention-only models): each greedy slot drafts k tokens (the true prompt
tokens through the decode ramp, a prompt-lookup self-draft past it, or a
``draft_fn``), one chunk call over all k+1 positions verifies them, the
longest prefix of drafts that agrees with the model's own greedy
predictions is accepted, and the cache rows of rejected positions are
rolled back. Sampled rows accept nothing and sample one token per tick;
score rows ride the same verify path. The stream equals plain decode's
where verify (chunk) logits equal step logits, which the reference's
contract assumes; in neither package are they bitwise equal (a chunk
attends over its own k and v, a step over them rounded in the bf16 cache,
and on the card the two round their GEMMs otherwise), so greedy
speculation can differ from ``speculate=0`` at near-ties. The backpressure
knobs ``admit_cap`` and
``preempt_override`` (``obs.control``) change admission timing and the
preemption policy, never a greedy stream.

``mesh_shards=n`` (paged) splits the pool into n shards with block pools
of their own (``serve/slots._ShardedPagedBacking``; ``num_slots`` splits
evenly, ``num_blocks`` and the swap budget are per shard). Each shard has
its own FCFS queue: a new request is placed by ``placement``
(``least_blocks``: the shard with the most free blocks; ``round_robin``)
or by ``Scheduler.placement_fn``, and with ``steal`` a queue head that
cannot admit on its full shard moves to an idle shard that can take it now
(a swapped-out head moves its host swap entry and keeps its progress).
Preemption picks victims on the grower's own shard. Every tick is still one
step over the whole pool. ``Scheduler(mesh=...)`` puts each shard on a
device of a worker mesh (``launch.mesh``). The per-shard gauges are the
``serve.shard`` registry provider. At one shard the pool runs the
unsharded steps and sampling generator, so streams are bitwise the
unsharded pool's; with more shards each shard samples from a generator of
its own (seeded from ``SchedulerConfig.seed`` and the shard index, see
``_shard_seed``), and greedy streams are the bar across shard counts.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import sampler as obs_sampler
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import engine
from repro_torch.serve.slots import SlotManager, _attn_view_len

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_slots: int = 8          # pool width B (the decode batch)
    max_len: int = 256          # cache slots per request (prompt + gen)
    prefill_chunk: int = 32     # C: full-chunk prefill quantum
    max_new_tokens: int = 32    # default generation budget
    temperature: float = 0.0    # default sampling temperature (0 = greedy)
    top_k: int = 0              # default top-k filter (0 = disabled)
    top_p: float = 1.0          # default nucleus mass (1.0 = disabled)
    # k > 0: speculative decoding: draft k tokens per greedy slot per tick,
    # verify them in ONE chunk call, accept the agreeing prefix and roll
    # back the rest. Needs an attention-only pattern (SSM chunk scans cannot
    # roll back) and k + 1 <= the smallest attention view length (the
    # rollback scatter needs distinct ring rows).
    speculate: int = 0
    eos_token: Optional[int] = None
    cache_requests: bool = True
    request_cache_size: int = 1024
    seed: int = 0
    # 'continuous': admit whenever a slot is free (per-step interleaving).
    # 'static': admit a full batch only when the pool is EMPTY (the
    # pad-to-slowest baseline).
    admit: str = "continuous"
    # 'contiguous': every slot reserves max_len cache rows. 'paged':
    # attention KV lives in block pools (serve.paging); admission gates on
    # free BLOCKS, slots grow block by block, and a growth failure preempts
    # the youngest slot.
    allocator: str = "contiguous"
    block_size: int = 16        # paged: cache positions per block
    # paged: physical blocks in the global-KV pool. None = equal memory
    # with the contiguous layout (num_slots * ceil(max_len / block_size)),
    # where no request ever fails to grow
    num_blocks: Optional[int] = None
    # paged: also page sliding-window rings through ring-mode page-table
    # groups (one per window length) instead of a dense ring per slot
    paged_window_attn: bool = True
    # paged: physical blocks per window-ring pool. None = equal memory with
    # the dense rings (num_slots * ceil(min(window, max_len) / block_size))
    num_window_blocks: Optional[int] = None
    # preempt='swap': byte budget of the host SwapStore. None = unbounded;
    # a victim whose bytes would exceed it is recomputed instead
    # (stats()['swap_rejected'])
    swap_bytes_budget: Optional[int] = None
    # paged: what preempt-on-OOB discards. 'recompute' restarts the victim;
    # 'swap' parks its block bytes on the host and resumes it there
    preempt: str = "recompute"
    # paged: 'optimistic' books blocks for the prompt only; 'reserved'
    # books blocks_for(prompt + max_new), so admitted traffic is never
    # preempted
    admission: str = "optimistic"
    # paged: share block-aligned prompt prefixes through a refcounted
    # PrefixIndex, copy-on-write; greedy streams equal the unshared run
    prefix_sharing: bool = False
    # prefix_sharing: LRU entry bound of the prefix index
    prefix_index_capacity: int = 512
    # shard the paged pool: num_slots splits evenly into mesh_shards
    # shards, each with its own block pools, page tables, swap store and
    # prefix index (num_blocks and the swap budget are then PER SHARD);
    # every tick runs one step over the whole pool. Scheduler(mesh=...)
    # puts each shard on a device. None = the unsharded pool; 1 runs the
    # sharded control path, bitwise equal to None
    mesh_shards: Optional[int] = None
    # sharded: the shard a new request lands on. 'least_blocks' takes the
    # shard with the most free blocks, 'round_robin' cycles;
    # Scheduler.placement_fn (a callable (scheduler, slot state) -> shard)
    # overrides both
    placement: str = "least_blocks"
    # sharded: work stealing. A queue head that cannot admit on its full
    # shard moves to an idle shard that can admit it now (a swapped-out
    # head moves its host swap entry and keeps its prefill progress)
    steal: bool = True


@dataclasses.dataclass
class _Slot:
    """Host-side per-slot request state (the validity mask's payload)."""
    rid: int
    prompt: np.ndarray          # int32 (L,)
    max_new_tokens: int
    policy: engine.SamplingPolicy
    mode: str = "generate"      # 'generate' | 'score' (prompt logprobs)
    ctx: int = 0                # tokens consumed into the slot's cache
    chunk_tokens: int = 0       # of which via chunk steps (not decode)
    out: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    accepted: int = 0           # speculative drafts accepted (this request)
    drafted: int = 0            # speculative drafts proposed (this request)
    admit_seq: int = -1         # admission order: preemption evicts max
    shard: int = 0              # home shard (0 on unsharded pools)


@dataclasses.dataclass
class _Timeline:
    """Per-request phase stamps (perf_counter), kept while the request is
    in flight and folded into its Completion at finish."""
    submit_t: float
    admit_t: Optional[float] = None     # first slot claim (None = cached)
    first_token_t: Optional[float] = None
    swap_out_t: Optional[float] = None  # open swap interval, if any
    swapped_s: float = 0.0              # total time parked in the SwapStore
    recomputed_steps: int = 0           # decode ticks redone after preempt
    preemptions: int = 0


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray          # int32 (g,)
    reason: str                 # 'eos' | 'length' | 'score' | 'cached'
    prompt_len: int
    submit_t: float             # time.perf_counter() stamp at submit
    finish_t: float             # time.perf_counter() stamp at finish
    admit_t: Optional[float] = None     # first slot claim
    first_token_t: Optional[float] = None
    swapped_s: float = 0.0              # time parked in the SwapStore
    recomputed_steps: int = 0           # decode ticks redone after preempt
    preemptions: int = 0
    # score() requests: log p(prompt[i] | prompt[:i]) for i = 1..L-1,
    # fp32 (L-1,); None for generate requests
    logprobs: Optional[np.ndarray] = None
    # speculative-decoding effort for this request (0 when speculate=0 or
    # served from cache): drafts accepted / proposed
    accepted: int = 0
    drafted: int = 0

    @property
    def latency(self) -> float:
        return self.finish_t - self.submit_t

    @property
    def queue_wait(self) -> float:
        """Submit -> admission. 0 for cache-served requests."""
        return self.admit_t - self.submit_t if self.admit_t is not None \
            else 0.0

    @property
    def ttft(self) -> float:
        """Submit -> first generated token (== latency when the request
        was served from cache or produced no token before finish)."""
        return self.first_token_t - self.submit_t \
            if self.first_token_t is not None else self.latency

    @property
    def prefill_s(self) -> float:
        """Admission -> first token: prompt consumption time."""
        if self.admit_t is None or self.first_token_t is None:
            return 0.0
        return self.first_token_t - self.admit_t

    @property
    def decode_s(self) -> float:
        """First token -> finish: pure generation time."""
        return self.finish_t - self.first_token_t \
            if self.first_token_t is not None else 0.0

    @property
    def itl(self) -> float:
        """Mean inter-token latency over the decode phase."""
        return self.decode_s / max(len(self.tokens) - 1, 1)


class RequestCache:
    """LRU memo: (prompt, params) -> completed tokens (greedy only).

    Sampled (temperature > 0) requests bypass the cache: they are not
    deterministic functions of the key. The request mode (score vs
    generate) and the sampling-policy fingerprint are part of the key, so
    a ``score()`` and a ``generate()`` of one prompt never alias.
    """

    def __init__(self, maxsize: int = 1024):
        self.maxsize = maxsize
        self._d: "collections.OrderedDict[Tuple, Tuple[np.ndarray, str, Optional[np.ndarray]]]" \
            = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(prompt: np.ndarray, max_new_tokens: int,
            eos_token: Optional[int], mode: str = "generate",
            policy: Tuple = ()) -> Tuple:
        # dtype and shape are part of the key: raw bytes alone collide for
        # int64([1]) vs int32([1, 0]) or a (4,) vs (2, 2) view of a buffer
        p = np.ascontiguousarray(prompt)
        return (p.tobytes(), p.dtype.str, p.shape,
                max_new_tokens, eos_token, mode, tuple(policy))

    def get(self, key: Tuple) \
            -> Optional[Tuple[np.ndarray, str, Optional[np.ndarray]]]:
        got = self._d.get(key)
        if got is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return got

    def put(self, key: Tuple, tokens: np.ndarray, reason: str,
            logprobs: Optional[np.ndarray] = None):
        # a frozen copy: the requester's Completion may hold the array it
        # was handed, and writing to it must not rewrite later hits
        tokens = np.asarray(tokens, np.int32).copy()
        tokens.setflags(write=False)
        if logprobs is not None:
            logprobs = np.asarray(logprobs, np.float32).copy()
            logprobs.setflags(write=False)
        self._d[key] = (tokens, reason, logprobs)
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


#: scheduler-owned counters, pre-declared at zero so stats() keys are
#: stable from construction
_COUNTER_KEYS = (
    "submitted", "admitted", "completed", "steps", "decode_steps",
    "chunk_steps", "generated_tokens", "prefill_tokens",
    "live_decode_slots", "preempted", "swapped_in", "swapped_out",
    "recomputed_decode_steps", "prefix_shared_tokens",
    # sharded pools: queue heads migrated off a full shard (0 otherwise)
    "steals",
    # speculative decoding (all 0 when speculate=0; real drafts only: the
    # teacher-forced ramp positions are not counted)
    "spec.drafted_tokens", "spec.accepted_tokens", "spec.rejected_tokens",
    "spec.rollbacks",
)


def _shard_seed(seed: int, shard: int) -> int:
    """Seed of shard ``shard``'s sampling generator on a pool of more than
    one shard: the first 63-bit word numpy's ``SeedSequence([seed,
    shard])`` generates, so the shards' streams are independent and a
    (seed, shard) pair always gives the same one."""
    word = np.random.SeedSequence([seed, shard]).generate_state(
        1, np.uint64)[0]
    return int(word >> np.uint64(1))


class _ShardObs:
    """Registry ``serve.shard`` provider (sharded pools only): the pool's
    per-shard occupancy (``shard<i>.live_slots`` / ``free_slots`` and block
    and swap levels) and the scheduler's ``shard<i>.placed`` / ``steals``
    / ``queued`` with the pool-wide ``steals``. The scheduler holds the
    strong reference (the registry keeps providers weakly)."""

    def __init__(self, sched: "Scheduler"):
        self._sched = sched

    def metrics(self) -> dict:
        sched = self._sched
        out = dict(sched.slots.shard_metrics())
        for s in range(sched.slots.num_shards):
            out[f"shard{s}.placed"] = sched._shard_placed[s]
            out[f"shard{s}.steals"] = sched._shard_steals[s]
            out[f"shard{s}.queued"] = len(sched._queues[s])
        out["num_shards"] = sched.slots.num_shards
        out["steals"] = int(sched.counters["steals"])
        return out


def _token_logprobs(logits: Tensor, targets: np.ndarray) -> np.ndarray:
    """log-softmax over the last axis of ``logits`` (..., V) in fp32, read
    at ``targets`` (...) on the device; only those values reach the host."""
    idx = torch.as_tensor(np.asarray(targets, np.int64)).to(logits.device)
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return lp.gather(-1, idx[..., None])[..., 0].cpu().numpy()


class Scheduler:
    """submit(prompts) / step() / drain() continuous-batching engine. The
    pool lives on the device of ``params``, or on ``mesh``'s devices (one
    shard each; needs ``SchedulerConfig.mesh_shards``)."""

    def __init__(self, cfg: ModelConfig, params,
                 sched: SchedulerConfig = SchedulerConfig(),
                 tracer: Optional[obs_trace.Tracer] = None,
                 draft_fn=None, mesh=None):
        self.cfg = cfg
        self.params = params
        self.sched = sched
        # draft source for speculate=k: draft_fn(seq, need) -> >= need
        # proposed next tokens given the committed sequence (prompt +
        # generated). None = the built-in prompt-lookup self-draft. Drafts
        # change only speed, never the stream (verify rejects disagreement)
        self._draft_fn = draft_fn
        for field, allowed in (("allocator", ("contiguous", "paged")),
                               ("preempt", ("recompute", "swap")),
                               ("admission", ("optimistic", "reserved")),
                               ("admit", ("continuous", "static"))):
            if getattr(sched, field) not in allowed:
                raise ValueError(f"SchedulerConfig.{field}="
                                 f"{getattr(sched, field)!r} not in {allowed}")
        if sched.prefix_sharing and sched.allocator != "paged":
            raise ValueError("prefix_sharing requires allocator='paged' "
                             "(blocks are the sharing granule)")
        if sched.placement not in ("least_blocks", "round_robin"):
            raise ValueError(f"SchedulerConfig.placement="
                             f"{sched.placement!r} not in "
                             "('least_blocks', 'round_robin')")
        if sched.mesh_shards is not None and sched.allocator != "paged":
            raise ValueError("mesh_shards requires allocator='paged' "
                             "(shards own per-shard block pools)")
        if mesh is not None and sched.mesh_shards is None:
            raise ValueError("Scheduler(mesh=...) needs "
                             "SchedulerConfig.mesh_shards set")
        if sched.speculate < 0:
            raise ValueError(f"speculate must be >= 0: {sched.speculate}")
        if sched.speculate:
            bad = [(s.mixer, s.mlp) for s in cfg.pattern
                   if s.mixer != "attn" or s.mlp == "rwkv_ffn"]
            if bad:
                raise ValueError(
                    "speculate requires an attention-only pattern with "
                    f"stateless MLPs (got {bad}): SSM/rwkv_ffn chunk "
                    "scans cannot roll back rejected drafts")
            min_view = min(_attn_view_len(s, sched.max_len)
                           for s in cfg.pattern)
            if sched.speculate + 1 > min_view:
                raise ValueError(
                    f"speculate={sched.speculate}: verify span "
                    f"{sched.speculate + 1} exceeds the smallest "
                    f"attention view length {min_view} (the rollback "
                    "scatter needs distinct ring rows)")
        # validates temperature/top_k/top_p ranges (ValueError on bad)
        engine.SamplingPolicy(sched.temperature, sched.top_k, sched.top_p)
        self.device = params.final_norm["scale"].device
        # a shared prefix ends on a chunk AND a block boundary: the sharer
        # skips whole chunk steps and maps whole blocks, so only lcm-aligned
        # prefixes chunk the rest of the prompt as an unshared run does
        self.slots = SlotManager(
            cfg, sched.num_slots, sched.max_len,
            paged=sched.allocator == "paged", block_size=sched.block_size,
            num_blocks=sched.num_blocks,
            paged_window=sched.paged_window_attn,
            num_window_blocks=sched.num_window_blocks,
            swap_bytes_budget=sched.swap_bytes_budget,
            prefix_sharing=sched.prefix_sharing,
            prefix_align=math.lcm(sched.prefill_chunk, sched.block_size),
            prefix_capacity=sched.prefix_index_capacity,
            mesh_shards=sched.mesh_shards, mesh=mesh, device=self.device)
        # one FCFS queue per shard (exactly one on unsharded pools, where
        # arrival order and head-of-line admission are the single queue's)
        n = self.slots.num_shards
        self._queues: List["collections.deque[_Slot]"] = [
            collections.deque() for _ in range(n)]
        self._rr_next = 0               # round_robin placement cursor
        # pluggable placement: fn(scheduler, _Slot) -> shard index;
        # overrides SchedulerConfig.placement when set
        self.placement_fn = None
        self._shard_placed = [0] * n
        self._shard_steals = [0] * n
        self._by_slot: Dict[int, _Slot] = {}
        self._inflight: Dict[Tuple, List[int]] = {}
        self._fresh: List[int] = []     # finished, not yet handed out
        self._tl: Dict[int, _Timeline] = {}
        self.results: Dict[int, Completion] = {}
        self.request_cache = RequestCache(sched.request_cache_size)
        self._gen = torch.Generator(device=self.device).manual_seed(
            sched.seed)
        # what a sampled tick draws from: the generator itself unsharded,
        # one a shard (each on its shard's device) on a sharded pool
        self._gens = self._gen
        if self.slots.sharded:
            devs = (mesh.devices if mesh is not None
                    else [self.device] * n)
            self._gens = [self._gen] if n == 1 else [
                torch.Generator(device=d).manual_seed(_shard_seed(
                    sched.seed, s)) for s, d in enumerate(devs)]
        self._next_rid = 0
        self._next_seq = 0          # admission sequence (preempt youngest)
        self.counters = collections.Counter(dict.fromkeys(_COUNTER_KEYS, 0))
        # per-request latency histograms (lifetime count/sum, windowed
        # p50/p95), fresh per scheduler
        self._lat = {name: obs_metrics.Histogram()
                     for name in ("queue_wait_ms", "ttft_ms", "itl_ms",
                                  "spec.accept_len")}
        # closed-loop actuator knobs (obs.control.BackpressureController):
        # admit_cap caps admissions per tick while an overload alert fires
        # (None = uncapped FCFS); preempt_override replaces the preemption
        # policy without touching the frozen config. Both change timing and
        # admission only, never a greedy stream.
        self.admit_cap: Optional[int] = None
        self.preempt_override: Optional[str] = None
        self._tracer = tracer
        # slot -> (phase name, t0, rid): the open per-slot phase span,
        # closed at first token / preempt / retire (tracer enabled only)
        self._open_phase: Dict[int, Tuple[str, float, int]] = {}
        obs_metrics.REGISTRY.register_provider("serve", self)
        self._shard_obs = None
        if self.slots.sharded:
            self._shard_obs = _ShardObs(self)
            obs_metrics.REGISTRY.register_provider("serve.shard",
                                                   self._shard_obs)

    @property
    def tracer(self) -> obs_trace.Tracer:
        return self._tracer if self._tracer is not None \
            else obs_trace.get_tracer()

    @property
    def preempt_policy(self) -> str:
        """The policy preempt-on-OOB uses this tick: the controller's
        override when backpressure is engaged, else the configured one."""
        return self.preempt_override or self.sched.preempt

    def _phase_begin(self, slot: int, name: str, rid: int):
        if self.tracer.enabled:
            self._open_phase[slot] = (name, time.perf_counter(), rid)

    def _phase_end(self, slot: int):
        open_ = self._open_phase.pop(slot, None)
        if open_ is not None:
            name, t0, rid = open_
            self.tracer.complete(name, f"slot{slot}", t0,
                                 time.perf_counter(), rid=rid)

    # -- submission ----------------------------------------------------------

    def submit(self, prompts: Sequence, max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None) -> List[int]:
        """Enqueue prompts (FCFS); returns request ids. Cached greedy
        repeats complete at once without touching the pool.
        temperature/top_k/top_p default to the SchedulerConfig values and
        form the batch's SamplingPolicy (validated here, ValueError). The
        whole batch is validated before any prompt is enqueued."""
        mnt = self.sched.max_new_tokens if max_new_tokens is None \
            else max_new_tokens
        policy = engine.SamplingPolicy(
            self.sched.temperature if temperature is None else temperature,
            self.sched.top_k if top_k is None else top_k,
            self.sched.top_p if top_p is None else top_p)
        if mnt < 1:
            raise ValueError("max_new_tokens must be >= 1")
        batch = []
        for p in prompts:
            p = np.asarray(p, np.int32).reshape(-1)
            if not 1 <= len(p) <= self.sched.max_len - mnt:
                raise ValueError(
                    f"prompt length {len(p)} + max_new {mnt} exceeds "
                    f"max_len {self.sched.max_len}")
            self._check_fits(len(p) + mnt)
            batch.append(p)
        return [self._accept(p, mnt, policy, "generate") for p in batch]

    def score(self, prompts: Sequence) -> List[int]:
        """Enqueue prompts for per-token logprob scoring; returns request
        ids. Each completion carries ``logprobs``, fp32 (L-1,) with
        ``logprobs[i-1] = log p(prompt[i] | prompt[:i])``, and no generated
        tokens (reason 'score'). Scoring rides the chunk and decode steps
        of prefill, teacher-forcing the prompt; results memoize under a
        score-mode key."""
        batch = []
        for p in prompts:
            p = np.asarray(p, np.int32).reshape(-1)
            if not 2 <= len(p) <= self.sched.max_len:
                raise ValueError(
                    f"score prompt length {len(p)} must be in "
                    f"[2, max_len={self.sched.max_len}]")
            self._check_fits(len(p))
            batch.append(p)
        policy = engine.SamplingPolicy()        # scoring is greedy-only
        return [self._accept(p, 0, policy, "score") for p in batch]

    def _check_fits(self, n_positions: int):
        """Progress guarantee of preempt-on-OOB: with every other slot
        evicted the oldest request must fit the whole pool, in every
        page-table group (ring demand clamps at the full ring)."""
        why = self.slots.fits_pool(n_positions)
        if why is not None:
            raise ValueError(why)

    def _accept(self, p: np.ndarray, mnt: int,
                policy: engine.SamplingPolicy, mode: str) -> int:
        """Give a validated prompt its rid, then serve it from the memo,
        coalesce it with an identical request in flight, or enqueue it."""
        rid = self._next_rid
        self._next_rid += 1
        self._tl[rid] = _Timeline(submit_t=time.perf_counter())
        self.counters["submitted"] += 1
        self.tracer.instant("submit", "scheduler", rid=rid, mode=mode)
        if self.sched.cache_requests and policy.greedy:
            key = RequestCache.key(p, mnt, self.sched.eos_token, mode=mode,
                                   policy=policy.fingerprint())
            if key in self._inflight:
                # an identical request is queued or decoding: ride its
                # completion (a burst of one hot prompt decodes once)
                self._inflight[key].append(rid)
                self.request_cache.hits += 1
                return rid
            got = self.request_cache.get(key)
            if got is not None:
                toks, _, lps = got
                self._finish(rid, len(p), toks.copy(), "cached",
                             logprobs=None if lps is None else lps.copy())
                return rid
            self._inflight[key] = []
        self._enqueue(_Slot(rid=rid, prompt=p, max_new_tokens=mnt,
                            policy=policy, mode=mode))
        return rid

    def _place(self, st: _Slot) -> int:
        """The home shard of a new request (0 on unsharded pools).
        'least_blocks' takes the shard with the most free blocks, ties to
        the shorter queue, then the lower index; 'round_robin' cycles;
        ``placement_fn`` overrides both."""
        n = self.slots.num_shards
        if n == 1:
            return 0
        if self.placement_fn is not None:
            shard = int(self.placement_fn(self, st))
            if not 0 <= shard < n:
                raise ValueError(f"placement_fn returned shard {shard} "
                                 f"(pool has {n})")
            return shard
        if self.sched.placement == "round_robin":
            shard = self._rr_next
            self._rr_next = (self._rr_next + 1) % n
            return shard
        return min(range(n),
                   key=lambda s: (-self.slots.shard_free_blocks(s),
                                  len(self._queues[s]), s))

    def _enqueue(self, st: _Slot):
        st.shard = self._place(st)
        self._shard_placed[st.shard] += 1
        self._queues[st.shard].append(st)

    # -- the scheduling loop -------------------------------------------------

    def step(self) -> List[Completion]:
        """One tick: admit, chunk-prefill, one decode, retire. Returns every
        completion not yet handed out, including requests finished at
        submit time by the request cache."""
        self._admit()
        self._prefill_chunks()
        self._decode_once()
        self.counters["steps"] += 1
        out = [self.results[rid] for rid in self._fresh]
        self._fresh.clear()
        obs_sampler.tick("serve.step")
        return out

    def drain(self) -> List[Completion]:
        """Run until queue and pool are empty; returns the completions not
        yet handed out (by an earlier step() or drain()), in rid order.
        ``results`` archives every completion until the caller pops it."""
        fresh: List[int] = []
        while any(self._queues) or self._by_slot:
            fresh.extend(c.rid for c in self.step())
        fresh.extend(self._fresh)   # cache hits finished at submit time
        self._fresh.clear()
        return [self.results[rid] for rid in sorted(fresh)]

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues)

    @property
    def live(self) -> int:
        return len(self._by_slot)

    def metrics(self) -> dict:
        """Registry 'serve' provider: every counter, queue/pool levels,
        cache rates, the latency histograms (``<name>.<field>``) and the
        overload signal and actuator knobs the SLO/control loop reads.
        ``stats()`` = this + the slot pool's keys."""
        decode_steps = self.counters["decode_steps"]
        heads = [q[0] for q in self._queues if q]
        # the oldest queue head across shards (one queue unsharded)
        head_wait = (time.perf_counter() - min(
            self._tl[st.rid].submit_t for st in heads)) if heads else 0.0
        out = {**{k: int(v) for k, v in self.counters.items()},
               "pending": self.pending,
               "live": len(self._by_slot),
               "coalesced_waiting": sum(
                   len(v) for v in self._inflight.values()),
               "cache_hits": self.request_cache.hits,
               "cache_misses": self.request_cache.misses,
               "cache_hit_rate": round(self.request_cache.hit_rate, 4),
               "mean_occupancy": round(
                   self.counters["live_decode_slots"] / decode_steps, 4)
               if decode_steps else 0.0,
               "queue_head_wait_s": round(head_wait, 6),
               "admit_cap": -1 if self.admit_cap is None
               else int(self.admit_cap),
               "preempt_policy": self.preempt_policy}
        for name, h in self._lat.items():
            for k, v in h.summary().items():
                out[f"{name}.{k}"] = v
        return out

    def stats(self) -> dict:
        return {**self.metrics(), **self.slots.stats()}

    # -- internals -----------------------------------------------------------

    def _admit(self):
        """FCFS per shard with head-of-line blocking: while a queue head
        cannot admit (no free slot, or, paged, not its blocks) nothing
        behind it on that shard jumps the line; the steal pass runs first.
        While backpressure is engaged, at most ``admit_cap`` requests
        admit per tick (still in FCFS order)."""
        if self.sched.admit == "static" and self._by_slot:
            return      # static batching: wait for the whole batch
        self._steal_rebalance()
        admitted = 0
        for shard, q in enumerate(self._queues):
            while q:
                if self.admit_cap is not None and admitted >= self.admit_cap:
                    return
                if not self._admit_head(shard, q):
                    break           # head-of-line blocked: next shard
                admitted += 1

    def _head_admissible(self, shard: int, st: _Slot) -> bool:
        """Could ``st`` admit now? A swapped-out request checks the shard
        whose store holds its entry, a fresh one ``shard``: the checks
        ``_admit_head`` makes before it claims."""
        if self.slots.is_swapped(st.rid):
            return self.slots.can_admit_swapped(st.rid)
        need = len(st.prompt) + (
            st.max_new_tokens if self.sched.admission == "reserved" else 0)
        pr = st.prompt if st.mode == "generate" else None
        return self.slots.can_admit(
            need, prompt=pr, span=len(st.prompt) + st.max_new_tokens,
            shard=shard if self.slots.sharded else None)

    def _steal_rebalance(self):
        """Work stealing (sharded pools): a queue head that cannot admit
        on its home shard moves to an IDLE shard (empty queue) that can
        admit it now, the one with the most free blocks, instead of
        blocking behind a full shard. A swapped-out head moves its host
        swap entry between the shards' stores (budget and blocks checked
        first; a refusal means no steal), so it keeps its progress."""
        n = self.slots.num_shards
        if not self.sched.steal or n < 2:
            return
        for s, q in enumerate(self._queues):
            if not q:
                continue
            st = q[0]
            if self._head_admissible(s, st):
                continue            # admits normally this tick
            swapped = self.slots.is_swapped(st.rid)
            cands = [d for d in range(n)
                     if d != s and not self._queues[d]
                     and (self.slots.can_steal_swapped(st.rid, d)
                          if swapped else self._head_admissible(d, st))]
            if not cands:
                continue
            d = max(cands, key=self.slots.shard_free_blocks)
            if swapped and not self.slots.migrate_swapped(st.rid, d):
                continue
            q.popleft()
            st.shard = d
            self._queues[d].append(st)
            self.counters["steals"] += 1
            self._shard_steals[d] += 1
            self.tracer.instant("steal", "scheduler", rid=st.rid,
                                src_shard=s, dst_shard=d)

    def _admit_head(self, shard: int, q) -> bool:
        """Try to admit ``q``'s head onto ``shard``; True = admitted (and
        popped), False = head-of-line blocked."""
        st = q[0]
        sh = shard if self.slots.sharded else None
        swapped_in = False
        if self.slots.is_swapped(st.rid):
            # resume a swap-preempted request: its saved blocks are remapped
            # and uploaded; it continues at st.ctx with st.out intact
            got = self.slots.swap_in(st.rid)
            if got is None:
                return False
            slot, _ = got
            self.counters["swapped_in"] += 1
            swapped_in = True
        else:
            # reserved admission books the whole generation budget up
            # front, so growth never runs out (submit checked it fits);
            # prefix sharing needs the prompt and the request's span (ring
            # groups share only when no write wraps into the shared
            # prefix). Score rows never share: the chunk steps a shared
            # prefix skips are what scoring reads.
            need = len(st.prompt) + (
                st.max_new_tokens
                if self.sched.admission == "reserved" else 0)
            span = len(st.prompt) + st.max_new_tokens
            pr = st.prompt if st.mode == "generate" else None
            if not self.slots.can_admit(need, prompt=pr, span=span,
                                        shard=sh):
                return False
            slot = self.slots.alloc(st.rid, prompt_len=need, prompt=pr,
                                    span=span, shard=sh)
            start = self.slots.prefill_start(slot)
            if start:
                # the leading `start` positions were mapped to index-held
                # blocks whose KV exists: prefill resumes past them, at the
                # chunk offsets an unshared run uses
                st.ctx = start
                st.chunk_tokens = start
                self.counters["prefix_shared_tokens"] += start
        q.popleft()
        st.admit_seq = self._next_seq
        self._next_seq += 1
        self._by_slot[slot] = st
        self.counters["admitted"] += 1
        now = time.perf_counter()
        tl = self._tl[st.rid]
        if tl.admit_t is None:
            tl.admit_t = now        # first admission only (queue wait)
            self._lat["queue_wait_ms"].observe((now - tl.submit_t) * 1e3)
        if swapped_in:
            if tl.swap_out_t is not None:
                tl.swapped_s += now - tl.swap_out_t
                tl.swap_out_t = None
            self.tracer.instant("swap-in", f"slot{slot}", rid=st.rid)
        else:
            self.tracer.instant("admit", f"slot{slot}", rid=st.rid,
                                prompt_len=len(st.prompt))
        self._phase_begin(slot, "prefill" if st.ctx < len(st.prompt)
                          else "decode", st.rid)
        return True

    def _preempt(self, slot: int):
        """Evict a live slot to free its blocks (paged growth failure); the
        request re-queues at the FRONT. Under preempt='recompute' it
        restarts from scratch and every decode step it had consumed is
        counted in 'recomputed_decode_steps'. Under preempt='swap' its
        block bytes move to the host SwapStore and it later resumes at
        st.ctx, unless the store's budget rejects them (the store counts
        that, stats()['swap_rejected']): then it recomputes."""
        st = self._by_slot.pop(slot)
        self._phase_end(slot)
        tl = self._tl[st.rid]
        swapped = False
        if self.preempt_policy == "swap":
            swapped = self.slots.swap_out(slot) is not None
            if swapped:
                self.counters["swapped_out"] += 1
                tl.swap_out_t = time.perf_counter()
                self.tracer.instant("swap-out", f"slot{slot}", rid=st.rid)
        if not swapped:
            self.slots.release(slot)
            # the decode ticks this victim consumed (ctx minus chunk-step
            # tokens), which the restart pays for again
            wasted = st.ctx - st.chunk_tokens
            self.counters["recomputed_decode_steps"] += wasted
            tl.recomputed_steps += wasted
            tl.first_token_t = None     # the restart re-earns its TTFT
            self.tracer.instant("preempt", f"slot{slot}", rid=st.rid,
                                wasted_steps=wasted)
            st.ctx = 0
            st.chunk_tokens = 0
            st.out = []
            st.logprobs = []    # a score restart collects from scratch
        st.admit_seq = -1
        # back to the FRONT of its home shard's queue (the shard the slot
        # lived on, where a swapped entry's bytes are parked)
        st.shard = self.slots.shard_of_slot(slot)
        self._queues[st.shard].appendleft(st)
        self.counters["preempted"] += 1
        tl.preemptions += 1

    def _ensure_or_preempt(self, slot: int, upto_pos: int,
                           write_from: Optional[int] = None) -> bool:
        """Grow ``slot``'s storage to cover ``upto_pos``; on block
        exhaustion evict the youngest live slot and retry. The oldest live
        request is only ever evicted by itself (when nothing younger is
        left), and submit checked that it fits an empty pool, so the pool
        always makes progress. ``write_from`` bounds the copy-on-write scan
        (a verify tick writes a span, not one position). Returns False iff
        ``slot`` was preempted. Victims come from the grower's own shard:
        block pools are per shard, so evicting elsewhere frees nothing it
        can use."""
        shard = self.slots.shard_of_slot(slot)
        while not self.slots.ensure(slot, upto_pos, write_from=write_from):
            victim = max((s for s in self._by_slot
                          if self.slots.shard_of_slot(s) == shard),
                         key=lambda s: self._by_slot[s].admit_seq)
            self._preempt(victim)
            if victim == slot:
                return False
        return True

    def _prefill_chunks(self):
        """Consume every pending full chunk (first L-1 prompt tokens only;
        the final token always rides the decode step, so decode is the one
        sampler). Each round runs one chunk over exactly the slots that
        need one."""
        ch = self.sched.prefill_chunk
        while True:
            need = [s for s, st in sorted(self._by_slot.items())
                    if len(st.prompt) - 1 - st.ctx >= ch]
            if not need:
                return
            sts = [self._by_slot[s] for s in need]
            for s, st in zip(need, sts):
                # prompts are mapped whole at admission, so a chunk never
                # needs a new block; write_from bounds the copy-on-write
                # scan to the chunk's span, which starts at or past a
                # shared prefix
                if not self.slots.ensure(s, st.ctx + ch - 1,
                                         write_from=st.ctx):
                    raise RuntimeError(
                        "prefill chunk outgrew the admission mapping")
            toks = np.stack([st.prompt[st.ctx:st.ctx + ch] for st in sts])
            pos = np.asarray([st.ctx for st in sts], np.int64)
            with self.tracer.span("prefill-chunk", "scheduler",
                                  slots=len(need), chunk=ch):
                logits = self.slots.run_chunk(
                    self.params, need, self._tensor(toks, torch.int64),
                    self._tensor(pos, torch.int64))
            score_rows = [j for j, st in enumerate(sts)
                          if st.mode == "score"]
            if score_rows:
                # logits[j, i] predicts position ctx+i+1, a prompt position
                # (the chunk condition keeps ctx+ch <= L-1)
                fed = np.stack([sts[j].prompt[sts[j].ctx + 1:
                                              sts[j].ctx + ch + 1]
                                for j in score_rows])
                lp = _token_logprobs(logits[score_rows], fed)
                for row, j in enumerate(score_rows):
                    sts[j].logprobs.extend(float(x) for x in lp[row])
            for st in sts:
                st.ctx += ch
                st.chunk_tokens += ch
            self.counters["chunk_steps"] += 1
            self.counters["prefill_tokens"] += len(need) * ch
            # a score row whose last needed position (L-2) was just
            # consumed is complete without ever decoding
            for s, st in zip(need, sts):
                if st.mode == "score" and st.ctx >= len(st.prompt) - 1:
                    self._retire(s, "score")

    def _tensor(self, x: np.ndarray, dtype) -> Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    def _max_commit(self, st: _Slot) -> int:
        """Last cache position a verify tick may commit for ``st``:
        generate rows never feed past the position producing their final
        token (L + max_new - 2), score rows past the one producing the last
        prompt logprob (L - 2)."""
        ln = len(st.prompt)
        return ln - 2 if st.mode == "score" else ln + st.max_new_tokens - 2

    def _first_token(self, slot: int, st: _Slot):
        """First generated token: TTFT stamp, the prefill -> decode phase
        flip, and publication of the prompt's chunk-consumed blocks to the
        prefix index (a no-op without prefix sharing)."""
        tl = self._tl[st.rid]
        if tl.first_token_t is None:
            tl.first_token_t = time.perf_counter()
            self._lat["ttft_ms"].observe(
                (tl.first_token_t - tl.submit_t) * 1e3)
        self._phase_end(slot)
        self._phase_begin(slot, "decode", st.rid)
        self.slots.register_prefix(
            slot, st.prompt, len(st.prompt) + st.max_new_tokens,
            st.chunk_tokens)

    def _decode_once(self):
        """One decode over the FULL pool: per-slot tokens, positions and
        sampling policies. Free slots feed token 0 at position 0, a row in
        bounds of every cache leaf (ring writes go to pos % slots), and
        their results are never read. With ``speculate=k`` the tick is a
        verify tick instead (``_decode_speculative``)."""
        if not self._by_slot:
            return
        if self.sched.speculate:
            self._decode_speculative(self.sched.speculate)
            return
        if self.slots.paged:
            # every live slot writes its cache at position ctx this tick:
            # map the covering blocks, preempting youngest-first on OOB
            for s in sorted(self._by_slot):
                if s in self._by_slot:
                    self._ensure_or_preempt(s, self._by_slot[s].ctx)
            if not self._by_slot:
                return
        b = self.slots.num_slots
        toks = np.zeros((b, 1), np.int64)
        pos = np.zeros((b,), np.int64)
        temps = np.zeros((b,), np.float32)
        top_ks = np.zeros((b,), np.int64)
        top_ps = np.ones((b,), np.float32)
        for s, st in self._by_slot.items():
            toks[s, 0] = (st.prompt[st.ctx] if st.ctx < len(st.prompt)
                          else st.out[-1])
            pos[s] = st.ctx
            temps[s] = st.policy.temperature
            top_ks[s] = st.policy.top_k
            top_ps[s] = st.policy.top_p
        sampled = bool((temps > 0).any())
        with self.tracer.span("decode-tick", "scheduler",
                              live=len(self._by_slot)):
            nxt, logits = self.slots.run_decode(
                self.params, self._tensor(toks, torch.int64),
                self._tensor(pos, torch.int64),
                self._tensor(temps, torch.float32),
                self._gens if sampled else None,
                self._tensor(top_ks, torch.int64) if sampled else None,
                self._tensor(top_ps, torch.float32) if sampled else None)
            nxt = nxt.cpu().numpy()
        self.counters["decode_steps"] += 1
        # mean live slots per decode tick = live_decode_slots / decode_steps
        self.counters["live_decode_slots"] += len(self._by_slot)
        score_live = sorted(s for s, st in self._by_slot.items()
                            if st.mode == "score")
        lp = {}
        if score_live:
            # the token fed at ctx predicts position ctx+1, a prompt
            # position (score rows retire before ctx reaches L-1)
            fed = [self._by_slot[s].prompt[self._by_slot[s].ctx + 1]
                   for s in score_live]
            lp = dict(zip(score_live, _token_logprobs(
                logits[score_live, 0], np.asarray(fed))))

        for s in sorted(self._by_slot):
            st = self._by_slot[s]
            if st.mode == "score":
                st.logprobs.append(float(lp[s]))
                st.ctx += 1
                if st.ctx >= len(st.prompt) - 1:
                    self._retire(s, "score")
                continue
            st.ctx += 1
            if st.ctx < len(st.prompt):
                continue                            # still teacher-forcing
            tok = int(nxt[s])
            st.out.append(tok)
            self.counters["generated_tokens"] += 1
            if len(st.out) == 1:
                self._first_token(s, st)
            eos = (self.sched.eos_token is not None
                   and tok == self.sched.eos_token)
            if eos or len(st.out) >= st.max_new_tokens:
                self._retire(s, "eos" if eos else "length")

    # -- speculative decoding ------------------------------------------------

    @staticmethod
    def _lookup_draft(seq: np.ndarray, need: int) -> List[int]:
        """Prompt-lookup self-draft: find the most recent earlier
        occurrence of the sequence's trailing 2-gram and copy the tokens
        that followed it; repeat the last token when nothing matches."""
        n = len(seq)
        drafts: List[int] = []
        if n >= 3:
            a, b = int(seq[-2]), int(seq[-1])
            for i in range(n - 3, -1, -1):
                if int(seq[i]) == a and int(seq[i + 1]) == b:
                    j = i + 2
                    while len(drafts) < need and j < n:
                        drafts.append(int(seq[j]))
                        j += 1
                    break
        last = int(seq[-1]) if n else 0
        while len(drafts) < need:
            drafts.append(last)
        return drafts

    def _draft_tokens(self, st: _Slot, k: int) -> List[int]:
        """k draft tokens for positions ctx+1..ctx+k: the true prompt
        tokens through the teacher-forced ramp (the accepted span is written
        to the cache), then ``draft_fn`` or the prompt-lookup self-draft."""
        ln = len(st.prompt)
        out = [int(t) for t in st.prompt[st.ctx + 1:min(st.ctx + 1 + k, ln)]]
        need = k - len(out)
        if need:
            seq = (st.prompt if not st.out
                   else np.concatenate([st.prompt,
                                        np.asarray(st.out, np.int32)]))
            if self._draft_fn is not None:
                got = [int(t) for t in self._draft_fn(seq, need)][:need]
                out.extend(got)
                need -= len(got)
            if need:                    # no draft_fn, or a short draft
                out.extend(self._lookup_draft(seq, need))
        return out

    def _decode_speculative(self, k: int):
        """One verify-accept tick over the FULL pool: feed k+1 tokens per
        slot (the true next token and k drafts) through the chunk path,
        accept each row's agreeing draft prefix, emit up to k+1 tokens.
        Rejected cache writes were rolled back, so host state advances by
        exactly what was committed. Three device-to-host reads per tick:
        the tokens, the accept counts and the logprobs."""
        if self.slots.paged:
            for s in sorted(self._by_slot):
                if s in self._by_slot:
                    st = self._by_slot[s]
                    # the span writes [ctx, ctx+k]; only positions that may
                    # commit need mapped blocks (rolled-back writes past the
                    # mapping land in the trash block, never read unmasked)
                    upto = max(min(st.ctx + k, self._max_commit(st)),
                               st.ctx)
                    self._ensure_or_preempt(s, upto, write_from=st.ctx)
            if not self._by_slot:
                return
        b = self.slots.num_slots
        toks = np.zeros((b, k + 1), np.int64)
        pos = np.zeros((b,), np.int64)
        plen = np.ones((b,), np.int64)
        maxp = np.zeros((b,), np.int64)
        score_f = np.zeros((b,), bool)
        active = np.zeros((b,), bool)
        temps = np.zeros((b,), np.float32)
        top_ks = np.zeros((b,), np.int64)
        top_ps = np.ones((b,), np.float32)
        for s, st in self._by_slot.items():
            first = (st.prompt[st.ctx] if st.ctx < len(st.prompt)
                     else st.out[-1])
            toks[s] = [int(first)] + self._draft_tokens(st, k)
            pos[s] = st.ctx
            plen[s] = len(st.prompt)
            maxp[s] = self._max_commit(st)
            score_f[s] = st.mode == "score"
            active[s] = True
            temps[s] = st.policy.temperature
            top_ks[s] = st.policy.top_k
            top_ps[s] = st.policy.top_p
        sampled = bool((temps > 0).any())
        with self.tracer.span("decode-tick", "scheduler",
                              live=len(self._by_slot), speculate=k):
            out_tok, acc_n, lp = self.slots.run_verify(
                self.params, self._tensor(toks, torch.int64),
                self._tensor(pos, torch.int64),
                self._tensor(plen, torch.int64),
                self._tensor(maxp, torch.int64),
                self._tensor(score_f, torch.bool),
                self._tensor(active, torch.bool),
                self._tensor(temps, torch.float32),
                self._tensor(top_ks, torch.int64) if sampled else None,
                self._tensor(top_ps, torch.float32) if sampled else None,
                self._gens if sampled else None)
            out_tok = out_tok.cpu().numpy()
            acc_n = acc_n.cpu().numpy()
            lp = lp.cpu().numpy()
        self.counters["decode_steps"] += 1
        self.counters["live_decode_slots"] += len(self._by_slot)

        tick_accepts: List[int] = []
        for s in sorted(self._by_slot):
            st = self._by_slot[s]
            n = int(acc_n[s])
            adv = n + 1
            base = st.ctx
            ln = len(st.prompt)
            if st.mode == "score":
                # lp[i] scores the token fed at chunk slot i+1 (position
                # base+i+1), a prompt token for every i <= n (score rows
                # accept at most k-1)
                st.logprobs.extend(float(lp[s, i]) for i in range(adv))
                st.ctx = base + adv
                if st.ctx >= ln - 1:
                    self._retire(s, "score")
                continue
            if st.policy.greedy:
                # real drafts only: ramp positions are teacher-forced prompt
                # tokens, not speculation
                forced = max(0, min(ln - (base + 1), k))
                real_drafted = k - forced
                real_accepted = max(n - forced, 0)
                rejected = real_drafted - real_accepted
                st.drafted += real_drafted
                st.accepted += real_accepted
                self.counters["spec.drafted_tokens"] += real_drafted
                self.counters["spec.accepted_tokens"] += real_accepted
                self.counters["spec.rejected_tokens"] += rejected
                if rejected > 0:
                    self.counters["spec.rollbacks"] += 1
                if real_drafted > 0:
                    self._lat["spec.accept_len"].observe(
                        float(real_accepted))
                    tick_accepts.append(real_accepted)
            st.ctx = base + adv
            for i in range(adv):
                if base + i + 1 < ln:
                    continue                        # still teacher-forcing
                tok = int(out_tok[s, i])
                st.out.append(tok)
                self.counters["generated_tokens"] += 1
                if len(st.out) == 1:
                    self._first_token(s, st)
                eos = (self.sched.eos_token is not None
                       and tok == self.sched.eos_token)
                if eos or len(st.out) >= st.max_new_tokens:
                    # tokens past an EOS were committed to the cache, but
                    # the slot retires here and release discards them
                    self._retire(s, "eos" if eos else "length")
                    break
        if tick_accepts and self.tracer.enabled:
            # Perfetto counter track: accepted draft length per tick
            self.tracer.counter("spec.accept_len", "scheduler",
                                mean=float(np.mean(tick_accepts)),
                                max=float(np.max(tick_accepts)))

    def _retire(self, slot: int, reason: str):
        st = self._by_slot.pop(slot)
        self._phase_end(slot)
        self.tracer.instant("retire", f"slot{slot}", rid=st.rid,
                            reason=reason)
        self.slots.release(slot)
        toks = np.asarray(st.out, np.int32)
        lps = (np.asarray(st.logprobs, np.float32)
               if st.mode == "score" else None)
        if self.sched.cache_requests and st.policy.greedy:
            key = RequestCache.key(st.prompt, st.max_new_tokens,
                                   self.sched.eos_token, mode=st.mode,
                                   policy=st.policy.fingerprint())
            self.request_cache.put(key, toks, reason, lps)
            for rid in self._inflight.pop(key, ()):     # coalesced waiters
                self._finish(rid, len(st.prompt), toks.copy(), "cached",
                             logprobs=None if lps is None else lps.copy())
        self._finish(st.rid, len(st.prompt), toks, reason, logprobs=lps,
                     accepted=st.accepted, drafted=st.drafted)

    def _finish(self, rid: int, prompt_len: int, tokens: np.ndarray,
                reason: str, logprobs: Optional[np.ndarray] = None,
                accepted: int = 0, drafted: int = 0):
        self.counters["completed"] += 1
        self._fresh.append(rid)
        tl = self._tl.pop(rid)
        comp = Completion(
            rid=rid, tokens=tokens, reason=reason, prompt_len=prompt_len,
            submit_t=tl.submit_t, finish_t=time.perf_counter(),
            admit_t=tl.admit_t, first_token_t=tl.first_token_t,
            swapped_s=tl.swapped_s, recomputed_steps=tl.recomputed_steps,
            preemptions=tl.preemptions, logprobs=logprobs,
            accepted=accepted, drafted=drafted)
        self.results[rid] = comp
        # ITL only means something for pool-served requests
        if tl.admit_t is not None and tl.first_token_t is not None:
            self._lat["itl_ms"].observe(comp.itl * 1e3)
