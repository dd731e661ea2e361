"""Serving steps: prefill, single-token decode, chunked prefill and the
per-request ``generate`` (port of ``repro.serve.engine``).

Decode is the dependency-bound 1-D recurrence of serving: each step
consumes the previous step's cache. Attention layers carry bf16 KV ring
buffers; RWKV layers carry O(1) recurrent state, so their decode cost is
flat in context length. The steps are plain functions under
``torch.inference_mode()``; there is no jit. On the card a prefill runs
the kernels (``flash_attention``, ``ssm_scan``); a chunk runs ``ssm_scan``
from the carried state, and its attention, like a decode step's, is the
plain ``blockwise_attention`` over the cache, so ``generate`` launches no
``flash_attention``. Sampling at
``temperature > 0`` draws Gumbel noise from a ``torch.Generator`` (the
reference's Gumbel-max), so only greedy streams equal the reference's.

The paged steps split the caches into dense per-slot leaves and flat block
pools read through page tables (``serve.paging``): each gathers a per-slot
view of every paged layer, runs the plain step on the merged tree and
writes the views back into the pools in place. The block-row functions
reset, gather, upload and copy whole blocks of every pool (the device half
of block mapping, swap and copy-on-write).

The verify step (speculative decoding) teacher-forces a row's next token
and k drafts through the chunk path, accepts the agreeing prefix, and
rolls the rejected cache writes back from a snapshot of the written span;
its paged form runs it on the gathered views.

The sharded steps (``make_sharded_decode_step``, ``_chunk_``,
``_verify_``) serve a slot pool split into shards, each with its own block
pools (``serve/slots._ShardedPagedBacking``). Without a mesh the shards'
segments are stacked back to back in one set of tensors, and a step is ONE
paged step over the whole stack: the caller hands it rows already offset
into each shard's segment (``stacked_rows``), so a tick launches what an
unsharded tick launches, with no loop over shards. At one shard that step
is the unsharded paged step itself. With a mesh each shard's segment
lives on its own device, the step runs there per shard, and the outputs
gather on the mesh's first device.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention
from repro_torch.models import transformer as T

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SamplingPolicy:
    """Per-request sampling knobs threaded through the decode steps.

    ``temperature <= 0`` is greedy (exact argmax of the raw logits).
    ``top_k = 0`` disables top-k; ``top_p = 1.0`` disables nucleus
    filtering. Both filters are exact identities when disabled.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0: {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables): {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1]: {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def fingerprint(self):
        """Hashable identity for memo keys (RequestCache, coalescing)."""
        return (float(self.temperature), int(self.top_k), float(self.top_p))


def _filter_topk_topp(lg: Tensor, top_ks: Tensor, top_ps: Tensor) -> Tensor:
    """Mask logits (B, V) outside the per-row top-k / nucleus sets to -inf.

    top_ks (B,) int (0 = disabled) and top_ps (B,) fp32 (1.0 = disabled)
    are value thresholds against the descending sort: ties at the cut
    survive together, and a disabled filter keeps every entry.
    """
    v = lg.shape[-1]
    srt = torch.sort(lg, dim=-1, descending=True).values
    k = torch.clamp(torch.where(top_ks <= 0, v, top_ks), 1, v).to(torch.int64)
    kth = torch.take_along_dim(srt, (k - 1)[:, None], dim=-1)
    keep_k = lg >= kth
    # exclusive cumsum of sorted probs: entry i kept iff the mass strictly
    # before it is < top_p; always keeps the argmax, disabled at p = 1.
    probs = torch.softmax(srt, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs
    nk = torch.clamp_min(torch.sum((cum < top_ps[:, None]).to(torch.int64),
                                   dim=-1), 1)
    nth = torch.take_along_dim(srt, (nk - 1)[:, None], dim=-1)
    keep_p = lg >= nth
    return torch.where(keep_k & keep_p, lg, -torch.inf)


def _gumbel(shape, generator, device) -> Tensor:
    """Gumbel noise of ``shape`` from ``generator``, or, given a sequence
    of generators, each one's equal slice of the rows (one a shard)."""
    tiny = torch.finfo(torch.float32).tiny
    if isinstance(generator, torch.Generator):
        u = torch.rand(shape, generator=generator, device=device,
                       dtype=torch.float32)
    else:
        part = (shape[0] // len(generator),) + tuple(shape[1:])
        u = torch.cat([torch.rand(part, generator=g, device=device,
                                  dtype=torch.float32) for g in generator])
    return -torch.log(-torch.log(torch.clamp_min(u, tiny)))


def sample_token(logits: Tensor, generator: Optional[torch.Generator] = None,
                 temperature=0.0, top_k=0, top_p=1.0) -> Tensor:
    """logits: (B, 1, V) -> (B,) int64. temperature 0 = greedy.

    ``temperature``, ``top_k`` and ``top_p`` may be python scalars or (B,)
    tensors (per-slot knobs). Sampling is Gumbel-max
    (``argmax(l / T + g)``) with noise from ``generator`` (a sequence of
    generators draws each one's equal slice of the rows: a sharded pool's
    per-shard streams); greedy rows stay exactly the argmax of the raw
    logits whatever the filters.
    """
    lg = logits[:, -1].to(torch.float32)
    greedy = torch.argmax(lg, dim=-1)
    b = lg.shape[0]
    scalars = (isinstance(temperature, (int, float))
               and isinstance(top_k, int)
               and isinstance(top_p, (int, float)))
    if scalars:
        if temperature <= 0.0 or generator is None:
            return greedy
        if top_k > 0 or top_p < 1.0:                # skip the sort when off
            lg = _filter_topk_topp(
                lg, torch.full((b,), top_k, device=lg.device),
                torch.full((b,), top_p, dtype=torch.float32,
                           device=lg.device))
        return torch.argmax(lg / temperature
                            + _gumbel(lg.shape, generator, lg.device), dim=-1)
    temps = torch.as_tensor(temperature, dtype=torch.float32,
                            device=lg.device).expand(b)
    ks = torch.as_tensor(top_k, device=lg.device).expand(b)
    ps = torch.as_tensor(top_p, dtype=torch.float32,
                         device=lg.device).expand(b)
    if generator is None:
        if bool((temps > 0.0).any()):
            raise ValueError("sampling at temperature > 0 needs a generator")
        return greedy
    filt = _filter_topk_topp(lg, ks, ps)
    scaled = (filt / torch.clamp_min(temps, 1e-6)[:, None]
              + _gumbel(lg.shape, generator, lg.device))
    sampled = torch.argmax(scaled, dim=-1)
    return torch.where(temps > 0.0, sampled, greedy)


def make_prefill_step(cfg: ModelConfig, cache_slots: int,
                      use_kernels: bool = True):
    """prefill(params, {"tokens"|"embeds": ...}) -> (last_logits, caches)."""

    @torch.inference_mode()
    def prefill(params, batch: Dict[str, Tensor]):
        logits, _, caches = T.apply_model(
            params, cfg, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), mode="prefill",
            cache_slots=cache_slots, use_kernels=use_kernels)
        return logits, caches

    return prefill


def make_decode_step(cfg: ModelConfig, temperature: float = 0.0):
    """decode(params, caches, inp, pos[, generator]) -> (next_tok, logits,
    caches). inp: {"tokens": (B, 1)} or {"embeds": (B, 1, D)}; pos: the
    absolute position of the incoming token."""

    @torch.inference_mode()
    def decode(params, caches, inp: Dict[str, Tensor], pos,
               generator: Optional[torch.Generator] = None):
        logits, _, caches = T.apply_model(
            params, cfg, tokens=inp.get("tokens"),
            embeds=inp.get("embeds"), mode="decode", caches=caches,
            pos_scalar=pos)
        nxt = sample_token(logits, generator, temperature)
        return nxt, logits, caches

    return decode


def make_slot_decode_step(cfg: ModelConfig):
    """decode(params, caches, tokens, pos, temps, generator[, top_ks,
    top_ps]) -> (next_tok, logits, caches) with per-slot clocks and
    sampling knobs: tokens (B, 1), pos (B,), temps (B,) fp32 (0 = greedy),
    top_ks (B,) / top_ps (B,) optional (None = disabled)."""

    @torch.inference_mode()
    def decode(params, caches, tokens: Tensor, pos: Tensor, temps: Tensor,
               generator: Optional[torch.Generator],
               top_ks: Optional[Tensor] = None,
               top_ps: Optional[Tensor] = None):
        logits, _, caches = T.apply_model(
            params, cfg, tokens=tokens, mode="decode", caches=caches,
            pos_scalar=pos)
        nxt = sample_token(logits, generator, temps,
                           0 if top_ks is None else top_ks,
                           1.0 if top_ps is None else top_ps)
        return nxt, logits, caches

    return decode


def make_chunk_step(cfg: ModelConfig):
    """chunk(params, caches, tokens, pos) -> (logits (B, C, V), caches).

    Chunked prefill: tokens (B, C) are C consecutive tokens per row from
    absolute position pos[b]; attention appends the chunk to the cache and
    masks by absolute position, RWKV layers run the state-carried scan
    (the kernel on the card). Every row carries a full chunk; logits cover
    every chunk position."""

    @torch.inference_mode()
    def chunk(params, caches, tokens: Tensor, pos: Tensor):
        logits, _, caches = T.apply_model(
            params, cfg, tokens=tokens, mode="decode", caches=caches,
            pos_scalar=pos)
        return logits, caches

    return chunk


# ---------------------------------------------------------------------------
# speculative verify-accept: teacher-force k drafts through the chunk path,
# accept the agreeing prefix, roll the cache back
# ---------------------------------------------------------------------------

def _ring_gather(leaf: Tensor, idx: Tensor) -> Tensor:
    """Ring rows ``idx`` (B, S) of a cache leaf (P, B, slots, ...) along the
    slot axis (index 2), modulo that leaf's view length: (P, B, S, ...)."""
    rows = torch.arange(leaf.shape[1], device=leaf.device)[:, None]
    return leaf[:, rows, idx % leaf.shape[2]]


def _ring_scatter(leaf: Tensor, idx: Tensor, rows: Tensor) -> Tensor:
    """Inverse of _ring_gather, in place: write ``rows`` (P, B, S, ...) back
    at ring indices ``idx`` (B, S); returns ``leaf``. The indices of one row
    are distinct (the scheduler keeps the verify span within the smallest
    view length), and rows never share an index, so no element has two
    writers and the scatter is deterministic on CUDA too."""
    b = torch.arange(leaf.shape[1], device=leaf.device)[:, None]
    leaf[:, b, idx % leaf.shape[2]] = rows.to(leaf.dtype)
    return leaf


def _snapshot_span(caches, idx: Tensor):
    """Pre-step snapshot: the ring rows every attention leaf will (re)write
    for absolute positions ``idx`` (B, S)."""
    return {key: attention.KVCache(*(_ring_gather(x, idx) for x in e["attn"]))
            for key, e in caches.items()}


def _restore_span(caches, idx: Tensor, saved, limit: Tensor):
    """Post-step rollback: keep the chunk's writes at absolute positions
    <= limit[b] (the last accepted position) and restore the snapshot
    everywhere else; inactive rows pass limit = -1 and are undone whole, so
    the cache only ever holds committed entries. In place."""
    keep = idx <= limit[:, None]                        # (B, S)

    def mix(leaf, old):
        new = _ring_gather(leaf, idx)
        k = keep.reshape((1,) + keep.shape + (1,) * (new.dim() - 3))
        return _ring_scatter(leaf, idx, torch.where(k, new, old))

    for key, e in caches.items():
        for leaf, old in zip(e["attn"], saved[key]):
            mix(leaf, old)
    return caches


def make_verify_step(cfg: ModelConfig):
    """verify(params, caches, tokens, pos, prompt_len, max_pos, score,
    active, temps, top_ks, top_ps, generator) ->
    (out_tok (B, S), accept_n (B,), logprobs (B, S), caches).

    One speculative tick over the whole pool. tokens (B, S) carry [t, d_1
    .. d_k] per row (S = k + 1): the true next token t at absolute position
    pos[b], then k drafts. The chunk path teacher-forces all S positions;
    the accept rule takes the longest prefix of drafts that agree with the
    model's own greedy predictions. Rows with temps > 0 accept nothing and
    sample their first token under their policy (top_ks / top_ps may be
    None: disabled). Draft positions inside the prompt (< prompt_len, the
    decode ramp) are teacher-forced and always accept; accepts are clamped
    to max_pos[b] (the last position the row may commit) and, for score
    rows, to k - 1, so that every prompt position's logprob comes out once.
    Rejected (and inactive-row) cache writes are rolled back from a span
    snapshot, so the pool never holds uncommitted state.

    Needs an attention-only pattern (an SSM chunk scan cannot be rolled
    back) and S <= the smallest attention view length (distinct ring rows
    for the rollback scatter); the scheduler checks both.
    """
    for spec in cfg.pattern:
        if spec.mixer != "attn" or spec.mlp == "rwkv_ffn":
            raise ValueError(
                "speculative verify needs an attention-only pattern with "
                f"stateless MLPs; got mixer={spec.mixer!r} mlp={spec.mlp!r} "
                "(SSM/rwkv_ffn chunk scans cannot be rolled back)")

    @torch.inference_mode()
    def verify(params, caches, tokens: Tensor, pos: Tensor,
               prompt_len: Tensor, max_pos: Tensor, score: Tensor,
               active: Tensor, temps: Tensor, top_ks: Optional[Tensor],
               top_ps: Optional[Tensor],
               generator: Optional[torch.Generator]):
        s = tokens.shape[1]
        k = s - 1
        idx = pos[:, None] + torch.arange(s, device=pos.device)[None, :]
        saved = _snapshot_span(caches, idx)
        logits, _, caches = T.apply_model(
            params, cfg, tokens=tokens, mode="decode", caches=caches,
            pos_scalar=pos)
        lg = logits.to(torch.float32)                   # (B, S, V)
        greedy = torch.argmax(lg, dim=-1)
        drafts = tokens[:, 1:]                          # (B, k)
        # a draft at chunk slot i+1 sits at absolute position pos+i+1; ramp
        # positions (< prompt_len) are the true prompt and always accept
        forced = (idx[:, :k] + 1) < prompt_len[:, None]
        match = (greedy[:, :k] == drafts) | forced
        n = torch.cumprod(match.to(torch.int64), dim=-1).sum(dim=-1)
        n = torch.where(temps > 0.0, 0, n)
        n = torch.where(score, torch.clamp_max(n, k - 1), n)
        n = torch.minimum(n, torch.clamp_min(max_pos - pos, 0))
        n = torch.where(active, n, 0)
        limit = torch.where(active, pos + n, -1)
        caches = _restore_span(caches, idx, saved, limit)
        # out_tok[:, i] = the prediction after chunk slot i; a sampled row
        # replaces slot 0 with a sample under its policy (its only token
        # this tick: its accept count is 0)
        first = sample_token(lg[:, :1], generator, temps,
                             0 if top_ks is None else top_ks,
                             1.0 if top_ps is None else top_ps)
        out_tok = greedy.clone()
        out_tok[:, 0] = first
        # logprobs[:, i] = log p(token fed at slot i+1 | prefix); the last
        # slot scores the model's own bonus prediction
        fed = torch.cat([drafts, out_tok[:, -1:]], dim=-1)
        lp = torch.log_softmax(lg, dim=-1).gather(-1, fed[..., None])[..., 0]
        return out_tok, n, lp, caches

    return verify


# ---------------------------------------------------------------------------
# paged steps: dense per-slot leaves + flat block pools behind page tables
# ---------------------------------------------------------------------------

def merge_paged(dense, paged, rows, block_size: int):
    """The full cache tree the model steps expect: dense entries pass
    through; each paged layer (``{"attn": None}`` in ``dense``) gets the
    per-slot view gathered through ``rows[key]``. A key's trash floor is
    its pool's rows minus one block."""
    caches = {}
    for key, entry in dense.items():
        if key in paged:
            entry = dict(entry)
            entry["attn"] = attention.paged_view(
                paged[key], rows[key],
                attention.paged_live_rows(paged[key], block_size))
        caches[key] = entry
    return caches


def split_paged(caches, paged, rows):
    """Inverse of merge_paged: write each updated view back into its pool
    (in place) and return the dense tree with the None placeholders."""
    dense = {}
    for key, entry in caches.items():
        if key in paged:
            entry = dict(entry)
            attention.paged_writeback(paged[key], entry["attn"], rows[key])
            entry["attn"] = None
        dense[key] = entry
    return dense


def make_paged_decode_step(cfg: ModelConfig):
    """decode(params, dense, paged, rows, tokens, pos, temps, generator,
    top_ks, top_ps, block_size) -> (next_tok, logits, dense) over the whole
    pool: ``rows`` maps each paged key to (B, V_key) physical rows (the keys
    of one page-table group share one tensor); ``paged`` is updated in
    place."""
    step = make_slot_decode_step(cfg)

    @torch.inference_mode()
    def decode(params, dense, paged, rows, tokens, pos, temps, generator,
               top_ks, top_ps, block_size: int):
        caches = merge_paged(dense, paged, rows, block_size)
        nxt, logits, caches = step(params, caches, tokens, pos, temps,
                                   generator, top_ks, top_ps)
        return nxt, logits, split_paged(caches, paged, rows)

    return decode


def make_paged_chunk_step(cfg: ModelConfig):
    """chunk(params, dense, paged, rows, tokens, pos, block_size) ->
    (logits (m, C, V), dense) for a sub-batch: ``dense`` holds the
    sub-batch's dense leaves and ``rows`` its (m, V_key) rows; ``paged``
    is updated in place."""
    step = make_chunk_step(cfg)

    @torch.inference_mode()
    def chunk(params, dense, paged, rows, tokens, pos, block_size: int):
        caches = merge_paged(dense, paged, rows, block_size)
        logits, caches = step(params, caches, tokens, pos)
        return logits, split_paged(caches, paged, rows)

    return chunk


def make_paged_verify_step(cfg: ModelConfig):
    """verify(params, dense, paged, rows, tokens, pos, prompt_len, max_pos,
    score, active, temps, top_ks, top_ps, generator, block_size) ->
    (out_tok, accept_n, logprobs, dense) over the whole pool (the
    ``rows`` contract of make_paged_decode_step). The snapshot and rollback
    act on the gathered views, so the writeback lands only committed rows
    in the mapped blocks; rolled-back positions past a slot's mapping go
    to the trash block, which is always read masked."""
    step = make_verify_step(cfg)

    @torch.inference_mode()
    def verify(params, dense, paged, rows, tokens, pos, prompt_len, max_pos,
               score, active, temps, top_ks, top_ps, generator,
               block_size: int):
        caches = merge_paged(dense, paged, rows, block_size)
        out_tok, n, lp, caches = step(
            params, caches, tokens, pos, prompt_len, max_pos, score, active,
            temps, top_ks, top_ps, generator)
        return out_tok, n, lp, split_paged(caches, paged, rows)

    return verify


# ---------------------------------------------------------------------------
# cache trees: map, and gather / scatter along the slot axis
# ---------------------------------------------------------------------------

SLOT_AXIS = 1       # every per_slot_pos cache leaf: (periods, B, ...)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a cache tree (dicts, KVCache, tensors);
    None (a paged layer's placeholder) stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, attention.KVCache):
        return attention.KVCache(*(tree_map(fn, *xs)
                                   for xs in zip(tree, *rest)))
    return fn(tree, *rest)


@torch.inference_mode()
def gather_slots(caches, idx: Tensor):
    """Slots ``idx`` of every leaf, as new contiguous tensors."""
    return tree_map(lambda l: l.index_select(SLOT_AXIS, idx), caches)


@torch.inference_mode()
def scatter_slots(caches, sub, idx: Tensor):
    """Write ``sub`` (slot axis = len(idx)) into slots ``idx``, in place."""
    tree_map(lambda l, x: l.index_copy_(SLOT_AXIS, idx, x.to(l.dtype)),
             caches, sub)
    return caches


# ---------------------------------------------------------------------------
# sharded steps: the paged slot pool split into shards
# ---------------------------------------------------------------------------
#
# Every per-slot cache leaf carries the slot axis at position 1, so a
# sharded pool without a mesh is the stacked layout: dense leaves hold
# num_shards * slots_per_shard slots, shard s's slots at [s*k, (s+1)*k);
# each paged pool holds num_shards segments of (num_blocks + 1) *
# block_size rows, each segment ending in its OWN trash block. One step
# over the stack reads each slot through rows offset into its shard's
# segment. paged_view / paged_writeback take rows past ``total -
# block_size`` as trash, so a shard's trash rows must map onto the stack's
# LAST block (``stacked_rows``): a shard's own trash block lies inside the
# live range, and a write there would land in the next shard's live
# blocks as far as the view can tell.

def _check_shard_mesh(num_shards: int, mesh, axis):
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if mesh is not None:
        if axis not in mesh.axis_names:
            raise ValueError(f"axis {axis!r} not in mesh axes "
                             f"{mesh.axis_names}")
        if mesh.shape[axis] != num_shards:
            raise ValueError(
                f"mesh axis {axis!r} has {mesh.shape[axis]} device(s) "
                f"but num_shards={num_shards}: the slot-pool shard count "
                "must match the mesh")


def stacked_rows(local: np.ndarray, shard: np.ndarray, num_blocks: int,
                 num_shards: int, block_size: int) -> np.ndarray:
    """Rows of the stacked pool for shard-local rows ``local`` (B, V) of
    slots on shards ``shard`` (B,): each shard's rows offset into its
    segment, its trash rows moved onto the stack's last block."""
    seg, live = (num_blocks + 1) * block_size, num_blocks * block_size
    local = np.asarray(local, np.int64)
    base = np.asarray(shard, np.int64)[:, None] * seg
    return np.where(local >= live,
                    num_shards * seg - block_size + (local - live),
                    base + local)


def replicate_params(params, devices) -> List:
    """``params`` on each of ``devices``: the object itself where it lives
    there, else a copy (the reference's shard_map replicates the weights
    over the mesh)."""
    return [params if params.final_norm["scale"].device == dev
            else copy.deepcopy(params).to(dev) for dev in devices]


def _on(x: Optional[Tensor], dev: torch.device, part: slice):
    return None if x is None else x[part].to(dev)


@functools.lru_cache(maxsize=None)
def make_sharded_decode_step(cfg: ModelConfig, num_shards: int,
                             block_size: int, mesh=None,
                             axis: Optional[str] = None):
    """decode(params, dense, paged, rows, tokens, pos, temps, generators,
    top_ks, top_ps) -> (next_tok (B,), logits (B, 1, V), dense) over the
    sharded pool, B = num_shards * slots_per_shard. ``generators`` is None
    (every row greedy) or one generator a shard. Without a mesh ``dense``,
    ``paged`` and ``rows`` are the stacked pool's (``stacked_rows``); with
    one, ``params``, ``dense``, ``paged`` and ``rows`` are lists with one
    entry a shard, on its device (``replicate_params``), with shard-local
    rows. Cached on (cfg, num_shards, block_size, mesh, axis),
    so another shard count or mesh never reuses a step."""
    _check_shard_mesh(num_shards, mesh, axis)
    base = make_paged_decode_step(cfg)
    if mesh is None:
        def run(params, dense, paged, rows, tokens, pos, temps, generators,
                top_ks, top_ps):
            gen = (None if generators is None
                   else generators[0] if num_shards == 1 else generators)
            return base(params, dense, paged, rows, tokens, pos, temps, gen,
                        top_ks, top_ps, block_size)

        return run

    devs = mesh.devices

    def run_mesh(params, dense, paged, rows, tokens, pos, temps, generators,
                 top_ks, top_ps):
        k = tokens.shape[0] // num_shards
        nxt, logits = [], []
        for s, dev in enumerate(devs):
            part = slice(s * k, (s + 1) * k)
            n_s, lg, dense[s] = base(
                params[s], dense[s], paged[s], rows[s],
                tokens[part].to(dev), pos[part].to(dev), temps[part].to(dev),
                None if generators is None else generators[s],
                _on(top_ks, dev, part), _on(top_ps, dev, part), block_size)
            nxt.append(n_s.to(devs[0]))
            logits.append(lg.to(devs[0]))
        return torch.cat(nxt), torch.cat(logits), dense

    return run_mesh


@functools.lru_cache(maxsize=None)
def make_sharded_chunk_step(cfg: ModelConfig, num_shards: int,
                            block_size: int, mesh=None,
                            axis: Optional[str] = None):
    """chunk(params, dense, paged, idx, rows, tokens, pos) -> logits over
    the sharded pool, updating it in place. Without a mesh: ``idx`` (m,)
    slot ids of the stacked pool, ``rows`` (m, V_key) stacked rows, tokens
    (m, C), pos (m,), and the logits (m, C, V). With a mesh every argument
    is a list with one entry a shard (its parameters from
    ``replicate_params``, local slot ids, local rows, tokens and
    positions; a shard with no slot has an empty ``idx`` and is skipped),
    and the result is a list of logits on the first device (None for a
    skipped shard). Cached as the decode step."""
    _check_shard_mesh(num_shards, mesh, axis)
    base = make_paged_chunk_step(cfg)
    if mesh is None:
        @torch.inference_mode()
        def run(params, dense, paged, idx, rows, tokens, pos):
            logits, sub = base(params, gather_slots(dense, idx), paged, rows,
                               tokens, pos, block_size)
            scatter_slots(dense, sub, idx)
            return logits

        return run

    devs = mesh.devices

    @torch.inference_mode()
    def run_mesh(params, dense, paged, idx, rows, tokens, pos):
        out: List[Optional[Tensor]] = []
        for s, dev in enumerate(devs):
            if len(idx[s]) == 0:
                out.append(None)
                continue
            ix = torch.as_tensor(np.asarray(idx[s], np.int64)).to(dev)
            logits, sub = base(params[s],
                               gather_slots(dense[s], ix), paged[s], rows[s],
                               tokens[s].to(dev), pos[s].to(dev), block_size)
            scatter_slots(dense[s], sub, ix)
            out.append(logits.to(devs[0]))
        return out

    return run_mesh


@functools.lru_cache(maxsize=None)
def make_sharded_verify_step(cfg: ModelConfig, num_shards: int,
                             block_size: int, mesh=None,
                             axis: Optional[str] = None):
    """verify(params, dense, paged, rows, tokens, pos, prompt_len, max_pos,
    score, active, temps, top_ks, top_ps, generators) -> (out_tok,
    accept_n, logprobs, dense) over the sharded pool: the contract of
    ``make_paged_verify_step`` with the layouts and ``generators`` of
    ``make_sharded_decode_step``. Cached as the decode step."""
    _check_shard_mesh(num_shards, mesh, axis)
    base = make_paged_verify_step(cfg)
    if mesh is None:
        def run(params, dense, paged, rows, tokens, pos, prompt_len, max_pos,
                score, active, temps, top_ks, top_ps, generators):
            gen = (None if generators is None
                   else generators[0] if num_shards == 1 else generators)
            return base(params, dense, paged, rows, tokens, pos, prompt_len,
                        max_pos, score, active, temps, top_ks, top_ps, gen,
                        block_size)

        return run

    devs = mesh.devices

    def run_mesh(params, dense, paged, rows, tokens, pos, prompt_len,
                 max_pos, score, active, temps, top_ks, top_ps, generators):
        k = tokens.shape[0] // num_shards
        outs = []
        for s, dev in enumerate(devs):
            part = slice(s * k, (s + 1) * k)
            *got, dense[s] = base(
                params[s], dense[s], paged[s], rows[s],
                *(x[part].to(dev) for x in (tokens, pos, prompt_len, max_pos,
                                            score, active, temps)),
                _on(top_ks, dev, part), _on(top_ps, dev, part),
                None if generators is None else generators[s], block_size)
            outs.append([x.to(devs[0]) for x in got])
        out_tok, acc, lp = (torch.cat(xs) for xs in zip(*outs))
        return out_tok, acc, lp, dense

    return run_mesh


@torch.inference_mode()
def reset_block_rows(paged, rows: Tensor):
    """Zero the physical ``rows`` of freshly mapped blocks in every pool
    (k=v=0, pos=-1), the paged counterpart of a slot reset."""
    for c in paged.values():
        c.k[:, rows] = 0
        c.v[:, rows] = 0
        c.pos[:, rows] = -1


@torch.inference_mode()
def gather_block_rows(paged, rows: Tensor):
    """The physical ``rows`` of every pool, as new tensors: the device
    half of a swap-out."""
    return {key: attention.KVCache(*(x.index_select(1, rows) for x in c))
            for key, c in paged.items()}


@torch.inference_mode()
def upload_block_rows(paged, saved, rows: Tensor):
    """Write saved block bytes (``gather_block_rows``'s layout, any
    device) into freshly mapped physical ``rows``: the resume half of a
    swap."""
    for key, c in paged.items():
        for x, y in zip(c, saved[key]):
            x[:, rows] = y.to(device=x.device, dtype=x.dtype)


@torch.inference_mode()
def copy_block_rows(paged, src_rows: Tensor, dst_rows: Tensor):
    """Duplicate the physical ``src_rows`` into ``dst_rows`` in every pool
    on the device: the copy half of copy-on-write."""
    for c in paged.values():
        for x in c:
            x[:, dst_rows] = x[:, src_rows]


def generate(params, cfg: ModelConfig, prompt, max_new_tokens: int,
             *, temperature: float = 0.0, top_k: int = 0,
             top_p: float = 1.0, eos_token: Optional[int] = None,
             prefill_chunk: int = 32, cache_slots: int = 0,
             generator: Optional[torch.Generator] = None):
    """Per-request generation, the scheduler's single-request oracle.

    The prompt is consumed as in the reference: full ``prefill_chunk``
    chunks over the first L-1 tokens, the remainder teacher-forced through
    decode. Runs on the device of ``params``. Returns (tokens (g,) int32
    numpy, reason).
    """
    dev = params.final_norm["scale"].device
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                             device=dev)
    ln = int(prompt.shape[0])
    assert ln >= 1, "empty prompt"
    slots = cache_slots or (ln + max_new_tokens)
    caches = T.init_caches(cfg, batch=1, slots=slots, per_slot_pos=True,
                           device=dev)
    chunk_fn = make_chunk_step(cfg)
    decode_fn = make_slot_decode_step(cfg)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def at(pos):
        return torch.tensor([pos], dtype=torch.int64, device=dev)

    ctx = 0
    while ln - 1 - ctx >= prefill_chunk:
        toks = prompt[None, ctx:ctx + prefill_chunk]
        _, caches = chunk_fn(params, caches, toks, at(ctx))
        ctx += prefill_chunk

    temps = torch.tensor([temperature], dtype=torch.float32, device=dev)
    tks = torch.tensor([top_k], dtype=torch.int64, device=dev)
    tps = torch.tensor([top_p], dtype=torch.float32, device=dev)
    out, reason, last = [], "length", None
    while len(out) < max_new_tokens:
        tok = prompt[ctx] if ctx < ln else last
        nxt, _, caches = decode_fn(params, caches, tok.reshape(1, 1),
                                   at(ctx), temps, generator, tks, tps)
        ctx += 1
        last = nxt[0]
        if ctx >= ln:                       # prompt consumed: real sample
            out.append(int(last))
            if eos_token is not None and out[-1] == eos_token:
                reason = "eos"
                break
    return np.asarray(out, np.int32), reason
