"""SlotManager: a fixed pool of cache slots for continuous batching (port of
``repro.serve.slots``).

The pool holds B cache slots over the engine's caches
(``transformer.init_caches(per_slot_pos=True)``): a request is allocated a
slot, its state lives in that slot's rows of every cache leaf, and
retirement frees the slot for the next admission. The batch shape never
changes, only the masks do. Two storage backings sit behind one facade:

  * contiguous - every slot reserves its worst-case rows of every leaf
    (``cache_slots`` positions for global attention, the ``window`` ring
    for a sliding window).
  * paged      - attention KV lives in shared block pools
    (``serve.paging``): blocks map on demand as a request's write position
    grows and are freed at retire, so short requests stop stranding pool
    memory. Keys sharing a view length form one page-table group over one
    pool: the global-KV group (view ``cache_slots``) and one ring-mode
    group per shorter window. The steps gather a per-slot view through
    each group's table before attending and write it back after
    (``engine.make_paged_*_step``); every view equals the contiguous
    layout, so greedy streams do too. Preemption can swap a slot's blocks
    to host tensors, and prefix sharing maps indexed prompt blocks
    read-shared with copy-on-write.
  * sharded    - the paged pool split into ``mesh_shards`` shards, each
    with its own block pools, page tables, swap store and prefix index
    (``_ShardState``): block ids never cross shards, and the one channel
    between them is the migration of a parked swap entry (work stealing).
    Without a mesh the shards' segments are stacked in one set of tensors
    and a tick is one paged step over the stack; with a mesh each shard
    lives on its own device (``engine.make_sharded_*_step``).

Every cache leaf carries the slot axis at position 1 ((periods, B, ...)),
so gather, scatter and reset are ``index_select`` / ``index_copy_`` along
that axis. Gathered sub-batches are new contiguous tensors, as the
``ssm_scan`` kernel takes its initial state. There is no jit, and so no
pad-by-repeat of sub-batches or block-row vectors to a few compiled
widths: a chunk runs on exactly the slots that need it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention
from repro_torch.models import transformer as T
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve import engine
from repro_torch.serve.paging import (BlockPool, PageTable, PrefixIndex,
                                      SwapEntry, SwapStore)

Tensor = torch.Tensor

_SLOT_AXIS = engine.SLOT_AXIS
_tree_map = engine.tree_map
_gather = engine.gather_slots
_scatter = engine.scatter_slots


def _pooled_chunk_step(cfg: ModelConfig):
    """gather -> chunk-prefill -> scatter over the pooled caches, returning
    the chunk logits (m, C, V)."""
    step = engine.make_chunk_step(cfg)

    @torch.inference_mode()
    def run(params, caches, idx: Tensor, tokens: Tensor, pos: Tensor):
        logits, sub = step(params, _gather(caches, idx), tokens, pos)
        _scatter(caches, sub, idx)
        return logits

    return run


@torch.inference_mode()
def _reset(caches, template, idx: Tensor):
    """Write the one-slot zero-state template into slots ``idx``."""

    def wipe(l, t):
        fresh = t.expand(t.shape[:_SLOT_AXIS] + (idx.shape[0],)
                         + t.shape[_SLOT_AXIS + 1:])
        return l.index_copy_(_SLOT_AXIS, idx, fresh.to(l.dtype))

    _tree_map(wipe, caches, template)
    return caches


def _attn_view_len(spec, cache_slots: int) -> int:
    """Positions an attention layer's slot view spans: the full
    ``cache_slots`` for global attention (or window >= cache_slots), the
    ring length for a shorter sliding window."""
    return min(cache_slots, spec.window) if spec.window else cache_slots


class _ContiguousBacking:
    """Every slot owns its worst-case rows of every leaf."""

    is_paged = False

    def __init__(self, cfg: ModelConfig, num_slots: int, cache_slots: int,
                 device: torch.device):
        self.cfg = cfg
        self.num_slots = num_slots
        self.cache_slots = cache_slots
        self.device = device
        with torch.inference_mode():
            self.caches = T.init_caches(cfg, num_slots, cache_slots,
                                        per_slot_pos=True, device=device)
            # one-slot zero template: reset = broadcast-copy of this
            self._template = T.init_caches(cfg, 1, cache_slots,
                                           per_slot_pos=True, device=device)
        self.position_capacity = num_slots * cache_slots
        self._chunk = _pooled_chunk_step(cfg)
        self._decode = engine.make_slot_decode_step(cfg)
        self._verify = None     # at first use: it refuses recurrent layers

    @property
    def total_rows(self) -> int:
        """Attention cache positions reserved across the pool (global KV
        and window rings)."""
        return sum(self.num_slots * _attn_view_len(s, self.cache_slots)
                   for s in self.cfg.pattern if s.mixer == "attn")

    def _idx(self, idx: Sequence[int]) -> Tensor:
        return torch.as_tensor(np.asarray(idx, np.int64)).to(self.device)

    def can_admit(self, prompt_len: int, prompt=None,
                  span: Optional[int] = None) -> bool:
        return True                     # a free slot is the only gate

    def fits_pool(self, n_positions: int) -> Optional[str]:
        return None                     # rows are pre-reserved

    def alloc_reset(self, slot: int, prompt_len: int, prompt=None,
                    span: Optional[int] = None) -> int:
        _reset(self.caches, self._template, self._idx([slot]))
        return 0                        # no prefix sharing: prefill from 0

    def ensure(self, slot: int, upto_pos: int,
               write_from: Optional[int] = None) -> bool:
        return True                     # rows are pre-reserved

    def release_slot(self, slot: int) -> List[int]:
        return []                       # nothing block-granular to free

    def prefill_start(self, slot: int) -> int:
        return 0

    def register_prefix(self, slot: int, prompt, span: int,
                        upto_tokens: int) -> int:
        return 0

    def flush_prefix(self) -> int:
        return 0

    def gather(self, idx: Sequence[int]):
        return _gather(self.caches, self._idx(idx))

    def scatter(self, sub, idx: Sequence[int]):
        _scatter(self.caches, sub, self._idx(idx))

    def run_chunk(self, params, idx: Sequence[int], tokens: Tensor,
                  pos: Tensor) -> Tensor:
        return self._chunk(params, self.caches, self._idx(idx), tokens, pos)

    def run_decode(self, params, tokens, pos, temps, generator,
                   top_ks=None, top_ps=None):
        nxt, logits, self.caches = self._decode(
            params, self.caches, tokens, pos, temps, generator, top_ks,
            top_ps)
        return nxt, logits

    def run_verify(self, params, tokens, pos, prompt_len, max_pos, score,
                   active, temps, top_ks, top_ps, generator):
        if self._verify is None:
            self._verify = engine.make_verify_step(self.cfg)
        out_tok, n, lp, self.caches = self._verify(
            params, self.caches, tokens, pos, prompt_len, max_pos, score,
            active, temps, top_ks, top_ps, generator)
        return out_tok, n, lp

    def stats(self) -> dict:
        return {"allocator": "contiguous"}


class _PageGroup:
    """One BlockPool + PageTable shared by the pattern keys whose slot
    views have the same length: the global-KV group (``view_len ==
    cache_slots``) or one ring group per shorter window. Keys in a group
    write the same positions every tick, so one logical->physical map
    serves them all: block b is rows [b*bs, (b+1)*bs) of every member's
    flat pool."""

    def __init__(self, keys: List[str], num_slots: int, view_len: int,
                 cache_slots: int, block_size: int,
                 num_blocks: Optional[int]):
        self.keys = keys
        self.view_len = view_len
        self.ring = view_len < cache_slots
        if num_blocks is None:
            # equal memory: the dense layout's positions (num_slots views)
            num_blocks = num_slots * (-(-view_len // block_size))
        self.pool = BlockPool(num_blocks, block_size)
        self.pt = PageTable(self.pool, num_slots, view_len, ring=self.ring)


class _PagedBacking:
    """Attention KV in shared block pools, one page-table group per view
    length (global KV, and window rings when ``paged_window``); the other
    per-slot leaves (RWKV state, rings kept dense) keep the contiguous
    layout in ``dense``. A model with no attention (RWKV) runs with zero
    groups: every leaf is dense.

    Every device operation goes through the ``_dev_*`` hooks, which reach
    the tensors through ``_dense_at``, ``_pools`` and ``_rows_of``: a
    shard of a stacked pool (``_ShardState``, ``create_arrays=False``)
    overrides those three to address its segment of the owner's tensors
    and keeps the host bookkeeping here as it is."""

    is_paged = True

    def __init__(self, cfg: ModelConfig, num_slots: int, cache_slots: int,
                 device: torch.device, block_size: int,
                 num_blocks: Optional[int], paged_window: bool = True,
                 num_window_blocks: Optional[int] = None,
                 swap_bytes_budget: Optional[int] = None,
                 prefix_sharing: bool = False,
                 prefix_align: Optional[int] = None,
                 prefix_capacity: int = 512,
                 create_arrays: bool = True, template=None):
        self.cfg = cfg
        self.num_slots = num_slots
        self.cache_slots = cache_slots
        self.device = device
        self.block_size = block_size
        if create_arrays:
            paged_kw = dict(per_slot_pos=True, device=device,
                            paged_global_attn=True,
                            paged_window_attn=paged_window)
            with torch.inference_mode():
                self.dense = T.init_caches(cfg, num_slots, cache_slots,
                                           **paged_kw)
                self._template = T.init_caches(cfg, 1, cache_slots,
                                               **paged_kw)
        else:
            self.dense = None
            self._template = template
        # group the paged keys by view length: one pool + page table each
        by_view: Dict[int, List[str]] = {}
        self.key_view: Dict[str, int] = {}
        for i, spec in enumerate(cfg.pattern):
            key = f"p{i}"
            if self._template[key].get("attn", 0) is not None:
                continue
            vl = _attn_view_len(spec, cache_slots)
            by_view.setdefault(vl, []).append(key)
            self.key_view[key] = vl
        self.groups: Dict[int, _PageGroup] = {
            vl: _PageGroup(keys, num_slots, vl, cache_slots, block_size,
                           num_blocks if vl == cache_slots
                           else num_window_blocks)
            for vl, keys in sorted(by_view.items(), reverse=True)}
        with torch.inference_mode():
            self.paged = {
                key: attention.make_paged_cache(
                    g.pool.num_blocks, block_size, cfg.num_kv_heads,
                    cfg.head_dim, periods=cfg.num_periods, device=device)
                for g in self.groups.values()
                for key in g.keys} if create_arrays else None
        g_global = self.groups.get(cache_slots)
        self.position_capacity = (g_global.pool.num_blocks * block_size
                                  if g_global else num_slots * cache_slots)
        self.swaps = SwapStore(max_bytes=swap_bytes_budget)
        # prefix sharing is sound only when EVERY layer's per-position
        # state is paged attention KV: a dense recurrent leaf is a function
        # of the whole prefix that skipping prefill would leave stale
        shareable = (all(s.mixer == "attn" for s in cfg.pattern)
                     and len(self.key_view) == len(cfg.pattern))
        self.prefix: Optional[PrefixIndex] = (
            PrefixIndex(capacity=prefix_capacity)
            if prefix_sharing and shareable else None)
        # a shared prefix ends on a prefill-chunk boundary (lcm'd with the
        # block size by the caller): chunk and decode-ramp KV differ in
        # their last bits, and a sharer's remaining prefill must chunk at
        # the offsets an unshared run would
        self.prefix_align = max(prefix_align or block_size, block_size)
        self._shared_pos: Dict[int, int] = {}   # slot -> prefill start
        self.cow_copies = 0             # CoW block copies, cumulative
        self.shared_chunks_mapped = 0   # chunks admitted read-shared
        # a one-slot dense snapshot has the template's size
        self._dense_slot_bytes = SwapEntry({}, {}, self._template).nbytes
        self._rows_cache: Optional[Dict[str, Tensor]] = None
        # bumped on every mapping change: a sharded owner keys its stacked
        # rows on the shards' epochs
        self._rows_epoch = 0
        self._chunk = engine.make_paged_chunk_step(cfg)
        self._decode = engine.make_paged_decode_step(cfg)
        self._verify = None     # at first use: it refuses recurrent layers

    def _invalidate_rows(self):
        self._rows_cache = None
        self._rows_epoch += 1

    def _idx(self, idx: Sequence[int]) -> Tensor:
        return torch.as_tensor(np.asarray(idx, np.int64)).to(self.device)

    # -- device-op hooks -------------------------------------------------

    def _dense_at(self, slot: int) -> Tuple[dict, Tensor]:
        """The dense tree that holds ``slot``, and its index there."""
        return self.dense, self._idx([slot])

    def _pools(self, g: _PageGroup) -> Dict[str, attention.KVCache]:
        return {k: self.paged[k] for k in g.keys}

    def _rows_of(self, g: _PageGroup, blocks: Sequence[int]) -> Tensor:
        """Physical rows of group ``g``'s ``blocks`` in ``_pools(g)``."""
        return self._idx(PageTable.block_rows(blocks, self.block_size))

    def _key_cache(self, key: str) -> attention.KVCache:
        """The flat paged pool of ``key`` (for its shapes)."""
        return self.paged[key]

    def _dev_dense_reset(self, slot: int):
        tree, ix = self._dense_at(slot)
        _reset(tree, self._template, ix)

    def _dev_dense_gather(self, slot: int):
        """``slot``'s dense leaves, copied to host tensors."""
        tree, ix = self._dense_at(slot)
        return _tree_map(lambda x: x.cpu(), _gather(tree, ix))

    def _dev_dense_scatter(self, slot: int, sub):
        tree, ix = self._dense_at(slot)
        _scatter(tree, _tree_map(lambda x: x.to(ix.device), sub), ix)

    def _dev_block_copy(self, g: _PageGroup, src: Sequence[int],
                        dst: Sequence[int]):
        engine.copy_block_rows(self._pools(g), self._rows_of(g, src),
                               self._rows_of(g, dst))

    def _dev_block_reset(self, g: _PageGroup, blocks: Sequence[int]):
        engine.reset_block_rows(self._pools(g), self._rows_of(g, blocks))

    def _dev_block_gather(self, g: _PageGroup, blocks: Sequence[int]):
        """The bytes of ``blocks`` in every pool of ``g``, as host
        tensors."""
        got = engine.gather_block_rows(self._pools(g),
                                       self._rows_of(g, blocks))
        return {key: attention.KVCache(*(x.cpu() for x in c))
                for key, c in got.items()}

    def _dev_block_upload(self, g: _PageGroup, saved,
                          blocks: Sequence[int]):
        engine.upload_block_rows(self._pools(g), saved,
                                 self._rows_of(g, blocks))

    @property
    def total_rows(self) -> int:
        """Attention cache positions allocated: physical block rows with
        each group's trash block, plus any rings kept dense."""
        total = sum(len(g.keys) * (g.pool.num_blocks + 1) * self.block_size
                    for g in self.groups.values())
        for i, spec in enumerate(self.cfg.pattern):
            if spec.mixer == "attn" and f"p{i}" not in self.key_view:
                total += self.num_slots * _attn_view_len(spec,
                                                         self.cache_slots)
        return total

    # -- prefix sharing --------------------------------------------------

    def _share_cap(self, prompt_len: int, span: int) -> int:
        """Leading blocks of a ``prompt_len`` prompt that may be shared when
        the request writes ``span`` positions in all. The block of the last
        prompt position stays private, and a ring group shares only when
        the whole span fits its ring (a wrapped write would land in the
        shared prefix). 0 disables sharing for this request."""
        if self.prefix is None or prompt_len < 2:
            return 0
        cap = (prompt_len - 1) // self.block_size
        for g in self.groups.values():
            if g.ring:
                if span > g.view_len:
                    return 0
                cap = min(cap, g.view_len // self.block_size)
            else:
                cap = min(cap, g.pt.blocks_per_slot)
        return max(cap, 0)

    def _match_shared(self, prompt, prompt_len: int, span: int) \
            -> Tuple[int, List[Dict[int, int]], List[bytes]]:
        """Longest admissible shared prefix of ``prompt``: its blocks
        (aligned down to the prefill-chunk quantum), the per-chunk
        {view_len: block} entries, and the chunk digests."""
        cap = self._share_cap(prompt_len, span)
        if cap <= 0:
            return 0, [], []
        keys = PrefixIndex.chunk_keys(prompt, self.block_size, cap)
        hit = self.prefix.match(keys)
        step = max(self.prefix_align // self.block_size, 1)
        n = (len(hit) // step) * step
        return n, hit[:n], keys

    def _reclaim(self, g: _PageGroup, need: int,
                 keep: Sequence[bytes] = ()) -> bool:
        """Make room for ``need`` new mappings in group ``g`` by evicting
        cold PrefixIndex entries (not those in ``keep``, the chain an
        admission is about to map). True when the group can map."""
        if self.prefix is None:
            return g.pt.can_map(need)
        keep_set = set(keep)
        while not g.pt.can_map(need):
            dropped = self.prefix.evict_lru(keep=keep_set)
            if dropped is None:
                return False
            for vl, b in dropped.items():
                self.groups[vl].pool.free(b)
        return True

    def prefill_start(self, slot: int) -> int:
        """First position ``slot``'s prefill writes: past a shared prefix
        mapped at admission, else 0."""
        return self._shared_pos.get(slot, 0)

    def register_prefix(self, slot: int, prompt, span: int,
                        upto_tokens: int) -> int:
        """Publish ``slot``'s prefilled leading blocks into the index once
        prefill is done. Only positions consumed by chunk steps or
        inherited (``upto_tokens``) qualify: decode-ramp KV is not bitwise
        the chunk KV an unshared run computes. Each published block gains
        the index's reference. Returns entries inserted."""
        if self.prefix is None:
            return 0
        cap = min(self._share_cap(len(prompt), span),
                  max(upto_tokens, 0) // self.block_size)
        if cap <= 0:
            return 0
        keys = PrefixIndex.chunk_keys(prompt, self.block_size, cap)
        inserted = 0
        for i, key in enumerate(keys):
            blocks: Dict[int, int] = {}
            for vl, g in self.groups.items():
                b = int(g.pt.table[slot, i])
                if b == g.pt.trash:
                    blocks = {}
                    break
                blocks[vl] = b
            if not blocks:
                break
            for vl, b in blocks.items():
                self.groups[vl].pool.ref(b)
            if self.prefix.publish(key, blocks):
                inserted += 1
            else:           # already indexed (first publisher won)
                for vl, b in blocks.items():
                    self.groups[vl].pool.free(b)
        while len(self.prefix) > self.prefix.capacity:
            for vl, b in self.prefix.evict_lru().items():
                self.groups[vl].pool.free(b)
        return inserted

    def flush_prefix(self) -> int:
        """Drop every index entry and its block references; after a flush
        and a full retire no block is used."""
        if self.prefix is None:
            return 0
        n = 0
        while True:
            dropped = self.prefix.evict_lru()
            if dropped is None:
                return n
            for vl, b in dropped.items():
                self.groups[vl].pool.free(b)
            n += 1

    def prefix_holds(self) -> Dict[int, np.ndarray]:
        """Per-group block references the prefix index holds (those no
        slot owns; the invariant checks count them)."""
        if self.prefix is None:
            return {vl: np.zeros(g.pool.num_blocks, np.int64)
                    for vl, g in self.groups.items()}
        return self.prefix.holds(
            {vl: g.pool.num_blocks for vl, g in self.groups.items()})

    # -- page-table lifecycle --------------------------------------------

    def can_admit(self, prompt_len: int, prompt=None,
                  span: Optional[int] = None) -> bool:
        n = max(prompt_len, 1)
        shared, _, keys = (self._match_shared(prompt, len(prompt),
                                              span or prompt_len)
                           if prompt is not None and self.prefix is not None
                           else (0, [], []))
        return all(self._reclaim(g, g.pt.blocks_for(n) - shared, keep=keys)
                   for g in self.groups.values())

    def fits_pool(self, n_positions: int) -> Optional[str]:
        """None if a request spanning ``n_positions`` fits an EMPTY pool in
        every group, else why not (the scheduler's submit-time check)."""
        for g in self.groups.values():
            need = g.pt.blocks_for(n_positions)
            if need > g.pool.num_blocks:
                what = (f"window-{g.view_len} ring" if g.ring
                        else "global-KV")
                return (f"request needs {need} {what} blocks > pool "
                        f"{g.pool.num_blocks}")
        return None

    def alloc_reset(self, slot: int, prompt_len: int, prompt=None,
                    span: Optional[int] = None) -> int:
        """Reset ``slot``'s dense leaves and map its prompt blocks; with
        prefix sharing the longest indexed chunk-aligned prefix of
        ``prompt`` maps read-shared first. Returns the prefill start."""
        self._dev_dense_reset(slot)
        shared_pos = 0
        if self.prefix is not None and prompt is not None:
            n, hit, _ = self._match_shared(prompt, len(prompt),
                                           span or prompt_len)
            if n:
                for vl, g in self.groups.items():
                    g.pt.map_shared(slot, [e[vl] for e in hit])
                shared_pos = n * self.block_size
                self.shared_chunks_mapped += n
                self._invalidate_rows()
        self._shared_pos[slot] = shared_pos
        if not self.ensure(slot, max(prompt_len, 1) - 1):
            raise RuntimeError(
                "alloc_reset after can_admit ran out of blocks")
        return shared_pos

    def ensure(self, slot: int, upto_pos: int,
               write_from: Optional[int] = None) -> bool:
        """Map (and zero) every block covering [0, upto_pos] in every group
        (ring groups clamp to their ring), and copy-on-write any shared
        block the write over [``write_from`` (default ``upto_pos``),
        ``upto_pos``] touches. False when the pool runs out (the
        scheduler then preempts); what was mapped or copied stays, so a
        retry is idempotent."""
        lo = upto_pos if write_from is None else write_from
        ok_all = True
        for g in self.groups.values():
            if g.pool.shared_count:
                pairs: List[Tuple[int, int]] = []
                for lb in g.pt.write_blocks(slot, lo, upto_pos):
                    if not g.pt.is_shared(slot, lb):
                        continue
                    got = g.pt.cow_block(slot, lb)
                    if got is None and self._reclaim(g, 1):
                        got = g.pt.cow_block(slot, lb)
                    if got is None:
                        ok_all = False
                        break
                    pairs.append(got)
                if pairs:
                    self._dev_block_copy(g, [p[0] for p in pairs],
                                         [p[1] for p in pairs])
                    self.cow_copies += len(pairs)
                    self._invalidate_rows()
            ok, new = g.pt.ensure(slot, upto_pos)
            if not ok and self._reclaim(g, 1):
                ok, more = g.pt.ensure(slot, upto_pos)
                new = new + more
            if new:
                self._dev_block_reset(g, new)
                self._invalidate_rows()
            ok_all = ok_all and ok
        return ok_all

    def release_slot(self, slot: int) -> List[int]:
        freed: List[int] = []
        for g in self.groups.values():
            freed += g.pt.free_slot(slot)
        self._shared_pos.pop(slot, None)
        if freed:
            self._invalidate_rows()
        return freed

    # -- swap-out preemption ---------------------------------------------

    def swap_bytes_estimate(self, slot: int) -> int:
        """Bytes a swap_out of ``slot`` would park on the host, from shapes
        alone, so a budget rejection costs no device work."""
        total = self._dense_slot_bytes
        for g in self.groups.values():
            nb = g.pt.mapped_blocks(slot)
            for key in g.keys:
                c = self._key_cache(key)
                row = (c.k[0, 0].numel() * c.k.element_size()
                       + c.v[0, 0].numel() * c.v.element_size()
                       + c.pos.element_size())
                total += nb * self.block_size * row * c.k.shape[0]
        return total

    def swap_out(self, slot: int, rid: int) -> Optional[int]:
        """Copy ``slot``'s mapped block bytes (every group) and dense leaves
        to host tensors in the SwapStore under ``rid`` and free its blocks.
        Returns bytes moved, or None when the store's budget cannot hold
        them (nothing moved or freed; the scheduler recomputes instead)."""
        if self.swaps.max_bytes is not None \
                and not self.swaps.can_hold(self.swap_bytes_estimate(slot)):
            self.swaps.reject()         # the store owns the count
            return None
        blocks: Dict[int, int] = {}
        paged_host: Dict[str, attention.KVCache] = {}
        for vl, g in self.groups.items():
            phys = [int(b) for b in g.pt.table[slot] if b != g.pt.trash]
            blocks[vl] = len(phys)
            if phys:
                paged_host.update(self._dev_block_gather(g, phys))
            # shared blocks are released, not stolen: the bytes were just
            # copied, and only this slot's reference drops
            _, released = g.pt.swap_out(slot)
            if sorted(released) != sorted(phys):
                raise RuntimeError(f"swap_out released {released} != "
                                   f"mapped {phys} (group {vl})")
            if released:
                self._invalidate_rows()
        dense_host = self._dev_dense_gather(slot)
        self._shared_pos.pop(slot, None)
        return self.swaps.put(rid, SwapEntry(
            blocks=blocks, paged=paged_host, dense=dense_host))

    def can_admit_swapped(self, rid: int) -> bool:
        entry = self.swaps.get(rid)
        return all(self._reclaim(g, entry.blocks.get(vl, 0))
                   for vl, g in self.groups.items())

    def swap_in(self, slot: int, rid: int) -> int:
        """Resume ``rid`` in free ``slot``: map fresh blocks for each
        group's saved logical prefix, upload the saved bytes and the dense
        snapshot; every row the request wrote reads as before. Returns
        bytes moved. The caller checked can_admit_swapped."""
        entry = self.swaps.pop(rid)
        for vl, g in self.groups.items():
            nb = entry.blocks.get(vl, 0)
            if not nb:
                continue
            new = g.pt.swap_in(slot, nb)
            if new is None:
                raise RuntimeError(
                    "swap_in after can_admit_swapped ran out of blocks")
            self._dev_block_upload(g, entry.paged, new)
            self._invalidate_rows()
        self._dev_dense_scatter(slot, entry.dense)
        self._shared_pos[slot] = 0      # resumed mappings are private
        return entry.nbytes

    # -- device-facing row vectors ---------------------------------------

    def _rows(self, slots: Optional[Sequence[int]]) -> Dict[str, Tensor]:
        per_group = {vl: self._idx(g.pt.rows(slots))
                     for vl, g in self.groups.items()}
        return {key: per_group[vl] for key, vl in self.key_view.items()}

    def _rows_all(self) -> Dict[str, Tensor]:
        """Every slot's rows, kept until a mapping changes."""
        if self._rows_cache is None:
            self._rows_cache = self._rows(None)
        return self._rows_cache

    # -- data movement ---------------------------------------------------

    def gather(self, idx: Sequence[int]):
        sub = _gather(self.dense, self._idx(idx))
        return engine.merge_paged(sub, self.paged, self._rows(idx),
                                   self.block_size)

    def scatter(self, sub, idx: Sequence[int]):
        """Write a gathered sub-tree back; view positions of unmapped
        blocks land in the trash block."""
        with torch.inference_mode():
            dense = engine.split_paged(sub, self.paged, self._rows(idx))
        _scatter(self.dense, dense, self._idx(idx))

    def run_chunk(self, params, idx: Sequence[int], tokens: Tensor,
                  pos: Tensor) -> Tensor:
        ix = self._idx(idx)
        logits, sub = self._chunk(params, _gather(self.dense, ix),
                                  self.paged, self._rows(idx), tokens, pos,
                                  self.block_size)
        _scatter(self.dense, sub, ix)
        return logits

    def run_decode(self, params, tokens, pos, temps, generator,
                   top_ks=None, top_ps=None):
        nxt, logits, self.dense = self._decode(
            params, self.dense, self.paged, self._rows_all(), tokens, pos,
            temps, generator, top_ks, top_ps, self.block_size)
        return nxt, logits

    def run_verify(self, params, tokens, pos, prompt_len, max_pos, score,
                   active, temps, top_ks, top_ps, generator):
        if self._verify is None:
            self._verify = engine.make_paged_verify_step(self.cfg)
        out_tok, n, lp, self.dense = self._verify(
            params, self.dense, self.paged, self._rows_all(), tokens, pos,
            prompt_len, max_pos, score, active, temps, top_ks, top_ps,
            generator, self.block_size)
        return out_tok, n, lp

    def stats(self) -> dict:
        used = sum(g.pool.used_count for g in self.groups.values())
        total = sum(g.pool.num_blocks for g in self.groups.values())
        prefix_stats = (self.prefix.stats() if self.prefix is not None
                        else {"prefix_entries": 0, "prefix_lookups": 0,
                              "prefix_hit_chunks": 0, "prefix_published": 0,
                              "prefix_evicted": 0})
        out = {"allocator": "paged",
               "page_groups": len(self.groups),
               "blocks_total": total,
               "blocks_used": used,
               "blocks_free": total - used,
               "block_size": self.block_size,
               "block_utilization": used / max(total, 1),
               "shared_blocks": sum(g.pool.shared_count
                                    for g in self.groups.values()),
               "cow_copies": self.cow_copies,
               "prefix_shared_chunks": self.shared_chunks_mapped,
               **prefix_stats,
               **self.swaps.stats()}
        for vl, g in self.groups.items():
            if g.ring:
                out[f"ring{vl}_blocks_total"] = g.pool.num_blocks
                out[f"ring{vl}_blocks_used"] = g.pool.used_count
        return out

    def metrics(self) -> dict:
        """Registry 'paging' provider: the numeric stats() keys."""
        return {k: v for k, v in self.stats().items() if k != "allocator"}

# ---------------------------------------------------------------------------
# the sharded backing: per-shard block pools over one stack or one mesh
# ---------------------------------------------------------------------------

class _ShardState(_PagedBacking):
    """Host state of ONE shard of a stacked pool: its own page-table
    groups, swap store, prefix index and shared-prefix map, so paging,
    copy-on-write, swap and the window rings stay inside the shard. Its
    device operations address the owner's stacked tensors: slots offset by
    the shard's dense segment, block rows by its segment of each flat
    pool."""

    def __init__(self, owner: "_ShardedPagedBacking", shard: int, *args,
                 **kw):
        self._owner = owner
        self.shard = shard
        super().__init__(*args, create_arrays=False,
                         template=owner._template, **kw)

    def _dense_at(self, slot: int) -> Tuple[dict, Tensor]:
        o = self._owner
        return o.dense, o._idx([self.shard * self.num_slots + slot])

    def _pools(self, g: _PageGroup) -> Dict[str, attention.KVCache]:
        return {k: self._owner.paged[k] for k in g.keys}

    def _rows_of(self, g: _PageGroup, blocks: Sequence[int]) -> Tensor:
        base = self.shard * (g.pool.num_blocks + 1) * self.block_size
        return self._idx(PageTable.block_rows(blocks, self.block_size)
                         + base)

    def _key_cache(self, key: str) -> attention.KVCache:
        return self._owner.paged[key]


class _ShardedPagedBacking:
    """The paged slot pool split into ``num_shards`` shards of
    ``num_slots / num_shards`` slots; ``num_blocks``, ``num_window_blocks``
    and ``swap_bytes_budget`` are per shard (a shard is a device's share of
    the pool). Slot ids are global (shard s owns [s*k, (s+1)*k)); every
    block-granular piece of state is per shard, and the only thing that
    crosses shards is a parked SwapEntry (``migrate_swapped``, the work
    stealing of a preempted request).

    Without a mesh, stacked tensors hold every shard's segment back to
    back (dense leaves with num_shards * k slots; each flat pool
    num_shards segments of (num_blocks + 1) * block_size rows, each ending
    in its own trash block) and ``_ShardState``s keep the host state. With
    a mesh each shard is a ``_PagedBacking`` on its own device."""

    is_paged = True

    def __init__(self, cfg: ModelConfig, num_slots: int, cache_slots: int,
                 device: torch.device, block_size: int,
                 num_blocks: Optional[int], paged_window: bool = True,
                 num_window_blocks: Optional[int] = None,
                 swap_bytes_budget: Optional[int] = None,
                 prefix_sharing: bool = False,
                 prefix_align: Optional[int] = None,
                 prefix_capacity: int = 512, *, num_shards: int = 1,
                 mesh=None, axis: Optional[str] = None):
        engine._check_shard_mesh(num_shards, mesh, axis)
        if num_slots % num_shards:
            raise ValueError(f"num_slots={num_slots} must divide evenly "
                             f"over {num_shards} shard(s)")
        self.cfg = cfg
        self.num_slots = num_slots
        self.num_shards = num_shards
        self.slots_per_shard = k = num_slots // num_shards
        self.cache_slots = cache_slots
        self.block_size = block_size
        self.mesh = mesh
        self.axis = axis
        kw = dict(paged_window=paged_window,
                  num_window_blocks=num_window_blocks,
                  swap_bytes_budget=swap_bytes_budget,
                  prefix_sharing=prefix_sharing, prefix_align=prefix_align,
                  prefix_capacity=prefix_capacity)
        if mesh is None:
            self.device = device
            paged_kw = dict(per_slot_pos=True, device=device,
                            paged_global_attn=True,
                            paged_window_attn=paged_window)
            with torch.inference_mode():
                self.dense = T.init_caches(cfg, num_slots, cache_slots,
                                           **paged_kw)
                self._template = T.init_caches(cfg, 1, cache_slots,
                                               **paged_kw)
            self.shards: List[_PagedBacking] = [
                _ShardState(self, s, cfg, k, cache_slots, device,
                            block_size, num_blocks, **kw)
                for s in range(num_shards)]
            with torch.inference_mode():
                self.paged = {
                    key: attention.make_paged_cache(
                        num_shards * (g.pool.num_blocks + 1) - 1,
                        block_size, cfg.num_kv_heads, cfg.head_dim,
                        periods=cfg.num_periods, device=device)
                    for g in self.shards[0].groups.values()
                    for key in g.keys}
        else:
            self.device = mesh.devices[0]
            self.dense = self.paged = None
            self.shards = [_PagedBacking(cfg, k, cache_slots, dev,
                                         block_size, num_blocks, **kw)
                           for dev in mesh.devices]
        s0 = self.shards[0]
        self.key_view = s0.key_view
        self.position_capacity = num_shards * s0.position_capacity
        self._rows_cache: Optional[Dict[str, Tensor]] = None
        self._rows_key: Optional[Tuple[int, ...]] = None
        # mesh: (params, its copy on each device)
        self._replicas: Optional[Tuple[object, List]] = None
        step = (cfg, num_shards, block_size, mesh, axis)
        self._chunk = engine.make_sharded_chunk_step(*step)
        self._decode = engine.make_sharded_decode_step(*step)
        self._step_key = step

    @property
    def total_rows(self) -> int:
        return self.num_shards * self.shards[0].total_rows

    def _idx(self, idx: Sequence[int]) -> Tensor:
        return torch.as_tensor(np.asarray(idx, np.int64)).to(self.device)

    def _loc(self, slot: int) -> Tuple[_PagedBacking, int]:
        return (self.shards[slot // self.slots_per_shard],
                slot % self.slots_per_shard)

    def shard_of(self, slot: int) -> int:
        return slot // self.slots_per_shard

    def shard_free_blocks(self, shard: int) -> int:
        """Free blocks across the shard's groups: the least-loaded
        placement signal."""
        return sum(g.pool.num_blocks - g.pool.used_count
                   for g in self.shards[shard].groups.values())

    # -- routed lifecycle (slot ids global, block state per shard) -------

    def can_admit(self, prompt_len: int, prompt=None,
                  span: Optional[int] = None, shard: int = 0) -> bool:
        return self.shards[shard].can_admit(prompt_len, prompt=prompt,
                                            span=span)

    def fits_pool(self, n_positions: int) -> Optional[str]:
        return self.shards[0].fits_pool(n_positions)

    def alloc_reset(self, slot: int, prompt_len: int, prompt=None,
                    span: Optional[int] = None) -> int:
        sh, loc = self._loc(slot)
        return sh.alloc_reset(loc, prompt_len, prompt=prompt, span=span)

    def prefill_start(self, slot: int) -> int:
        sh, loc = self._loc(slot)
        return sh.prefill_start(loc)

    def register_prefix(self, slot: int, prompt, span: int,
                        upto_tokens: int) -> int:
        sh, loc = self._loc(slot)
        return sh.register_prefix(loc, prompt, span, upto_tokens)

    def flush_prefix(self) -> int:
        return sum(sh.flush_prefix() for sh in self.shards)

    def ensure(self, slot: int, upto_pos: int,
               write_from: Optional[int] = None) -> bool:
        sh, loc = self._loc(slot)
        return sh.ensure(loc, upto_pos, write_from=write_from)

    def release_slot(self, slot: int) -> List[int]:
        sh, loc = self._loc(slot)
        return sh.release_slot(loc)

    # -- swap and cross-shard migration ----------------------------------

    def swap_bytes_estimate(self, slot: int) -> int:
        sh, loc = self._loc(slot)
        return sh.swap_bytes_estimate(loc)

    def swap_out(self, slot: int, rid: int) -> Optional[int]:
        sh, loc = self._loc(slot)
        return sh.swap_out(loc, rid)

    def swapped_shard(self, rid: int) -> Optional[int]:
        for s, sh in enumerate(self.shards):
            if rid in sh.swaps:
                return s
        return None

    def can_admit_swapped(self, rid: int) -> bool:
        s = self.swapped_shard(rid)
        return s is not None and self.shards[s].can_admit_swapped(rid)

    def swap_in(self, slot: int, rid: int) -> int:
        sh, loc = self._loc(slot)
        if rid not in sh.swaps:
            raise RuntimeError(
                f"rid {rid} is not swapped on shard {self.shard_of(slot)}: "
                "migrate_swapped before a cross-shard swap_in")
        return sh.swap_in(loc, rid)

    def migrate_swapped(self, rid: int, dst_shard: int) -> bool:
        """Move ``rid``'s parked SwapEntry from its home shard's store to
        ``dst_shard``'s: the host bytes change owner, the device is not
        touched, and the request keeps its prefill progress. False when
        it is not swapped, is already there, or the destination's budget
        cannot hold it (the caller leaves the request where it is)."""
        src = self.swapped_shard(rid)
        if src is None or src == dst_shard:
            return False
        dst = self.shards[dst_shard].swaps
        entry = self.shards[src].swaps.get(rid)
        if dst.max_bytes is not None and not dst.can_hold(entry.nbytes):
            return False
        dst.migrate_in(rid, self.shards[src].swaps.migrate_out(rid))
        return True

    def can_steal_swapped(self, rid: int, dst_shard: int) -> bool:
        """True when ``dst_shard`` could hold AND admit ``rid``'s parked
        entry now: its swap budget fits the bytes and every group can
        reclaim the saved blocks. The steal pass checks this before it
        migrates, so a steal never strands an entry."""
        src = self.swapped_shard(rid)
        if src is None or src == dst_shard:
            return False
        entry = self.shards[src].swaps.get(rid)
        dst = self.shards[dst_shard]
        if dst.swaps.max_bytes is not None \
                and not dst.swaps.can_hold(entry.nbytes):
            return False
        return all(dst._reclaim(g, entry.blocks.get(vl, 0))
                   for vl, g in dst.groups.items())

    # -- device-facing row vectors ---------------------------------------

    def _stacked(self, slots: Sequence[int]) -> Dict[str, Tensor]:
        """Stacked-pool rows of global ``slots``, per paged key."""
        k = self.slots_per_shard
        shard = np.asarray([i // k for i in slots], np.int64)
        per_group = {}
        for vl, g0 in self.shards[0].groups.items():
            local = np.stack([self.shards[s].groups[vl].pt.rows([i % k])[0]
                              for s, i in zip(shard, slots)])
            per_group[vl] = self._idx(engine.stacked_rows(
                local, shard, g0.pool.num_blocks, self.num_shards,
                self.block_size))
        return {key: per_group[vl] for key, vl in self.key_view.items()}

    def _rows_all(self):
        """Every slot's rows: stacked (cached on the shards' epochs), or
        with a mesh each shard's own."""
        if self.mesh is not None:
            return [sh._rows_all() for sh in self.shards]
        key = tuple(sh._rows_epoch for sh in self.shards)
        if self._rows_cache is None or self._rows_key != key:
            self._rows_cache = self._stacked(range(self.num_slots))
            self._rows_key = key
        return self._rows_cache

    # -- data movement ---------------------------------------------------

    def gather(self, idx: Sequence[int]):
        if self.mesh is None:
            return engine.merge_paged(_gather(self.dense, self._idx(idx)),
                                      self.paged, self._stacked(idx),
                                      self.block_size)
        subs = [_tree_map(lambda x: x.to(self.device), sh.gather([loc]))
                for sh, loc in map(self._loc, idx)]
        return _tree_map(lambda *xs: torch.cat(xs, _SLOT_AXIS), *subs)

    def scatter(self, sub, idx: Sequence[int]):
        if self.mesh is None:
            with torch.inference_mode():
                dense = engine.split_paged(sub, self.paged,
                                           self._stacked(idx))
            _scatter(self.dense, dense, self._idx(idx))
            return
        for j, (sh, loc) in enumerate(map(self._loc, idx)):
            sh.scatter(_tree_map(lambda x: x[:, j:j + 1].to(sh.device), sub),
                       [loc])

    def _mesh_params(self, params) -> List:
        """``params`` on every mesh device, copied once per params."""
        if self._replicas is None or self._replicas[0] is not params:
            self._replicas = (params, engine.replicate_params(
                params, self.mesh.devices))
        return self._replicas[1]

    def run_chunk(self, params, idx: Sequence[int], tokens: Tensor,
                  pos: Tensor) -> Tensor:
        """Chunk-prefill global slots ``idx``; logits in input order."""
        if self.mesh is None:
            return self._chunk(params, self.dense, self.paged,
                               self._idx(idx), self._stacked(idx), tokens,
                               pos)
        per = [[j for j, i in enumerate(idx) if self.shard_of(i) == s]
               for s in range(self.num_shards)]
        locs = [[idx[j] % self.slots_per_shard for j in js] for js in per]
        pick = [torch.as_tensor(js, dtype=torch.int64).to(tokens.device)
                for js in per]
        out = self._chunk(self._mesh_params(params),
                          [sh.dense for sh in self.shards],
                          [sh.paged for sh in self.shards], locs,
                          [sh._rows(loc) if loc else None
                           for sh, loc in zip(self.shards, locs)],
                          [tokens[p] for p in pick], [pos[p] for p in pick])
        order = torch.as_tensor([j for js in per for j in js])
        logits = torch.cat([lg for lg in out if lg is not None])
        return logits[torch.argsort(order).to(logits.device)]

    def _run_step(self, step, params, *args):
        """``step`` over the whole pool; the dense state it returns is
        kept (per shard with a mesh)."""
        if self.mesh is None:
            *out, self.dense = step(params, self.dense, self.paged,
                                    self._rows_all(), *args)
            return out
        dense = [sh.dense for sh in self.shards]
        *out, dense = step(self._mesh_params(params), dense,
                           [sh.paged for sh in self.shards],
                           self._rows_all(), *args)
        for sh, d in zip(self.shards, dense):
            sh.dense = d
        return out

    def run_decode(self, params, tokens, pos, temps, generators,
                   top_ks=None, top_ps=None):
        return self._run_step(self._decode, params, tokens, pos, temps,
                              generators, top_ks, top_ps)

    def run_verify(self, params, tokens, pos, prompt_len, max_pos, score,
                   active, temps, top_ks, top_ps, generators):
        step = engine.make_sharded_verify_step(*self._step_key)
        return self._run_step(step, params, tokens, pos, prompt_len,
                              max_pos, score, active, temps, top_ks, top_ps,
                              generators)

    # -- stats -----------------------------------------------------------

    def stats(self) -> dict:
        """The shards' numeric stats summed, with the pool-wide ones
        recomputed and ``num_shards``."""
        agg: Dict[str, object] = {}
        for sh in self.shards:
            for key, v in sh.stats().items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                agg[key] = agg.get(key, 0) + v
        agg["allocator"] = "paged"
        agg["page_groups"] = len(self.shards[0].groups)
        agg["block_size"] = self.block_size
        agg["block_utilization"] = (agg["blocks_used"]
                                    / max(agg["blocks_total"], 1))
        agg["num_shards"] = self.num_shards
        return agg

    metrics = _PagedBacking.metrics

    def shard_metrics(self) -> dict:
        """Per-shard block and swap gauges, ``shard<i>.``-prefixed."""
        out = {}
        for s, sh in enumerate(self.shards):
            st = sh.stats()
            out[f"shard{s}.blocks_free"] = st["blocks_free"]
            out[f"shard{s}.blocks_used"] = st["blocks_used"]
            out[f"shard{s}.swapped_held"] = st["swapped_held"]
        return out


class SlotManager:
    """Fixed pool of ``num_slots`` decode-cache slots.

    Host-side bookkeeping (LIFO free list, per-slot owner and validity
    mask) plus whole-tree gather/scatter/reset over the pooled caches. Each
    slot's clock lives in the caches' per-row ``pos`` leaves and in the
    scheduler's request state; ``valid[i]`` masks live slots (the scheduler
    decodes the full pool every step; dead rows compute but are never
    read). The caches live on ``device`` (the card unless told otherwise).

    ``paged=True`` selects the block-granular backing: ``alloc`` then also
    needs the prompt's blocks free in every page-table group, ``ensure``
    must run before a slot's write position grows, and ``release`` returns
    the blocks it freed. ``paged_window`` (default on) pages sliding-window
    rings through ring-mode groups too; off keeps them dense per slot.

    ``mesh_shards=n`` (paged only) splits the pool into n shards of
    ``num_slots / n`` slots, each with ``num_blocks`` blocks of its own
    (and ``num_window_blocks``, ``swap_bytes_budget``); ``alloc`` and
    ``can_admit`` then take a ``shard``. ``mesh`` (a ``launch.mesh``
    worker mesh with n devices along ``mesh_axis``) puts each shard on its
    own device; without one the shards share ``device``.
    """

    def __init__(self, cfg: ModelConfig, num_slots: int, cache_slots: int,
                 *, paged: bool = False, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 paged_window: bool = True,
                 num_window_blocks: Optional[int] = None,
                 swap_bytes_budget: Optional[int] = None,
                 prefix_sharing: bool = False,
                 prefix_align: Optional[int] = None,
                 prefix_capacity: int = 512,
                 mesh_shards: Optional[int] = None,
                 mesh=None, mesh_axis: str = "slots",
                 device: DeviceLike = None):
        if prefix_sharing and not paged:
            raise ValueError("prefix_sharing needs the paged backing "
                             "(blocks are the sharing granule)")
        self.sharded = mesh_shards is not None
        if self.sharded and not paged:
            raise ValueError("mesh_shards needs the paged backing "
                             "(blocks are the per-shard granule)")
        if mesh is not None and not self.sharded:
            raise ValueError("mesh without mesh_shards: pass "
                             "mesh_shards=len(mesh devices)")
        self.num_shards = mesh_shards if self.sharded else 1
        if num_slots % self.num_shards:
            raise ValueError(f"num_slots={num_slots} must divide evenly "
                             f"over {self.num_shards} shard(s)")
        self.slots_per_shard = num_slots // self.num_shards
        self.cfg = cfg
        self.num_slots = num_slots
        self.cache_slots = cache_slots
        dev = mesh.devices[0] if mesh is not None else resolve_device(device)
        paged_kw = dict(paged_window=paged_window,
                        num_window_blocks=num_window_blocks,
                        swap_bytes_budget=swap_bytes_budget,
                        prefix_sharing=prefix_sharing,
                        prefix_align=prefix_align,
                        prefix_capacity=prefix_capacity)
        if self.sharded:
            self.backing = _ShardedPagedBacking(
                cfg, num_slots, cache_slots, dev, block_size, num_blocks,
                **paged_kw, num_shards=mesh_shards, mesh=mesh,
                axis=mesh_axis if mesh is not None else None)
        elif paged:
            self.backing = _PagedBacking(cfg, num_slots, cache_slots, dev,
                                         block_size, num_blocks, **paged_kw)
        else:
            self.backing = _ContiguousBacking(cfg, num_slots, cache_slots,
                                              dev)
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        self.owner: List[Optional[int]] = [None] * num_slots
        self.valid = np.zeros(num_slots, bool)
        obs_metrics.REGISTRY.register_provider("serve.slots", self)
        if paged:
            obs_metrics.REGISTRY.register_provider("paging", self.backing)

    @property
    def paged(self) -> bool:
        return self.backing.is_paged

    @property
    def caches(self):
        """The pooled cache tree (contiguous backing; the paged backing
        holds ``backing.dense`` and ``backing.paged``)."""
        return self.backing.caches

    @property
    def position_capacity(self) -> int:
        """Global-KV cache positions backing the pool."""
        return self.backing.position_capacity

    @property
    def total_rows(self) -> int:
        """All attention cache positions allocated (global KV and window
        rings; paged: with the trash blocks)."""
        return self.backing.total_rows

    # -- lifecycle -----------------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    def free_count_shard(self, shard: int) -> int:
        k = self.slots_per_shard
        return sum(1 for i in self._free if i // k == shard)

    def shard_of_slot(self, slot: int) -> int:
        return slot // self.slots_per_shard

    def shard_free_blocks(self, shard: int) -> int:
        """Free blocks on ``shard`` (sharded backing): the least-loaded
        placement signal the scheduler reads."""
        return self.backing.shard_free_blocks(shard)

    def _pop_free(self, shard: Optional[int]) -> int:
        """Claim the most recently freed slot (LIFO), within ``shard``
        when given. At one shard both forms pop the same slot, so the
        sharded pool at n=1 allocates as the unsharded one does."""
        if shard is None:
            return self._free.pop()
        k = self.slots_per_shard
        for i in range(len(self._free) - 1, -1, -1):
            if self._free[i] // k == shard:
                return self._free.pop(i)
        raise RuntimeError(f"no free slot on shard {shard}")

    @property
    def live(self) -> List[int]:
        return [i for i in range(self.num_slots) if self.valid[i]]

    def can_admit(self, prompt_len: int = 0, prompt=None,
                  span: Optional[int] = None,
                  shard: Optional[int] = None) -> bool:
        """A free slot AND (paged) the prompt's blocks free in every
        page-table group. With prefix sharing, ``prompt`` (tokens)
        discounts blocks an indexed shared prefix holds, and ``span``
        (prompt + generation budget) bounds ring-group sharing. On a
        sharded pool ``shard`` scopes both checks to that shard."""
        if shard is not None:
            return (self.free_count_shard(shard) > 0
                    and self.backing.can_admit(prompt_len, prompt=prompt,
                                               span=span, shard=shard))
        return bool(self._free) and self.backing.can_admit(
            prompt_len, prompt=prompt, span=span)

    def fits_pool(self, n_positions: int) -> Optional[str]:
        """None if a request spanning ``n_positions`` fits an empty pool;
        else why not (the scheduler's submit-time ValueError)."""
        return self.backing.fits_pool(n_positions)

    def alloc(self, owner: int, prompt_len: int = 0, prompt=None,
              span: Optional[int] = None,
              shard: Optional[int] = None) -> Optional[int]:
        """Claim the most recently freed slot for request ``owner`` and zero
        its rows (paged: map and zero the prompt's blocks, or map an
        indexed shared prefix read-shared, see ``prefill_start``);
        ``shard`` pins the slot to one shard of a sharded pool. Returns the
        slot index, or None when the slots or blocks are exhausted."""
        if not self.can_admit(prompt_len, prompt=prompt, span=span,
                              shard=shard):
            return None
        slot = self._pop_free(shard)
        self.backing.alloc_reset(slot, prompt_len, prompt=prompt, span=span)
        self.owner[slot] = owner
        self.valid[slot] = True
        return slot

    def prefill_start(self, slot: int) -> int:
        """First position ``slot``'s prefill writes: the shared-prefix
        length when the last alloc mapped indexed blocks, else 0."""
        return self.backing.prefill_start(slot)

    def register_prefix(self, slot: int, prompt, span: int,
                        upto_tokens: int) -> int:
        """Publish ``slot``'s prefilled leading blocks into the prefix
        index (paged + prefix_sharing; a no-op otherwise)."""
        return self.backing.register_prefix(slot, prompt, span, upto_tokens)

    def flush_prefix(self) -> int:
        """Drop every prefix-index entry (and its block references)."""
        return self.backing.flush_prefix()

    def ensure(self, slot: int, upto_pos: int,
               write_from: Optional[int] = None) -> bool:
        """Grow slot storage to cover writes over [``write_from`` (default
        ``upto_pos``), ``upto_pos``]. Always True when contiguous; paged,
        it also copies-on-write any shared block in the span, and returns
        False when the pool is out of blocks (the scheduler preempts)."""
        if not self.valid[slot]:
            raise RuntimeError(f"slot {slot} is not live")
        return self.backing.ensure(slot, upto_pos, write_from=write_from)

    def release(self, slot: int) -> List[int]:
        """Evict (EOS / max-tokens / abort / preempt): mark free; returns the
        blocks handed back (paged). Stale rows are masked by ``valid``
        until the next alloc resets them."""
        if not self.valid[slot]:
            raise RuntimeError(f"slot {slot} is not live")
        self.owner[slot] = None
        self.valid[slot] = False
        self._free.append(slot)
        return self.backing.release_slot(slot)

    # -- swap-out preemption (paged backing only) -----------------------

    def swap_out(self, slot: int) -> Optional[int]:
        """Preempt without discarding work: park the slot's block bytes and
        dense leaves on the host under its owner's rid, free its blocks and
        the slot. Returns bytes moved, or None when the swap budget rejects
        the entry: the slot then stays LIVE and the caller recomputes."""
        if not self.valid[slot]:
            raise RuntimeError(f"slot {slot} is not live")
        if not self.backing.is_paged:
            raise RuntimeError("swap-out needs the paged backing")
        nbytes = self.backing.swap_out(slot, self.owner[slot])
        if nbytes is None:
            return None
        self.owner[slot] = None
        self.valid[slot] = False
        self._free.append(slot)
        return nbytes

    def is_swapped(self, rid: int) -> bool:
        if not self.backing.is_paged:
            return False
        if self.sharded:
            return self.backing.swapped_shard(rid) is not None
        return rid in self.backing.swaps

    def swapped_shard(self, rid: int) -> Optional[int]:
        """Shard whose swap store holds ``rid`` (sharded backing)."""
        return self.backing.swapped_shard(rid)

    def migrate_swapped(self, rid: int, dst_shard: int) -> bool:
        """Steal a swapped-out request to ``dst_shard``'s swap store (host
        bytes change owner; prefill progress is kept). False when it is
        not swapped, is already there or exceeds the destination's
        budget."""
        return self.backing.migrate_swapped(rid, dst_shard)

    def can_steal_swapped(self, rid: int, dst_shard: int) -> bool:
        """Could ``dst_shard`` hold and admit ``rid``'s swapped entry now
        (a free slot, swap budget and free blocks)?"""
        return (self.free_count_shard(dst_shard) > 0
                and self.backing.can_steal_swapped(rid, dst_shard))

    def can_admit_swapped(self, rid: int) -> bool:
        """A free slot AND blocks for the request's saved prefix in every
        page-table group (sharded: both on the shard whose store holds
        the entry)."""
        if self.sharded:
            s = self.backing.swapped_shard(rid)
            return (s is not None and self.free_count_shard(s) > 0
                    and self.backing.can_admit_swapped(rid))
        return bool(self._free) and self.backing.can_admit_swapped(rid)

    def swap_in(self, rid: int) -> Optional[Tuple[int, int]]:
        """Resume a swapped-out request in a free slot (fresh blocks, the
        saved bytes uploaded): decode continues at its saved position with
        no step recomputed. Returns (slot, bytes moved), or None when the
        pool cannot host it yet."""
        if not self.can_admit_swapped(rid):
            return None
        slot = self._pop_free(self.backing.swapped_shard(rid)
                              if self.sharded else None)
        nbytes = self.backing.swap_in(slot, rid)
        self.owner[slot] = rid
        self.valid[slot] = True
        return slot, nbytes

    # -- pooled-cache data movement -----------------------------------------

    def gather(self, idx: Sequence[int]):
        """Sub-caches for slots ``idx`` (slot axis = len(idx)), as new
        contiguous tensors; paged layers as their page-table views."""
        return self.backing.gather(idx)

    def scatter(self, sub, idx: Sequence[int]):
        """Write sub-caches back into slots ``idx`` (distinct indices)."""
        self.backing.scatter(sub, idx)

    def run_chunk(self, params, idx: Sequence[int], tokens: Tensor,
                  pos: Tensor) -> Tensor:
        """Chunk-prefill slots ``idx`` (distinct) in place (gather -> chunk
        -> scatter); returns the per-position chunk logits (len(idx), C,
        V): prompt scoring reads them, plain prefill ignores them."""
        return self.backing.run_chunk(params, idx, tokens, pos)

    def run_decode(self, params, tokens: Tensor, pos: Tensor, temps: Tensor,
                   generator, top_ks: Optional[Tensor] = None,
                   top_ps: Optional[Tensor] = None):
        """ONE decode over the whole pool; returns (next tokens (B,),
        logits (B, 1, V)). top_ks/top_ps are optional (B,) per-slot
        sampling filters (None = disabled); ``generator`` may be None when
        every slot is greedy, and is one generator a shard on a sharded
        pool."""
        return self.backing.run_decode(params, tokens, pos, temps,
                                       generator, top_ks, top_ps)

    def run_verify(self, params, tokens: Tensor, pos: Tensor,
                   prompt_len: Tensor, max_pos: Tensor, score: Tensor,
                   active: Tensor, temps: Tensor,
                   top_ks: Optional[Tensor], top_ps: Optional[Tensor],
                   generator):
        """ONE speculative verify-accept tick over the whole pool
        (``engine.make_verify_step``'s contract): teacher-forces tokens
        (B, k+1) and returns (out_tok (B, k+1), accept_n (B,), logprobs
        (B, k+1)); rejected cache writes are rolled back, so the pool only
        ever holds committed rows. ``generator`` as in ``run_decode``."""
        return self.backing.run_verify(params, tokens, pos, prompt_len,
                                       max_pos, score, active, temps,
                                       top_ks, top_ps, generator)

    def metrics(self) -> dict:
        """Registry 'serve.slots' provider: pool levels (the paged backing's
        keys go out under 'paging')."""
        return {"num_slots": self.num_slots,
                "live": int(self.valid.sum()),
                "free": self.free_count,
                "cache_slots": self.cache_slots,
                "position_capacity": self.position_capacity,
                "total_rows": self.total_rows}

    def shard_metrics(self) -> dict:
        """Per-shard occupancy gauges: ``shard<i>.live_slots`` /
        ``free_slots`` and (sharded backing) the per-shard block and swap
        levels. The scheduler adds placement and steal counters under
        ``serve.shard``."""
        out = {}
        k = self.slots_per_shard
        for s in range(self.num_shards):
            free = self.free_count_shard(s)
            out[f"shard{s}.live_slots"] = k - free
            out[f"shard{s}.free_slots"] = free
        if self.sharded:
            out.update(self.backing.shard_metrics())
        return out

    def stats(self) -> dict:
        return {**self.metrics(), **self.backing.stats()}
