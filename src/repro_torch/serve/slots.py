"""SlotManager: a fixed pool of cache slots for continuous batching (port of
``repro.serve.slots``, without the sharded pool).

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

_SLOT_AXIS = 1      # every per_slot_pos cache leaf: (periods, B, ...)

_SHARDED = "the sharded pool (ROADMAP queue 1)"


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a cache tree (dicts, KVCache, tensors);
    None (a paged layer's placeholder) stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, attention.KVCache):
        return attention.KVCache(*(_tree_map(fn, *xs)
                                   for xs in zip(tree, *rest)))
    return fn(tree, *rest)


@torch.inference_mode()
def _gather(caches, idx: Tensor):
    """Slots ``idx`` of every leaf, as new contiguous tensors."""
    return _tree_map(lambda l: l.index_select(_SLOT_AXIS, idx), caches)


@torch.inference_mode()
def _scatter(caches, sub, idx: Tensor):
    """Write ``sub`` (slot axis = len(idx)) into slots ``idx``, in place."""
    _tree_map(lambda l, s: l.index_copy_(_SLOT_AXIS, idx, s.to(l.dtype)),
              caches, sub)
    return caches


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
    groups: every leaf is dense."""

    is_paged = True

    def __init__(self, cfg: ModelConfig, num_slots: int, cache_slots: int,
                 device: torch.device, block_size: int,
                 num_blocks: Optional[int], paged_window: bool = True,
                 num_window_blocks: Optional[int] = None,
                 swap_bytes_budget: Optional[int] = None,
                 prefix_sharing: bool = False,
                 prefix_align: Optional[int] = None,
                 prefix_capacity: int = 512):
        self.cfg = cfg
        self.num_slots = num_slots
        self.cache_slots = cache_slots
        self.device = device
        self.block_size = block_size
        paged_kw = dict(per_slot_pos=True, device=device,
                        paged_global_attn=True,
                        paged_window_attn=paged_window)
        with torch.inference_mode():
            self.dense = T.init_caches(cfg, num_slots, cache_slots,
                                       **paged_kw)
            self._template = T.init_caches(cfg, 1, cache_slots, **paged_kw)
        # group the paged keys by view length: one pool + page table each
        by_view: Dict[int, List[str]] = {}
        self.key_view: Dict[str, int] = {}
        for i, spec in enumerate(cfg.pattern):
            key = f"p{i}"
            if self.dense[key].get("attn", 0) is not None:
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
                for g in self.groups.values() for key in g.keys}
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
        self._chunk = engine.make_paged_chunk_step(cfg)
        self._decode = engine.make_paged_decode_step(cfg)
        self._verify = None     # at first use: it refuses recurrent layers

    def _idx(self, idx: Sequence[int]) -> Tensor:
        return torch.as_tensor(np.asarray(idx, np.int64)).to(self.device)

    def _block_rows(self, blocks: Sequence[int]) -> Tensor:
        return self._idx(PageTable.block_rows(blocks, self.block_size))

    def _group_pools(self, g: _PageGroup):
        return {k: self.paged[k] for k in g.keys}

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
        _reset(self.dense, self._template, self._idx([slot]))
        shared_pos = 0
        if self.prefix is not None and prompt is not None:
            n, hit, _ = self._match_shared(prompt, len(prompt),
                                           span or prompt_len)
            if n:
                for vl, g in self.groups.items():
                    g.pt.map_shared(slot, [e[vl] for e in hit])
                shared_pos = n * self.block_size
                self.shared_chunks_mapped += n
                self._rows_cache = None
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
                    engine.copy_block_rows(
                        self._group_pools(g),
                        self._block_rows([p[0] for p in pairs]),
                        self._block_rows([p[1] for p in pairs]))
                    self.cow_copies += len(pairs)
                    self._rows_cache = None
            ok, new = g.pt.ensure(slot, upto_pos)
            if not ok and self._reclaim(g, 1):
                ok, more = g.pt.ensure(slot, upto_pos)
                new = new + more
            if new:
                engine.reset_block_rows(self._group_pools(g),
                                        self._block_rows(new))
                self._rows_cache = None
            ok_all = ok_all and ok
        return ok_all

    def release_slot(self, slot: int) -> List[int]:
        freed: List[int] = []
        for g in self.groups.values():
            freed += g.pt.free_slot(slot)
        self._shared_pos.pop(slot, None)
        if freed:
            self._rows_cache = None
        return freed

    # -- swap-out preemption ---------------------------------------------

    def swap_bytes_estimate(self, slot: int) -> int:
        """Bytes a swap_out of ``slot`` would park on the host, from shapes
        alone, so a budget rejection costs no device work."""
        total = self._dense_slot_bytes
        for g in self.groups.values():
            nb = g.pt.mapped_blocks(slot)
            for key in g.keys:
                c = self.paged[key]
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
                got = engine.gather_block_rows(self._group_pools(g),
                                               self._block_rows(phys))
                paged_host.update({
                    key: attention.KVCache(*(x.cpu() for x in c))
                    for key, c in got.items()})
            # shared blocks are released, not stolen: the bytes were just
            # copied, and only this slot's reference drops
            _, released = g.pt.swap_out(slot)
            if sorted(released) != sorted(phys):
                raise RuntimeError(f"swap_out released {released} != "
                                   f"mapped {phys} (group {vl})")
            if released:
                self._rows_cache = None
        dense_host = _tree_map(lambda x: x.cpu(),
                               _gather(self.dense, self._idx([slot])))
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
            engine.upload_block_rows(self._group_pools(g), entry.paged,
                                     self._block_rows(new))
            self._rows_cache = None
        _scatter(self.dense, _tree_map(lambda x: x.to(self.device),
                                       entry.dense), self._idx([slot]))
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
                 device: DeviceLike = None):
        if prefix_sharing and not paged:
            raise ValueError("prefix_sharing needs the paged backing "
                             "(blocks are the sharing granule)")
        if mesh_shards is not None and not paged:
            raise ValueError("mesh_shards needs the paged backing "
                             "(blocks are the per-shard granule)")
        if mesh_shards is not None:
            raise NotImplementedError(
                f"mesh_shards is not ported yet: it comes with {_SHARDED}")
        self.cfg = cfg
        self.num_slots = num_slots
        self.cache_slots = cache_slots
        dev = resolve_device(device)
        self.backing = (_PagedBacking(
            cfg, num_slots, cache_slots, dev, block_size, num_blocks,
            paged_window=paged_window, num_window_blocks=num_window_blocks,
            swap_bytes_budget=swap_bytes_budget,
            prefix_sharing=prefix_sharing, prefix_align=prefix_align,
            prefix_capacity=prefix_capacity)
            if paged else _ContiguousBacking(cfg, num_slots, cache_slots,
                                             dev))
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

    @property
    def live(self) -> List[int]:
        return [i for i in range(self.num_slots) if self.valid[i]]

    def can_admit(self, prompt_len: int = 0, prompt=None,
                  span: Optional[int] = None) -> bool:
        """A free slot AND (paged) the prompt's blocks free in every
        page-table group. With prefix sharing, ``prompt`` (tokens)
        discounts blocks an indexed shared prefix holds, and ``span``
        (prompt + generation budget) bounds ring-group sharing."""
        return bool(self._free) and self.backing.can_admit(
            prompt_len, prompt=prompt, span=span)

    def fits_pool(self, n_positions: int) -> Optional[str]:
        """None if a request spanning ``n_positions`` fits an empty pool;
        else why not (the scheduler's submit-time ValueError)."""
        return self.backing.fits_pool(n_positions)

    def alloc(self, owner: int, prompt_len: int = 0, prompt=None,
              span: Optional[int] = None) -> Optional[int]:
        """Claim the most recently freed slot for request ``owner`` and zero
        its rows (paged: map and zero the prompt's blocks, or map an
        indexed shared prefix read-shared, see ``prefill_start``). Returns
        the slot index, or None when the slots or blocks are exhausted."""
        if not self.can_admit(prompt_len, prompt=prompt, span=span):
            return None
        slot = self._free.pop()
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
        return self.backing.is_paged and rid in self.backing.swaps

    def can_admit_swapped(self, rid: int) -> bool:
        """A free slot AND blocks for the request's saved prefix in every
        page-table group."""
        return bool(self._free) and self.backing.can_admit_swapped(rid)

    def swap_in(self, rid: int) -> Optional[Tuple[int, int]]:
        """Resume a swapped-out request in a free slot (fresh blocks, the
        saved bytes uploaded): decode continues at its saved position with
        no step recomputed. Returns (slot, bytes moved), or None when the
        pool cannot host it yet."""
        if not self.can_admit_swapped(rid):
            return None
        slot = self._free.pop()
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
                   generator: Optional[torch.Generator],
                   top_ks: Optional[Tensor] = None,
                   top_ps: Optional[Tensor] = None):
        """ONE decode over the whole pool; returns (next tokens (B,),
        logits (B, 1, V)). top_ks/top_ps are optional (B,) per-slot
        sampling filters (None = disabled); ``generator`` may be None when
        every slot is greedy."""
        return self.backing.run_decode(params, tokens, pos, temps,
                                       generator, top_ks, top_ps)

    def run_verify(self, params, tokens: Tensor, pos: Tensor,
                   prompt_len: Tensor, max_pos: Tensor, score: Tensor,
                   active: Tensor, temps: Tensor,
                   top_ks: Optional[Tensor], top_ps: Optional[Tensor],
                   generator: Optional[torch.Generator]):
        """ONE speculative verify-accept tick over the whole pool
        (``engine.make_verify_step``'s contract): teacher-forces tokens
        (B, k+1) and returns (out_tok (B, k+1), accept_n (B,), logprobs
        (B, k+1)); rejected cache writes are rolled back, so the pool only
        ever holds committed rows."""
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

    def stats(self) -> dict:
        return {**self.metrics(), **self.backing.stats()}
