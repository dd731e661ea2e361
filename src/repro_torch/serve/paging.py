"""Block-granular (paged) allocation for the serving pool's cache slots
(port of ``repro.serve.paging``: host-side numpy; the swap store holds host
tensors).

The contiguous slot pool reserves ``cache_slots`` rows per request, the
worst case. This module carves the slot axis into fixed-size blocks:

  * ``BlockPool``   - a refcounted free list of physical blocks, the unit
                      the scheduler allocates and admits on.
  * ``PageTable``   - per-slot logical-block -> physical-block map; blocks
                      map on demand as a request's write position crosses
                      a block boundary and are freed at retire.
  * ``PrefixIndex`` - LRU map from chained hashes of block-aligned prompt
                      chunks to the blocks holding their KV (prefix
                      sharing; copy-on-write keeps sharers apart).
  * ``SwapStore``   - host-side parking lot for the block bytes of
                      swap-preempted requests, with an optional byte
                      budget.

The device sees only the flat row vectors ``PageTable.rows()`` derives,
which the paged steps use to gather a per-slot view before attending
(``models.attention.paged_view``) and scatter it back after. Unmapped
logical blocks point at one TRASH block past the pool (physical index
``num_blocks``): reads through it are masked to the empty-slot encoding,
and writes for dead or unmapped positions land there.

Ring mode (``ring=True``) pages a sliding-window layer's ring of
``window`` positions: blocks map lazily while a request ramps up, then the
full ring stays resident and writes past the window wrap onto mapped
blocks, so ``ensure`` clamps instead of rejecting.

Every state guard raises ``ValueError`` / ``RuntimeError``, never a bare
``assert``: corruption of the pool must be loud under ``python -O`` too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple


import numpy as np


class BlockPool:
    """Refcounted free list of ``num_blocks`` physical cache blocks of
    ``block_size`` positions each. LIFO reuse (like the slot free list)
    keeps hot blocks hot. ``alloc`` hands a block out at refcount 1;
    ``ref`` adds a sharer; ``free`` drops one reference
    and only returns the block to the free list when the count reaches
    zero — so a prefix block shared by many slots survives until the
    last sharer lets go. ``allocated`` stays the double-assignment
    guard for the free list itself."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(f"need num_blocks >= 1 and block_size >= 1, "
                             f"got {num_blocks}, {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self.allocated = np.zeros(num_blocks, bool)
        self.refs = np.zeros(num_blocks, np.int32)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def shared_count(self) -> int:
        """Blocks currently held by more than one reference."""
        return int(np.sum(self.refs > 1))

    def _check_id(self, block: int):
        """Reject out-of-range ids with ValueError (never IndexError, and
        never numpy negative indexing: ``free(-1)`` used to silently free
        the LAST block and push ``-1`` onto the free list, so a later
        ``alloc()`` returned ``-1`` and every derived flat row aliased
        another slot's KV)."""
        if not 0 <= block < self.num_blocks:
            raise ValueError(f"block id {block} outside pool "
                             f"[0, {self.num_blocks})")

    def alloc(self) -> Optional[int]:
        """Claim one block (refcount 1); None when the pool is
        exhausted."""
        if not self._free:
            return None
        b = self._free.pop()
        if self.allocated[b]:
            raise RuntimeError(f"block {b} double-assigned")
        self.allocated[b] = True
        self.refs[b] = 1
        return b

    def ref(self, block: int):
        """Add one reference to an allocated block (read-shared map)."""
        self._check_id(block)
        if not self.allocated[block]:
            raise ValueError(f"cannot ref unallocated block {block}")
        self.refs[block] += 1

    def refcount(self, block: int) -> int:
        self._check_id(block)
        return int(self.refs[block])

    def free(self, block: int) -> bool:
        """Drop one reference; the block returns to the free list only
        at refcount 0. Returns True when this call actually freed it."""
        self._check_id(block)
        if not self.allocated[block]:
            raise ValueError(f"block {block} is not allocated")
        self.refs[block] -= 1
        if self.refs[block] > 0:
            return False
        self.allocated[block] = False
        self._free.append(block)
        return True


class PageTable:
    """Per-slot logical->physical block map over a shared BlockPool.

    ``slot_positions`` is the logical view length the fused steps gather:
    the contiguous allocator's ``cache_slots`` for global-attention
    layers, or the ring length ``min(window, cache_slots)`` for a
    sliding-window layer in ring mode. Ring addressing
    (``pos % slot_positions``) and blockwise-attention accumulation order
    resolve through the view bit-identically to the contiguous/dense
    layout. The last block of a slot may be partially used (internal
    fragmentation) when ``slot_positions % block_size != 0``.

    ``ring=True`` marks the view as a ring buffer: write positions past
    ``slot_positions`` wrap onto already-mapped blocks, so ``ensure``
    clamps its target instead of rejecting it, and the full ring is the
    steady-state mapping.
    """

    def __init__(self, pool: BlockPool, num_slots: int, slot_positions: int,
                 ring: bool = False):
        self.pool = pool
        self.num_slots = num_slots
        self.slot_positions = slot_positions
        self.ring = ring
        self.block_size = pool.block_size
        self.blocks_per_slot = -(-slot_positions // pool.block_size)
        self.trash = pool.num_blocks        # sentinel physical block
        self.table = np.full((num_slots, self.blocks_per_slot), self.trash,
                             np.int32)

    # -- sizing ---------------------------------------------------------

    def blocks_for(self, n_positions: int) -> int:
        """Blocks needed to back ``n_positions`` written positions. The
        clamp to ``blocks_per_slot`` is what makes this ring-correct: a
        ring never needs more than the full ring resident."""
        return min(-(-max(n_positions, 0) // self.block_size),
                   self.blocks_per_slot)

    def can_map(self, n_blocks: int) -> bool:
        return self.pool.free_count >= n_blocks

    def mapped_blocks(self, slot: int) -> int:
        return int(np.sum(self.table[slot] != self.trash))

    # -- lifecycle ------------------------------------------------------

    def ensure(self, slot: int, upto_pos: int) -> Tuple[bool, List[int]]:
        """Map every unmapped logical block covering positions
        [0, upto_pos]. Returns (fully_mapped, newly_mapped_physical).
        Ring mode clamps ``upto_pos`` to the ring: a write at
        ``pos >= slot_positions`` lands at ``pos % slot_positions``,
        inside the fully-mapped steady-state ring. On pool exhaustion the
        blocks mapped so far stay mapped (they are valid — the caller
        either retries after preempting a victim or frees the whole
        slot)."""
        if self.ring:
            upto_pos = min(upto_pos, self.slot_positions - 1)
        if not 0 <= upto_pos < self.slot_positions:
            raise ValueError(f"position {upto_pos} outside slot of "
                             f"{self.slot_positions}")
        new: List[int] = []
        for lb in range(upto_pos // self.block_size + 1):
            if self.table[slot, lb] != self.trash:
                continue
            b = self.pool.alloc()
            if b is None:
                return False, new
            self.table[slot, lb] = b
            new.append(b)
        return True, new

    def free_slot(self, slot: int) -> List[int]:
        """Unmap ``slot`` and drop its reference on every block it held
        (retire/preempt). Returns the blocks *released from this slot* —
        shared blocks stay allocated for their remaining sharers (and
        the PrefixIndex), only refcount-0 blocks hit the free list."""
        released = [int(b) for b in self.table[slot] if b != self.trash]
        for b in released:
            self.pool.free(b)
        self.table[slot] = self.trash
        return released

    # -- prefix sharing / copy-on-write ---------------------------------

    def map_shared(self, slot: int, blocks: Sequence[int]):
        """Map ``blocks`` (already-allocated physical ids, e.g. a prefix
        hit from the PrefixIndex) as the logical prefix of ``slot``,
        read-shared: each gains one reference. The target logical slots
        must be unmapped."""
        if len(blocks) > self.blocks_per_slot:
            raise ValueError(f"{len(blocks)} shared blocks into a slot "
                             f"of {self.blocks_per_slot}")
        for lb, b in enumerate(blocks):
            if self.table[slot, lb] != self.trash:
                raise RuntimeError(f"slot {slot} logical block {lb} is "
                                   f"already mapped")
            self.pool.ref(int(b))       # raises on unallocated / bad id
            self.table[slot, lb] = int(b)

    def is_shared(self, slot: int, lb: int) -> bool:
        b = int(self.table[slot, lb])
        return b != self.trash and self.pool.refs[b] > 1

    def write_blocks(self, slot: int, lo_pos: int, hi_pos: int) -> List[int]:
        """Logical blocks an upcoming write over positions
        [``lo_pos``, ``hi_pos``] will touch — the set a caller must CoW
        if shared. Ring mode reduces positions mod the ring (a wrapped
        write lands at ``pos % slot_positions``, possibly inside a
        shared prefix block); a span covering the whole ring touches
        every block."""
        if hi_pos < lo_pos:
            raise ValueError(f"empty write span [{lo_pos}, {hi_pos}]")
        if self.ring and hi_pos - lo_pos + 1 >= self.slot_positions:
            return list(range(self.blocks_per_slot))
        if self.ring:
            vps = {p % self.slot_positions
                   for p in range(lo_pos, hi_pos + 1)}
            return sorted({vp // self.block_size for vp in vps})
        hi = min(hi_pos, self.slot_positions - 1)
        if lo_pos > hi:
            return []
        return list(range(lo_pos // self.block_size,
                          hi // self.block_size + 1))

    def cow_block(self, slot: int, lb: int) -> Optional[Tuple[int, int]]:
        """Give ``slot`` a private copy of shared logical block ``lb``:
        allocate a fresh physical block, remap, and drop this slot's
        reference on the old one (its other sharers keep theirs).
        Returns (old_phys, new_phys) — the caller must copy the old
        block's device rows into the new one (engine.copy_block_rows)
        before the next step reads them — or None when the pool is
        exhausted (state unchanged; the caller preempts or retries)."""
        old = int(self.table[slot, lb])
        if old == self.trash:
            raise RuntimeError(f"cow of unmapped logical block {lb} "
                               f"of slot {slot}")
        if self.pool.refs[old] <= 1:
            raise RuntimeError(f"cow of private block {old} (slot {slot}, "
                               f"logical {lb})")
        new = self.pool.alloc()
        if new is None:
            return None
        self.table[slot, lb] = new
        self.pool.free(old)             # drop our share; old stays alive
        return old, new

    # -- swap-out preemption --------------------------------------------

    def swap_out(self, slot: int) -> Tuple[np.ndarray, List[int]]:
        """Evict ``slot`` for a later resume: returns (saved page-table
        row, freed physical blocks in logical order). The physical ids in
        the saved row are dead the moment this returns — what the resume
        needs is WHICH logical blocks were mapped, and ``ensure`` maps
        bottom-up so that is always the [0, n) prefix. The caller copies
        the blocks' bytes out (engine.gather_block_rows) BEFORE calling
        this, then parks both in a SwapStore."""
        row = self.table[slot].copy()
        mapped = np.flatnonzero(row != self.trash)
        if mapped.size and not (mapped == np.arange(mapped.size)).all():
            raise RuntimeError(f"slot {slot} mapping is not a logical "
                               f"prefix: {row.tolist()}")
        # Shared blocks are *released*, not stolen: free() only drops this
        # slot's reference, so other sharers (and the PrefixIndex) keep
        # the block — the victim's bytes were gathered to host before
        # this call, a copy, never a steal.
        freed = self.free_slot(slot)
        return row, freed

    def swap_in(self, slot: int, n_blocks: int) -> Optional[List[int]]:
        """Re-map ``n_blocks`` fresh physical blocks as the logical
        prefix of an empty slot — the resume half of swap preemption.
        All-or-nothing: returns the new physical blocks in logical order,
        or None (nothing mapped) when the pool cannot supply them. The
        caller uploads the saved bytes into the returned blocks' rows
        (engine.upload_block_rows); it must NOT zero them."""
        if not 0 <= n_blocks <= self.blocks_per_slot:
            raise ValueError(f"swap_in of {n_blocks} blocks into a slot "
                             f"of {self.blocks_per_slot}")
        if not (self.table[slot] == self.trash).all():
            raise RuntimeError(f"slot {slot} is not empty: "
                               f"{self.table[slot].tolist()}")
        if not self.can_map(n_blocks):
            return None
        new: List[int] = []
        for lb in range(n_blocks):
            b = self.pool.alloc()
            if b is None:
                raise RuntimeError("can_map lied about pool capacity")
            self.table[slot, lb] = b
            new.append(b)
        return new

    # -- device-facing index vectors ------------------------------------

    def rows(self, slots: Optional[Sequence[int]] = None) -> np.ndarray:
        """Flat physical row per view position: (len(slots),
        slot_positions) int32. View position v of slot s lives at
        physical row table[s, v // bs] * bs + v % bs; unmapped blocks
        resolve to trash rows (>= num_blocks * bs), which the gather
        masks and the scatter sacrifices."""
        tab = self.table if slots is None else self.table[list(slots)]
        bs = self.block_size
        full = (tab[:, :, None] * bs
                + np.arange(bs, dtype=np.int32)[None, None, :])
        return full.reshape(tab.shape[0], -1)[:, :self.slot_positions] \
                   .astype(np.int32)

    @staticmethod
    def block_rows(blocks: Sequence[int], block_size: int) -> np.ndarray:
        """Flat physical rows covered by ``blocks`` (for block resets)."""
        b = np.asarray(list(blocks), np.int32)
        return (b[:, None] * block_size
                + np.arange(block_size, dtype=np.int32)[None, :]).reshape(-1)

    # -- introspection ---------------------------------------------------

    def check_invariants(self, external_refs: Optional[np.ndarray] = None):
        """Refcount agreement: every block's mapping count in the table,
        plus any references held outside it (``external_refs`` — e.g.
        the PrefixIndex's holds), equals ``pool.refs``; refcount > 0 iff
        allocated; the free list is exactly the unallocated blocks, no
        duplicates. (Exercised by the property tests on every
        operation.) Raises RuntimeError — must fire under ``python -O``
        too."""
        mapped = self.table[self.table != self.trash]
        counts = np.bincount(mapped, minlength=self.pool.num_blocks)
        if external_refs is not None:
            counts = counts + np.asarray(external_refs, np.int64)
        if not (counts == self.pool.refs).all():
            raise RuntimeError("table/index mapping counts disagree with "
                               "pool refcounts")
        if not ((self.pool.refs > 0) == self.pool.allocated).all():
            raise RuntimeError("refcount > 0 iff allocated violated")
        free = self.pool._free
        if len(free) != len(set(free)):
            raise RuntimeError("duplicate block on the free list")
        if set(free) != set(np.flatnonzero(~self.pool.allocated).tolist()):
            raise RuntimeError("table / pool free list disagree")

    def stats(self) -> Dict[str, Any]:
        """Counts are int, utilization float (obs.schema pins this)."""
        used = self.pool.used_count
        return {"blocks_total": self.pool.num_blocks,
                "blocks_used": used,
                "blocks_free": self.pool.num_blocks - used,
                "block_size": self.block_size,
                "block_utilization": used / self.pool.num_blocks,
                "shared_blocks": self.pool.shared_count}


# ---------------------------------------------------------------------------
# prefix index (hash of block-aligned prompt chunks -> physical blocks)
# ---------------------------------------------------------------------------

class PrefixIndex:
    """LRU map from a *chained* hash of block-aligned prompt-token chunks
    to the physical blocks holding that chunk's KV, one block per
    page-table group (keyed by view length).

    The hash chains (digest of chunk i folds in chunk i-1's digest)
    because KV at a position depends on the entire prefix before it —
    two prompts sharing chunk i's tokens but diverging earlier must NOT
    share chunk i's blocks. Matching therefore walks chunks 0, 1, ...
    and stops at the first miss.

    The index itself is a *reference holder*: the owning backing refs a
    block once per entry it appears in, so published blocks survive
    their donor's retirement. Entries are bounded (``capacity``, LRU)
    and evictable under pool pressure — evicting an entry only returns
    blocks nobody else maps (refcount reaching 0); blocks still shared
    by live slots merely lose their index hold.

    Pure bookkeeping: the backing does the pool ref/unref around
    ``publish``/``evict_lru`` (it owns the per-group pools)."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"need capacity >= 1, got {capacity}")
        from collections import OrderedDict
        self.capacity = capacity
        self._entries: "OrderedDict[bytes, Dict[int, int]]" = OrderedDict()
        self.lookups = 0        # match() calls
        self.hit_chunks = 0     # chunks matched, cumulative
        self.published = 0      # entries inserted, cumulative
        self.evicted = 0        # entries evicted (LRU or pressure)

    @staticmethod
    def chunk_keys(tokens: Sequence[int], block_size: int,
                   max_chunks: int) -> List[bytes]:
        """Chained digests of the leading full ``block_size`` chunks of
        ``tokens`` (at most ``max_chunks``)."""
        import hashlib
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        n = min(len(toks) // block_size, max(max_chunks, 0))
        keys: List[bytes] = []
        digest = b""
        for i in range(n):
            chunk = toks[i * block_size:(i + 1) * block_size]
            digest = hashlib.blake2b(digest + chunk.tobytes(),
                                     digest_size=16).digest()
            keys.append(digest)
        return keys

    def match(self, keys: Sequence[bytes]) -> List[Dict[int, int]]:
        """Longest indexed prefix of ``keys``: per-chunk
        {view_len: physical block} dicts, stopping at the first miss.
        Hits refresh LRU order."""
        out: List[Dict[int, int]] = []
        for k in keys:
            entry = self._entries.get(k)
            if entry is None:
                break
            self._entries.move_to_end(k)
            out.append(entry)
        self.lookups += 1
        self.hit_chunks += len(out)
        return out

    def publish(self, key: bytes, blocks: Dict[int, int]) -> bool:
        """Insert ``key`` -> ``blocks`` if absent. Returns True when
        inserted (the caller must have ref'd every block first); False
        when the chunk is already indexed (concurrent prefills of the
        same new prefix: first publisher wins)."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        self._entries[key] = dict(blocks)
        self.published += 1
        return True

    def evict_lru(self, keep: Optional[set] = None) \
            -> Optional[Dict[int, int]]:
        """Drop the least-recently-used entry whose key is not in
        ``keep``, returning its blocks so the caller can unref them;
        None when nothing is evictable (empty, or only kept entries
        remain — an admission must not evict the very chain it is about
        to map)."""
        for key in self._entries:           # LRU -> MRU order
            if not keep or key not in keep:
                blocks = self._entries.pop(key)
                self.evicted += 1
                return blocks
        return None

    def holds(self, num_blocks_by_view: Dict[int, int]) \
            -> Dict[int, np.ndarray]:
        """Per-group reference counts this index holds, as
        {view_len: int64[num_blocks]} — the ``external_refs`` argument
        of PageTable.check_invariants."""
        out = {vl: np.zeros(n, np.int64)
               for vl, n in num_blocks_by_view.items()}
        for blocks in self._entries.values():
            for vl, b in blocks.items():
                if vl in out:
                    out[vl][b] += 1
        return out

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, int]:
        return {"prefix_entries": len(self._entries),
                "prefix_lookups": self.lookups,
                "prefix_hit_chunks": self.hit_chunks,
                "prefix_published": self.published,
                "prefix_evicted": self.evicted}


# ---------------------------------------------------------------------------
# host-side swap buffer (preempt="swap")
# ---------------------------------------------------------------------------

def _leaf_bytes(tree) -> int:
    """Bytes of the tensor leaves of a tree of dicts, tuples and lists (a
    ``KVCache`` is a tuple); None leaves count 0."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(_leaf_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_leaf_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


@dataclasses.dataclass
class SwapEntry:
    """Everything a preempted request needs to resume in a fresh slot
    with zero recomputed decode steps: how many logical blocks each
    page-table group (keyed by view length — the global-KV group plus
    one per distinct window-ring length) had mapped, the blocks' KV
    bytes per paged cache key (host tensors, logical order), and the
    slot's dense per-slot leaves (SSM state, per-row pos, any unpaged
    rings)."""
    blocks: Dict[int, int]      # view_len -> mapped logical-prefix blocks
    paged: Dict[str, Any]       # pattern key -> host KVCache block bytes
    dense: Any

    @property
    def nbytes(self) -> int:
        return sum(_leaf_bytes(x) for x in (self.paged, self.dense))


class SwapStore:
    """Host-side parking lot for swapped-out requests, keyed by rid.

    The paged backing fills it on ``swap_out`` (block bytes gathered to
    host + dense snapshot) and drains it on ``swap_in``; byte counters
    feed the scheduler's swap-traffic stats.

    ``max_bytes`` bounds the held bytes: the store is otherwise unbounded
    — under sustained overload, swapped-out requests that never re-admit
    would accumulate host memory forever. ``can_hold`` is the caller's
    admission check (the scheduler falls back to recompute-preemption on
    rejection); an over-budget ``put`` that sneaks past it raises."""

    def __init__(self, max_bytes: Optional[int] = None):
        self.max_bytes = max_bytes
        self._d: Dict[int, SwapEntry] = {}
        self.held_bytes = 0     # resident right now (drops on pop)
        self.bytes_out = 0      # device -> host (swap_out), cumulative
        self.bytes_in = 0       # host -> device (swap_in), cumulative
        self.rejected = 0       # puts refused by the byte budget
        self.migrated_out = 0   # entries handed to another shard's store
        self.migrated_in = 0    # entries accepted from another store

    def can_hold(self, nbytes: int) -> bool:
        return self.max_bytes is None \
            or self.held_bytes + nbytes <= self.max_bytes

    def reject(self):
        """Record a budget rejection — the store owns the count, whether
        the caller prechecked with can_hold (the backing's path) or an
        over-budget put raised."""
        self.rejected += 1

    def put(self, rid: int, entry: SwapEntry) -> int:
        if rid in self._d:
            raise ValueError(f"rid {rid} already swapped out")
        n = entry.nbytes
        if not self.can_hold(n):
            self.reject()
            raise RuntimeError(
                f"swap budget exceeded: holding {self.held_bytes} + "
                f"{n} > {self.max_bytes} bytes (rid {rid})")
        self._d[rid] = entry
        self.held_bytes += n
        self.bytes_out += n
        return n

    def get(self, rid: int) -> SwapEntry:
        return self._d[rid]

    def pop(self, rid: int) -> SwapEntry:
        entry = self._d.pop(rid)
        self.held_bytes -= entry.nbytes
        self.bytes_in += entry.nbytes
        return entry

    def __contains__(self, rid: int) -> bool:
        return rid in self._d

    def __len__(self) -> int:
        return len(self._d)

    # -- cross-store migration (work-stealing a swapped request) --------

    def migrate_out(self, rid: int) -> SwapEntry:
        """Remove ``rid`` for transfer to another shard's store. Unlike
        ``pop`` no bytes move between host and device, so the swap traffic
        counters stay; ``migrated_out`` records the event."""
        entry = self._d.pop(rid)
        self.held_bytes -= entry.nbytes
        self.migrated_out += 1
        return entry

    def migrate_in(self, rid: int, entry: SwapEntry) -> int:
        """Accept an entry migrated from another shard's store, against
        this store's byte budget. Returns the bytes now held for it; raises
        over budget (callers check ``can_hold`` first: a refused migration
        leaves the request on its home shard)."""
        if rid in self._d:
            raise ValueError(f"rid {rid} already swapped out")
        n = entry.nbytes
        if not self.can_hold(n):
            self.reject()
            raise RuntimeError(
                f"swap budget exceeded: holding {self.held_bytes} + "
                f"{n} > {self.max_bytes} bytes (migrated rid {rid})")
        self._d[rid] = entry
        self.held_bytes += n
        self.migrated_in += 1
        return n

    def stats(self) -> Dict[str, int]:
        return {"swapped_held": len(self._d),
                "swap_bytes_held": self.held_bytes,
                "swap_bytes_budget": (-1 if self.max_bytes is None
                                      else self.max_bytes),
                "swap_rejected": self.rejected,
                "swap_bytes_out": self.bytes_out,
                "swap_bytes_in": self.bytes_in,
                "swap_migrated_out": self.migrated_out,
                "swap_migrated_in": self.migrated_in}
