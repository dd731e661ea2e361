"""SlotManager: a fixed pool of cache slots for continuous batching (port of
the contiguous half of ``repro.serve.slots``).

The pool holds B cache slots over the engine's caches
(``transformer.init_caches(per_slot_pos=True)``): a request is allocated a
slot, its state lives in that slot's rows of every cache leaf, and
retirement frees the slot for the next admission. The batch shape never
changes, only the masks do.

Every slot reserves its worst-case rows of every leaf (``cache_slots``
positions for global attention, the ``window`` ring for a sliding window):
the contiguous backing. Every cache leaf carries the slot axis at position 1
((periods, B, ...)), so gather, scatter and reset are ``index_select`` /
``index_copy_`` along that axis. Gathered sub-batches are new contiguous
tensors, as the ``ssm_scan`` kernel takes its initial state. There is no
jit, and so no pad-by-repeat of sub-batches to a few compiled widths: a
chunk runs on exactly the slots that need it.

The paged backing (block pools, page tables, swap, prefix sharing) and the
sharded pool come with the paging slice (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention
from repro_torch.models import transformer as T
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve import engine

Tensor = torch.Tensor

_SLOT_AXIS = 1      # every per_slot_pos cache leaf: (periods, B, ...)

_PAGING = "the paging slice (ROADMAP queue 1, item 4)"


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a cache tree (dicts, KVCache, tensors)."""
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

    @property
    def total_rows(self) -> int:
        """Attention cache positions reserved across the pool (global KV
        and window rings)."""
        return sum(self.num_slots * _attn_view_len(s, self.cache_slots)
                   for s in self.cfg.pattern if s.mixer == "attn")

    def _idx(self, idx: Sequence[int]) -> Tensor:
        return torch.as_tensor(np.asarray(idx, np.int64)).to(self.device)

    def alloc_reset(self, slot: int):
        _reset(self.caches, self._template, self._idx([slot]))

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

    def stats(self) -> dict:
        return {"allocator": "contiguous"}


class SlotManager:
    """Fixed pool of ``num_slots`` decode-cache slots.

    Host-side bookkeeping (LIFO free list, per-slot owner and validity
    mask) plus whole-tree gather/scatter/reset over the pooled caches. Each
    slot's clock lives in the caches' per-row ``pos`` leaves and in the
    scheduler's request state; ``valid[i]`` masks live slots (the scheduler
    decodes the full pool every step; dead rows compute but are never
    read). The caches live on ``device`` (the card unless told otherwise).
    """

    def __init__(self, cfg: ModelConfig, num_slots: int, cache_slots: int,
                 *, paged: bool = False, prefix_sharing: bool = False,
                 mesh_shards: Optional[int] = None,
                 device: DeviceLike = None):
        if prefix_sharing and not paged:
            raise ValueError("prefix_sharing needs the paged backing "
                             "(blocks are the sharing granule)")
        if mesh_shards is not None and not paged:
            raise ValueError("mesh_shards needs the paged backing "
                             "(blocks are the per-shard granule)")
        if paged:
            raise NotImplementedError(
                f"the paged backing is not ported yet: it comes with "
                f"{_PAGING}")
        self.cfg = cfg
        self.num_slots = num_slots
        self.cache_slots = cache_slots
        self.backing = _ContiguousBacking(cfg, num_slots, cache_slots,
                                          resolve_device(device))
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        self.owner: List[Optional[int]] = [None] * num_slots
        self.valid = np.zeros(num_slots, bool)
        obs_metrics.REGISTRY.register_provider("serve.slots", self)

    @property
    def caches(self):
        """The pooled cache tree."""
        return self.backing.caches

    @property
    def position_capacity(self) -> int:
        """Global-KV cache positions backing the pool."""
        return self.backing.position_capacity

    @property
    def total_rows(self) -> int:
        """All attention cache positions allocated (global KV and window
        rings)."""
        return self.backing.total_rows

    # -- lifecycle -----------------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def live(self) -> List[int]:
        return [i for i in range(self.num_slots) if self.valid[i]]

    def can_admit(self) -> bool:
        """A free slot is the only gate of the contiguous backing."""
        return bool(self._free)

    def alloc(self, owner: int) -> Optional[int]:
        """Claim the most recently freed slot for request ``owner`` and zero
        its cache rows. Returns the slot index, or None when the pool is
        full."""
        if not self._free:
            return None
        slot = self._free.pop()
        self.backing.alloc_reset(slot)
        self.owner[slot] = owner
        self.valid[slot] = True
        return slot

    def release(self, slot: int):
        """Evict (EOS / max-tokens / abort): mark free. The stale rows are
        masked out by ``valid`` until the next alloc resets them."""
        if not self.valid[slot]:
            raise RuntimeError(f"slot {slot} is not live")
        self.owner[slot] = None
        self.valid[slot] = False
        self._free.append(slot)

    # -- pooled-cache data movement -----------------------------------------

    def gather(self, idx: Sequence[int]):
        """Sub-caches for slots ``idx`` (slot axis = len(idx)), as new
        contiguous tensors."""
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

    def metrics(self) -> dict:
        """Registry 'serve.slots' provider: pool levels."""
        return {"num_slots": self.num_slots,
                "live": int(self.valid.sum()),
                "free": self.free_count,
                "cache_slots": self.cache_slots,
                "position_capacity": self.position_capacity,
                "total_rows": self.total_rows}

    def stats(self) -> dict:
        return {**self.metrics(), **self.backing.stats()}
