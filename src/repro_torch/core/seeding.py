"""Minimap2-style seeding (port of ``repro.core.seeding``): minimizers ->
hash-index probe -> radix sort of the anchors by reference position.

The hash table is two sorted arrays (hash, position) probed with
``searchsorted``; variable-length outputs are fixed-capacity arrays with
validity masks. Hashes are uint32 values carried as int64 and masked to
32 bits after every multiply and shift (torch's ``uint32`` lacks ``>>``,
``searchsorted`` and ``argmin`` on the CPU).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import sort as rsort
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor
MASK32 = 0xFFFFFFFF


def _mul32(x: Tensor, m: int) -> Tensor:
    """(x * m) mod 2^32 for x, m in [0, 2^32), without int64 overflow:
    each partial product stays below 2^48."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & MASK32


def hash32(x: Tensor) -> Tensor:
    """Murmur3 finalizer on uint32 values (int64 carrier), wraps mod 2^32."""
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def kmer_codes(seq: Tensor, k: int) -> Tensor:
    """2-bit pack k-mers: seq (n,) in 0..3 -> (n-k+1,) codes. k <= 15."""
    nk = seq.shape[0] - k + 1
    s = seq.to(torch.int64)
    code = torch.zeros((nk,), dtype=torch.int64, device=seq.device)
    for t in range(k):
        code = ((code << 2) | s[t:t + nk]) & MASK32
    return code


def minimizers(seq: Tensor, k: int, w: int
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Window minimizers: per window of w consecutive k-mers, the k-mer with
    the smallest hash, leftmost on ties. Returns (positions, hashes, keep)
    of length n-k-w+2; ``keep`` masks repeats of the previous window's pick.
    """
    h = hash32(kmer_codes(seq, k))
    nw = h.shape[0] - w + 1
    # hash * w + offset: the min is the smallest hash, then the leftmost
    keyed = torch.stack([h[t:t + nw] * w + t for t in range(w)], dim=0)
    best = torch.amin(keyed, dim=0)
    arg = best % w
    hmin = best // w
    pos = arg + torch.arange(nw, device=seq.device)
    keep = torch.cat([torch.ones((1,), dtype=torch.bool, device=seq.device),
                      pos[1:] != pos[:-1]])
    return pos, hmin, keep


class Index(NamedTuple):
    """Reference minimizer index: hash-sorted arrays (int64 on the device)."""
    hashes: Tensor     # (n_idx,) uint32 values, sorted
    positions: Tensor  # (n_idx,) reference positions, grouped by hash


def build_index(ref: Union[np.ndarray, Tensor], k: int, w: int,
                device: DeviceLike = None) -> Index:
    """Index construction on ``device`` (``None``: the card): minimizers of
    the whole reference, deduplicated, stably sorted by hash."""
    seq = torch.as_tensor(np.asarray(ref),
                          device=resolve_device(device)).to(torch.int64)
    pos, h, keep = minimizers(seq, k, w)
    pos, h = pos[keep], h[keep]
    order = torch.argsort(h, stable=True)
    return Index(hashes=h[order], positions=pos[order])


def lookup_anchors(index: Index, qpos: Tensor, qhash: Tensor, qvalid: Tensor,
                   max_occ: int = 8):
    """Vectorized hash-table probe -> fixed-capacity anchor set (q, r, valid)
    of shape (n_min * max_occ,)."""
    lo = torch.searchsorted(index.hashes, qhash, side="left")
    hi = torch.searchsorted(index.hashes, qhash, side="right")
    occ = torch.arange(max_occ, device=qpos.device)[None, :]
    slot = lo[:, None] + occ
    hit = (slot < hi[:, None]) & qvalid[:, None]
    slot = slot.clamp(0, index.positions.shape[0] - 1)
    r = index.positions[slot]
    q = qpos[:, None].expand(r.shape)
    return q.reshape(-1), r.reshape(-1), hit.reshape(-1)


def seed(index: Index, read: Tensor, k: int, w: int, max_occ: int = 8,
         num_sort_chunks: int = 8, valid_len: Optional[int] = None):
    """Full seeding stage: minimizers -> lookup -> radix sort by r_pos.

    ``valid_len``: the true read length when ``read`` is padded to a shape
    bucket; windows beyond it are masked. Invalid anchors take key 2^32-1
    and sort to the tail. Returns (q_sorted, r_sorted, valid_sorted).
    """
    qpos, qh, qvalid = minimizers(read, k, w)
    if valid_len is not None:
        n_windows = int(valid_len) - k - w + 2
        qvalid = qvalid & (torch.arange(qpos.shape[0], device=read.device)
                           < n_windows)
    q, r, valid = lookup_anchors(index, qpos, qh, qvalid, max_occ)
    key = torch.where(valid, r, torch.full_like(r, MASK32))
    packed = (q << 1) | valid.to(torch.int64)
    rk, pv = rsort.radix_sort(key, packed, num_chunks=num_sort_chunks,
                              min_parallel=0)
    q_sorted = pv >> 1
    valid_sorted = ((pv & 1) == 1) & (rk != MASK32)
    r_sorted = torch.where(rk >= 2**31, rk - 2**32, rk)   # int32 view
    return q_sorted, r_sorted, valid_sorted
