"""Chunk-parallel radix sort + parallel merge (port of ``repro.core.sort``).

Keys are unsigned 32-bit values carried as int64 in [0, 2^32): torch's
``uint32`` lacks ``>>``, ``searchsorted`` and ``argmin`` on the CPU. Values
ride along (sort-by-key). Every pass is stable and so is the merge, so the
result equals a stable sort by key, whatever the chunk count.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

RADIX_BITS = 8
RADIX = 1 << RADIX_BITS
U32_MAX = 0xFFFFFFFF


def _counting_pass(keys: Tensor, vals: Tensor, shift: int
                   ) -> Tuple[Tensor, Tensor]:
    """One stable LSD pass over the last axis (uint32 keys as int64).

    The reference scatters each key to ``start[bucket] + rank in bucket``;
    that permutation is exactly a stable argsort of the 8-bit digit.
    """
    bucket = (keys >> shift) & (RADIX - 1)
    order = torch.argsort(bucket, dim=-1, stable=True)
    return (torch.gather(keys, -1, order), torch.gather(vals, -1, order))


def radix_sort_chunk(keys: Tensor, vals: Tensor, key_bits: int = 32
                     ) -> Tuple[Tensor, Tensor]:
    """Full LSD radix sort along the last axis (leading axes are chunks)."""
    for shift in range(0, key_bits, RADIX_BITS):
        keys, vals = _counting_pass(keys, vals, shift)
    return keys, vals


def merge_sorted(ak: Tensor, av: Tensor, bk: Tensor, bv: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """Stable parallel merge of two sorted (key, value) arrays along the
    last axis (leading axes are independent): a's keys go before b's equal
    keys."""
    na, nb = ak.shape[-1], bk.shape[-1]
    dev = ak.device
    ak, bk = ak.contiguous(), bk.contiguous()
    pos_a = torch.arange(na, device=dev) + torch.searchsorted(
        bk, ak, side="left")
    pos_b = torch.arange(nb, device=dev) + torch.searchsorted(
        ak, bk, side="right")
    lead = ak.shape[:-1]
    nk = torch.zeros(lead + (na + nb,), dtype=ak.dtype, device=dev)
    nv = torch.zeros(lead + (na + nb,), dtype=av.dtype, device=dev)
    nk.scatter_(-1, pos_a, ak)
    nk.scatter_(-1, pos_b, bk)
    nv.scatter_(-1, pos_a, av)
    nv.scatter_(-1, pos_b, bv)
    return nk, nv


def radix_sort(keys: Tensor, vals: Optional[Tensor] = None,
               num_chunks: int = 8, key_bits: int = 32,
               min_parallel: int = 10_000):
    """Chunk-parallel radix sort (paper Alg. 1) along the last axis: sort
    ``num_chunks`` chunks in one batched pass, then merge them pairwise in
    log2 rounds. Arrays below ``min_parallel`` sort as one chunk. Leading
    axes are independent arrays, each sorted as a single call would."""
    n = keys.shape[-1]
    lead = keys.shape[:-1]
    if vals is None:
        vals = torch.arange(n, dtype=torch.int64,
                            device=keys.device).expand(keys.shape)
    if n < min_parallel or num_chunks == 1:
        return radix_sort_chunk(keys, vals, key_bits)

    pad = (-n) % num_chunks
    if pad:
        keys = torch.cat([keys, torch.full(lead + (pad,), U32_MAX,
                                           dtype=keys.dtype,
                                           device=keys.device)], dim=-1)
        vals = torch.cat([vals, torch.zeros(lead + (pad,), dtype=vals.dtype,
                                            device=vals.device)], dim=-1)
    lc = keys.shape[-1] // num_chunks
    kc, vc = radix_sort_chunk(keys.reshape(lead + (num_chunks, lc)),
                              vals.reshape(lead + (num_chunks, lc)),
                              key_bits)

    chunks = [(kc[..., i, :], vc[..., i, :]) for i in range(num_chunks)]
    while len(chunks) > 1:
        nxt = [merge_sorted(*chunks[i], *chunks[i + 1])
               for i in range(0, len(chunks) - 1, 2)]
        if len(chunks) % 2:
            nxt.append(chunks[-1])
        chunks = nxt
    out_k, out_v = chunks[0]
    return out_k[..., :n], out_v[..., :n]


def sort_i32(keys: Tensor, vals: Optional[Tensor] = None, **kw):
    """Signed int32 sort: flipping the sign bit maps int32 order onto
    uint32 order. ``keys`` hold int32 values (any integer dtype)."""
    uk = (keys.to(torch.int64) & U32_MAX) ^ 0x80000000
    ok, ov = radix_sort(uk, vals, **kw)
    back = ok ^ 0x80000000
    return torch.where(back >= 2**31, back - 2**32, back), ov
