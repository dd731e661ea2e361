"""Public wrappers around the CUDA kernels (port of ``repro.kernels.ops``).

They plug the kernels into the core engines: ``chain_scan`` /
``chain_anchors`` into the chain stage, ``dp_tile`` (the wavefront tile-fn)
into ``core.wavefront`` through ``make_sw_tile_fn`` and ``dtw_tile_fn``
(``sw_tiled``, ``dtw_tiled``), and ``radix_rank`` into the chunk-parallel
LSD passes of ``radix_sort_chunks``.
The kernel emits its tile row-major, so no diagonal-major relayout follows,
and the chain band is not padded to 128 lanes: that was a TPU register
artefact, and the kernel takes any T <= 128.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import align as calign
from repro_torch.core import chain as cchain
from repro_torch.core import dtw as cdtw
from repro_torch.kernels.chain_scan import chain_scan  # noqa: F401
from repro_torch.kernels.dtw_wavefront import dp_tile
from repro_torch.kernels.radix_rank import buckets, radix_rank


def chain_anchors(q, r, T: int = 64, params=None, anchor_valid=None):
    """Drop-in for ``core.chain.chain_anchors`` on the kernel path. A
    (P, N) stack of problems is one ``chain_scan`` launch."""
    params = params or cchain.ChainParams()
    w = cchain.anchor_weights(q.shape, params, anchor_valid, q.device)
    scores = cchain.chain_scores(q, r, T, params, anchor_valid=anchor_valid)
    f, off = chain_scan(scores, w)
    return f, cchain.pred_from_offsets(off)


def dtw_tile_fn(top, left, corner, a, b):
    return dp_tile(top, left, corner, a, b, kind="dtw")


def make_sw_tile_fn(match=2.0, mismatch=-4.0, gap=4.0):
    return functools.partial(dp_tile, kind="sw", match=match,
                             mismatch=mismatch, gap=gap)


def sw_tiled(a, b, params=None, tile_r: int = 128, tile_c: int = 128):
    """End-to-end SW: the wavefront scheduler over the kernel's tiles."""
    p = params or calign.SWParams()
    fn = make_sw_tile_fn(p.match, p.mismatch, p.gap)
    return calign.sw_tiled(a, b, p, tile_r, tile_c, tile_fn=fn)


def dtw_tiled(s, r, tile_r: int = 128, tile_c: int = 128, **kw):
    """End-to-end DTW: the wavefront scheduler over the kernel's tiles."""
    return cdtw.dtw_tiled(s, r, tile_r, tile_c, tile_fn=dtw_tile_fn, **kw)


def radix_sort_chunks(keys, vals=None, key_bits: int = 32):
    """Chunk-parallel LSD radix sort on the rank kernel (paper Alg. 1).

    keys: (n_chunks, chunk_len) unsigned 32-bit values carried as int64;
    each row comes back sorted, stably, with ``vals`` (default: each key's
    index in its chunk, int32) carried along. The caller merges the chunks
    (``core.sort.merge_sorted``). Per 8-bit pass the kernel ranks the keys;
    the exclusive prefix of the histograms, the gather of each key's bucket
    start and the scatter are plain torch, as the reference does them
    outside its kernel.
    """
    n_chunks, clen = keys.shape
    if vals is None:
        vals = torch.arange(clen, dtype=torch.int32,
                            device=keys.device).expand(n_chunks, clen)
    for shift in range(0, key_bits, 8):
        ranks, hists = radix_rank(keys, shift)
        starts = torch.cumsum(hists, dim=1) - hists       # exclusive
        pos = (torch.take_along_dim(starts, buckets(keys, shift), dim=1)
               + ranks).to(torch.int64)
        keys = torch.empty_like(keys).scatter_(1, pos, keys)
        vals = torch.empty_like(vals).scatter_(1, pos, vals)
    return keys, vals
