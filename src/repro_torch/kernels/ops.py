"""Public wrappers around the CUDA kernels (port of ``repro.kernels.ops``).

They plug the kernels into the core engines: ``chain_scan`` /
``chain_anchors`` into the chain stage, ``dp_tile`` (the wavefront tile-fn)
into ``core.wavefront`` through ``make_sw_tile_fn`` and ``dtw_tile_fn``.
The kernel emits its tile row-major, so no diagonal-major relayout follows,
and the chain band is not padded to 128 lanes: that was a TPU register
artefact, and the kernel takes any T <= 128.
"""

from __future__ import annotations

import functools

from repro_torch.core import align as calign
from repro_torch.core import chain as cchain
from repro_torch.kernels.chain_scan import chain_scan  # noqa: F401
from repro_torch.kernels.dtw_wavefront import dp_tile


def chain_anchors(q, r, T: int = 64, params=None, anchor_valid=None):
    """Drop-in for ``core.chain.chain_anchors`` on the kernel path."""
    params = params or cchain.ChainParams()
    w = cchain.anchor_weights(q.shape[0], params, anchor_valid, q.device)
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
