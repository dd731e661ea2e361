"""Public wrappers around the CUDA kernels (port of ``repro.kernels.ops``).

They plug the kernels into the core engines: ``chain_scan`` /
``chain_anchors`` into the chain stage, ``dp_tile`` (the wavefront tile-fn)
into ``core.wavefront`` through ``make_sw_tile_fn`` and ``dtw_tile_fn``,
``dp_wavefront`` (the whole tile wavefront in one launch) through
``make_sw_wavefront_fn`` and ``dtw_wavefront_fn`` into ``sw_tiled`` and
``dtw_tiled``, ``radix_hist`` and ``radix_pass`` (one launch per LSD
pass) behind ``radix_sort_chunks``, ``ssm_scan`` (the WKV scan) behind
the reference's T-padding wrapper, and ``flash_attention`` in the model's
(B, S, heads, hd) layout.
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
from repro_torch.kernels import dtw_wavefront as _dp
from repro_torch.kernels.chain_scan import chain_scan  # noqa: F401
from repro_torch.kernels.dtw_wavefront import dp_tile
from repro_torch.kernels.flash_attention import \
    flash_attention as _flash_attention
from repro_torch.kernels.radix_rank import radix_sort_chunks  # noqa: F401
from repro_torch.kernels.ssm_scan import ssm_scan as _ssm_scan


def ssm_scan(r, w, k, v, u=None, chunk: int = 64):
    """WKV scan with T padded to a multiple of ``chunk`` (w = 1, r = k = v =
    0 in the pad), as the reference's wrapper pads for its TPU grid; the
    kernel itself takes any T. Shapes (B, T, d*); returns y (B, T, dv)
    fp32, the state from zero, the final state dropped."""
    b, t, dk = r.shape
    pad = (-t) % chunk
    if pad:
        padk = r.new_zeros((b, pad, dk))
        r = torch.cat([r, padk], dim=1)
        w = torch.cat([w, w.new_ones((b, pad, dk))], dim=1)
        k = torch.cat([k, k.new_zeros((b, pad, dk))], dim=1)
        v = torch.cat([v, v.new_zeros((b, pad, v.shape[-1]))], dim=1)
    y, _ = _ssm_scan(r, w, k, v, u)
    return y[:, :t]


def flash_attention(q, k, v, window: int = 0):
    """Causal attention of a fresh sequence at positions 0..S-1 in the
    model's layout: q (B, S, H, hd), k and v (B, S, KV, hd); returns (B, S,
    H, hd) in q's dtype. The kernel reads the transposed views in place."""
    out = _flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), window)
    return out.transpose(1, 2)


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


def make_sw_wavefront_fn(match=2.0, mismatch=-4.0, gap=4.0):
    """``run_wavefront``'s signature (tile_fn bound) on ``dp_wavefront``,
    kind sw: the whole wavefront in one launch."""
    def run(a, b, top0, left0, corner0, tile_r, tile_c):
        return _dp.dp_wavefront(a, b, top0, left0, corner0, kind="sw",
                                tile_r=tile_r, tile_c=tile_c, match=match,
                                mismatch=mismatch, gap=gap)
    return run


def dtw_wavefront_fn(a, b, top0, left0, corner0, tile_r, tile_c):
    """The same for kind dtw."""
    return _dp.dp_wavefront(a, b, top0, left0, corner0, kind="dtw",
                            tile_r=tile_r, tile_c=tile_c)


def sw_tiled(a, b, params=None, tile_r: int = 128, tile_c: int = 128):
    """End-to-end SW: the tile wavefront in one ``dp_wavefront`` launch."""
    p = params or calign.SWParams()
    fn = make_sw_wavefront_fn(p.match, p.mismatch, p.gap)
    return calign.sw_tiled(a, b, p, tile_r, tile_c, wavefront_fn=fn)


def dtw_tiled(s, r, tile_r: int = 128, tile_c: int = 128, **kw):
    """End-to-end DTW: the tile wavefront in one ``dp_wavefront`` launch."""
    return cdtw.dtw_tiled(s, r, tile_r, tile_c,
                          wavefront_fn=dtw_wavefront_fn, **kw)
