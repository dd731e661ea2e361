"""Smith-Waterman local alignment on the wavefront engine (port of
``repro.core.align``):

    H[i,j] = max(0, H[i-1,j-1] + s(a_i, b_j),
                    H[i-1,j] - gap, H[i,j-1] - gap)

The alignment score is max_{i,j} H[i,j]. The hand-written CUDA tile is
``repro_torch.kernels.dtw_wavefront``; ``_sw_tile_fn`` here is its plain
diagonal-vectorized form. Needleman-Wunsch is not ported yet.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core import wavefront

Tensor = torch.Tensor


class SWParams(NamedTuple):
    match: float = 2.0
    mismatch: float = -4.0
    gap: float = 4.0  # positive cost


def _cell(params: SWParams, diag, up, lft, av, bv):
    sub = torch.where(av == bv, params.match, params.mismatch)
    h = torch.maximum(diag + sub,
                      torch.maximum(up - params.gap, lft - params.gap))
    return torch.clamp_min(h, 0.0)


def sw_ref(a: Tensor, b: Tensor, params: SWParams = SWParams()) -> Tensor:
    """Oracle: the full H matrix, one row at a time.

    Within a row, H[j] = max(x_j, H[j-1] - gap) with
    x_j = max(0, H_up[j-1] + s_j, H_up[j] - gap), whose closed form is
    H[j] = max_{k<=j} (x_k + k*gap) - j*gap: a running max. It equals the
    reference's column scan exactly when the scores are integers (the
    default parameters), since every intermediate is then exact in fp32.
    a (..., n) and b (..., m) may carry leading axes of independent pairs.
    """
    n, m = a.shape[-1], b.shape[-1]
    lead = a.shape[:-1]
    dev = a.device
    kgap = params.gap * torch.arange(m, dtype=torch.float32, device=dev)
    mat = torch.empty(lead + (n, m), dtype=torch.float32, device=dev)
    prev = torch.zeros(lead + (m,), dtype=torch.float32, device=dev)
    zero1 = torch.zeros(lead + (1,), dtype=torch.float32, device=dev)
    for i in range(n):
        diag = torch.cat([zero1, prev[..., :-1]], dim=-1)
        sub = torch.where(a[..., i, None] == b, params.match,
                          params.mismatch)
        x = torch.clamp_min(torch.maximum(diag + sub, prev - params.gap),
                            0.0)
        row = torch.cummax(x + kgap, dim=-1).values - kgap
        mat[..., i, :] = row
        prev = row
    return mat


def sw_score_ref(a: Tensor, b: Tensor, params: SWParams = SWParams()
                 ) -> Tensor:
    return torch.amax(sw_ref(a, b, params))


def _sw_tile_fn(params, top, left, corner, a, b):
    cell = functools.partial(_cell, params)
    return wavefront.dp_tile_diagonal(cell, top, left, corner, a, b)


def sw_tiled(a: Tensor, b: Tensor, params: SWParams = SWParams(),
             tile_r: int = 8, tile_c: int = 8, tile_fn=None):
    """Tiled wavefront SW; returns (H matrix, best score).

    Padding uses sentinel 255, which mismatches every base and sits below
    and right of every real cell, so the true region is unaffected.
    """
    n, m = a.shape[0], b.shape[0]
    dev = a.device
    ap = wavefront.pad_to_multiple(a.to(torch.int32), tile_r, 0, 255)
    bp = wavefront.pad_to_multiple(b.to(torch.int32), tile_c, 0, 255)
    npad, mpad = ap.shape[0], bp.shape[0]

    fn = tile_fn or functools.partial(_sw_tile_fn, params)
    mat, _, _, _ = wavefront.run_wavefront(
        fn, ap, bp,
        top0=torch.zeros((mpad,), dtype=torch.float32, device=dev),
        left0=torch.zeros((npad,), dtype=torch.float32, device=dev),
        corner0=torch.zeros((), dtype=torch.float32, device=dev),
        tile_r=tile_r, tile_c=tile_c, assemble=True)
    mat = mat[:n, :m]
    return mat, torch.amax(mat)


def sw_score(a: Tensor, b: Tensor, params: SWParams = SWParams(), **kw):
    return sw_tiled(a, b, params, **kw)[1]


def sw_end_position(mat: Tensor):
    """(i, j) of the best local alignment end (first in row-major order)."""
    flat = torch.argmax(mat.reshape(-1))
    return flat // mat.shape[1], flat % mat.shape[1]
