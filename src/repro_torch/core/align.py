"""Smith-Waterman local alignment on the wavefront engine (port of
``repro.core.align``):

    H[i,j] = max(0, H[i-1,j-1] + s(a_i, b_j),
                    H[i-1,j] - gap, H[i,j-1] - gap)

The alignment score is max_{i,j} H[i,j]. The hand-written CUDA kernels
are ``repro_torch.kernels.dtw_wavefront`` (one tile, or the whole wavefront
in one launch); ``_sw_tile_fn`` here is the tile's plain
diagonal-vectorized form. Needleman-Wunsch (global alignment: no zero
floor, linear-gap boundaries) runs on the same wavefront engine with a
plain tile that scans rows (``_nw_rows``: a few launches per row, not per
anti-diagonal cell set); the reference has no kernel for it.
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
             tile_r: int = 8, tile_c: int = 8, wavefront_fn=None):
    """Tiled wavefront SW; returns (H matrix, best score).

    Padding uses sentinel 255, which mismatches every base and sits below
    and right of every real cell, so the true region is unaffected. The
    wavefront is ``wavefront_fn(a, b, top0, left0, corner0, tile_r,
    tile_c)`` with run_wavefront's result (default: ``run_wavefront`` over
    the plain tile; the kernel path passes the one-launch kernel).
    """
    n, m = a.shape[0], b.shape[0]
    dev = a.device
    ap = wavefront.pad_to_multiple(a.to(torch.int32), tile_r, 0, 255)
    bp = wavefront.pad_to_multiple(b.to(torch.int32), tile_c, 0, 255)
    npad, mpad = ap.shape[0], bp.shape[0]

    run = wavefront_fn or functools.partial(
        wavefront.run_wavefront, functools.partial(_sw_tile_fn, params))
    mat, _, _, _ = run(
        ap, bp, torch.zeros((mpad,), dtype=torch.float32, device=dev),
        torch.zeros((npad,), dtype=torch.float32, device=dev),
        torch.zeros((), dtype=torch.float32, device=dev), tile_r, tile_c)
    mat = mat[:n, :m]
    return mat, torch.amax(mat)


def sw_score(a: Tensor, b: Tensor, params: SWParams = SWParams(), **kw):
    return sw_tiled(a, b, params, **kw)[1]


def sw_end_position(mat: Tensor):
    """(i, j) of the best local alignment end (first in row-major order)."""
    flat = torch.argmax(mat.reshape(-1))
    return flat // mat.shape[1], flat % mat.shape[1]


# --------------------------------------------------------------------------
# Needleman-Wunsch (global alignment): the same left/up/diag dependency
# pattern as SW/DTW (paper §V-C) with other boundaries and no floor.
# --------------------------------------------------------------------------

def _nw_cell(params: SWParams, diag, up, lft, av, bv):
    """One NW cell (the reference's form; ``_nw_rows`` is its row scan)."""
    sub = torch.where(av == bv, params.match, params.mismatch)
    return torch.maximum(diag + sub,
                         torch.maximum(up - params.gap, lft - params.gap))


def _nw_rows(params: SWParams, top: Tensor, left: Tensor, corner: Tensor,
             a: Tensor, b: Tensor) -> Tensor:
    """The (len(a), len(b)) NW block below ``top`` (the row above it), right
    of ``left`` (the column left of it) with ``corner`` at their meeting,
    one row at a time.

    Within a row, H[j] = max(x_j, H[j-1] - gap) with
    x_j = max(H_up[j-1] + s_j, H_up[j] - gap), whose closed form is
    H[j] = max(max_{k<=j} (x_k + k*gap), H[-1] - gap) - j*gap: a running
    max. It equals the reference's cell-by-cell recurrence exactly when the
    scores are integers (the default parameters), since every intermediate
    is then exact in fp32.
    """
    g = params.gap
    n, m = a.shape[-1], b.shape[-1]
    kgap = g * torch.arange(m, dtype=torch.float32, device=top.device)
    sub = torch.where(a[:, None] == b[None, :], params.match,
                      params.mismatch)
    corners = torch.cat([corner.reshape(1), left[:-1]])   # M[i-1, -1]
    floors = left - g                                     # M[i, -1] - gap
    mat = torch.empty((n, m), dtype=torch.float32, device=top.device)
    prev = top
    for i in range(n):
        diag = torch.cat([corners[i:i + 1], prev[:-1]])
        x = torch.maximum(diag + sub[i], prev - g)
        run = torch.cummax(x + kgap, dim=-1).values
        prev = torch.maximum(run, floors[i]) - kgap
        mat[i] = prev
    return mat


def nw_ref(a: Tensor, b: Tensor, params: SWParams = SWParams()) -> Tensor:
    """Oracle: the full score matrix with linear gap boundaries
    (M[i, -1] = -(i+1)*gap, M[-1, j] = -(j+1)*gap), as one row-scanned
    block."""
    n, m = a.shape[-1], b.shape[-1]
    g, dev = params.gap, a.device
    return _nw_rows(
        params, -g * torch.arange(1, m + 1, dtype=torch.float32, device=dev),
        -g * torch.arange(1, n + 1, dtype=torch.float32, device=dev),
        torch.zeros((), dtype=torch.float32, device=dev), a, b)


def nw_tiled(a: Tensor, b: Tensor, params: SWParams = SWParams(),
             tile_r: int = 8, tile_c: int = 8):
    """Tiled-wavefront global alignment; returns (matrix, score).

    Each tile is a row-scanned block (``_nw_rows``) on the plain
    ``run_wavefront``. Padding uses sentinels 254/255 (mutual mismatch), so
    padded cells sit below and right of every true cell and the true region
    is unaffected; the score is read at (n-1, m-1).
    """
    n, m = a.shape[0], b.shape[0]
    dev = a.device
    ap = wavefront.pad_to_multiple(a.to(torch.int32), tile_r, 0, 254)
    bp = wavefront.pad_to_multiple(b.to(torch.int32), tile_c, 0, 255)
    npad, mpad = ap.shape[0], bp.shape[0]

    def tile_fn(top, left, corner, aa, bb):
        tile = _nw_rows(params, top, left, corner, aa, bb)
        return tile, tile[-1], tile[:, -1], tile[-1, -1]

    g = params.gap
    top0 = -g * torch.arange(1, mpad + 1, dtype=torch.float32, device=dev)
    left0 = -g * torch.arange(1, npad + 1, dtype=torch.float32, device=dev)
    mat, _, _, _ = wavefront.run_wavefront(
        tile_fn, ap, bp, top0, left0,
        torch.zeros((), dtype=torch.float32, device=dev), tile_r, tile_c)
    mat = mat[:n, :m]
    return mat, mat[n - 1, m - 1]
