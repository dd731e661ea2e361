"""Dynamic Time Warping (port of ``repro.core.dtw``, paper §III-C, Alg. 4)
on the wavefront engine.

Cell recurrence:  M[i,j] = |S[i]-R[j]| + min(M[i-1,j-1], M[i-1,j], M[i,j-1])

  * dtw_ref   — row by row, one cell at a time (the single-worker baseline).
  * dtw_diag  — the whole matrix by anti-diagonals.
  * dtw_tiled — the Squire mapping: tiles walked in wavefront order, the
                boundary vectors the handoffs between them. The hand-written
                CUDA kernels are ``repro_torch.kernels.dtw_wavefront`` (kind
                ``dtw``: one tile, or the whole wavefront in one launch);
                ``_dtw_tile_fn`` is the tile's plain form.

Boundary convention: virtual row/col -1 hold BIG except corner (-1,-1) = 0,
so M[0,0] = |S[0]-R[0]|.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import wavefront

Tensor = torch.Tensor

BIG = float(np.float32(np.finfo(np.float32).max / 4))


def _cell(diag, up, lft, av, bv):
    return torch.abs(av - bv) + torch.minimum(diag, torch.minimum(up, lft))


def dtw_ref(s: Tensor, r: Tensor) -> Tensor:
    """Oracle: row by row, each row a left-to-right scan, in float32 scalar
    arithmetic on the host. Returns the (n, m) matrix on s's device."""
    sv = s.detach().cpu().numpy().astype(np.float32)
    rv = r.detach().cpu().numpy().astype(np.float32)
    n, m = len(sv), len(rv)
    big = np.float32(BIG)
    mat = np.empty((n, m), np.float32)
    prev = np.full(m, big, np.float32)
    for i in range(n):
        lft, diag = big, (np.float32(0.0) if i == 0 else big)
        av = sv[i]
        for j in range(m):
            up = prev[j]
            val = np.abs(av - rv[j]) + min(diag, min(up, lft))
            mat[i, j] = val
            lft, diag = val, up
        prev = mat[i]
    return torch.as_tensor(mat, device=s.device)


def dtw_diag(s: Tensor, r: Tensor) -> Tensor:
    """Anti-diagonal vectorized full matrix (fine-grain parallel, untiled)."""
    dev = s.device
    tile, _, _, _ = wavefront.dp_tile_diagonal(
        _cell,
        top=torch.full((r.shape[-1],), BIG, dtype=torch.float32, device=dev),
        left=torch.full((s.shape[-1],), BIG, dtype=torch.float32,
                        device=dev),
        corner=torch.zeros((), dtype=torch.float32, device=dev),
        a=s.to(torch.float32), b=r.to(torch.float32))
    return tile


def _dtw_tile_fn(top, left, corner, a, b):
    return wavefront.dp_tile_diagonal(_cell, top, left, corner, a, b)


def dtw_tiled(s: Tensor, r: Tensor, tile_r: int = 8, tile_c: int = 8,
              assemble: bool = True, wavefront_fn=None):
    """Tiled wavefront DTW. Inputs are padded to tile multiples with 1e18
    samples, so no path through a padded cell can be cheaper than a true
    one. Returns (matrix (n, m) or None, distance). ``wavefront_fn(a, b,
    top0, left0, corner0, tile_r, tile_c)`` replaces ``run_wavefront`` over
    the plain tile when given (the one-launch kernel, which always
    assembles the matrix)."""
    n, m = s.shape[0], r.shape[0]
    dev = s.device
    sp = wavefront.pad_to_multiple(s.to(torch.float32), tile_r, 0, 1e18)
    rp = wavefront.pad_to_multiple(r.to(torch.float32), tile_c, 0, 1e18)
    npad, mpad = sp.shape[0], rp.shape[0]

    run = wavefront_fn or functools.partial(
        wavefront.run_wavefront, _dtw_tile_fn, assemble=assemble)
    mat, bottom, _, _ = run(
        sp, rp, torch.full((mpad,), BIG, dtype=torch.float32, device=dev),
        torch.full((npad,), BIG, dtype=torch.float32, device=dev),
        torch.zeros((), dtype=torch.float32, device=dev), tile_r, tile_c)

    if assemble:
        mat = mat[:n, :m]
        return mat, mat[n - 1, m - 1]
    # without the matrix the distance is the last bottom entry, which is
    # the true corner only when no padding was added
    if npad == n and mpad == m:
        return None, bottom[m - 1]
    raise ValueError("assemble=False requires tile-aligned inputs")


def dtw_distance(s: Tensor, r: Tensor, **kw) -> Tensor:
    return dtw_tiled(s, r, **kw)[1]
