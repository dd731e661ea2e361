"""2-D tiled wavefront engine (port of ``repro.core.wavefront``).

The DP matrix is cut into (tile_r x tile_c) tiles walked in anti-diagonal
order; the boundary vectors between tiles are explicit carries. The engine
is generic over the tile function:

    tile_fn(top: (..., tc), left: (..., tr), corner: (...,), a: (..., tr),
            b: (..., tc)) -> (tile: (..., tr, tc), bottom: (..., tc),
                              right: (..., tr), corner_out: (...,))

Nothing here waits for the device: boundaries stay device tensors (the
corner a 0-d one when unbatched) and no value is read back inside the loop,
so tile launches queue up behind each other. Unlike the reference, which
concatenates the tiles at the end, the assembled matrix is allocated once
and each tile is copied into its place as it is produced.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

Tensor = torch.Tensor
TileFn = Callable[..., Tuple[Tensor, Tensor, Tensor, Tensor]]


def pad_to_multiple(x: Tensor, mult: int, axis: int, fill) -> Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                    device=x.device)], dim=axis)


def run_wavefront(tile_fn: TileFn, a: Tensor, b: Tensor, top0: Tensor,
                  left0: Tensor, corner0: Tensor, tile_r: int, tile_c: int,
                  assemble: bool = True):
    """Walk the (len(a) x len(b)) DP matrix in tile-wavefront order.

    a: (..., n) row inputs; b: (..., m) column inputs, multiples of the
    tile sizes. top0: (..., m) row above the matrix; left0: (..., n) column
    left of it; corner0: (...) value at (-1, -1).

    Returns (matrix (..., n, m) or None, bottom_row (..., m),
    right_col (..., n), corner (...)).
    """
    n, m = a.shape[-1], b.shape[-1]
    if n % tile_r or m % tile_c:
        raise ValueError(f"inputs ({n},{m}) not multiples of tile "
                         f"({tile_r},{tile_c}); pad first")
    nr, nc = n // tile_r, m // tile_c
    lead = tuple(a.shape[:-1])

    bottoms = [[None] * nc for _ in range(nr)]
    rights = [[None] * nc for _ in range(nr)]
    corners = [[None] * nc for _ in range(nr)]
    matrix = None
    if assemble:
        matrix = torch.empty(lead + (n, m), dtype=top0.dtype,
                             device=top0.device)

    # per-tile views, cut once
    a_t = a.reshape(lead + (nr, tile_r)).unbind(-2)
    b_t = b.reshape(lead + (nc, tile_c)).unbind(-2)
    top_t = top0.reshape(lead + (nc, tile_c)).unbind(-2)
    left_t = left0.reshape(lead + (nr, tile_r)).unbind(-2)

    for d in range(nr + nc - 1):                 # wavefront order
        r_lo, r_hi = max(0, d - nc + 1), min(nr - 1, d)
        for r in range(r_lo, r_hi + 1):          # independent tiles of diag d
            c = d - r
            top = bottoms[r - 1][c] if r > 0 else top_t[c]
            left = rights[r][c - 1] if c > 0 else left_t[r]
            if r > 0 and c > 0:
                corner = corners[r - 1][c - 1]
            elif r > 0:
                corner = left_t[r - 1][..., -1]  # == M[r*tr-1, -1]
            elif c > 0:
                corner = top_t[c - 1][..., -1]   # == M[-1, c*tc-1]
            else:
                corner = corner0
            tile, bottom, right, corner_out = tile_fn(
                top, left, corner, a_t[r], b_t[c])
            bottoms[r][c], rights[r][c] = bottom, right
            corners[r][c] = corner_out
            if assemble:
                matrix[..., r * tile_r:(r + 1) * tile_r,
                       c * tile_c:(c + 1) * tile_c] = tile

    bottom_row = torch.cat([bottoms[nr - 1][c] for c in range(nc)], dim=-1)
    right_col = torch.cat([rights[r][nc - 1] for r in range(nr)], dim=-1)
    return matrix, bottom_row, right_col, corners[nr - 1][nc - 1]


def run_wavefront_batched(tile_fn_b: TileFn, a: Tensor, b: Tensor,
                          top0: Tensor, left0: Tensor, corner0: Tensor,
                          tile_r: int, tile_c: int, assemble: bool = True):
    """run_wavefront over a leading batch axis: a (B, n), b (B, m),
    top0 (B, m), left0 (B, n), corner0 (B,). Each tile call serves the whole
    batch, so the batched tile function launches once per tile position.
    """
    if a.dim() != 2 or b.shape[0] != a.shape[0]:
        raise ValueError(f"expected (B, n)/(B, m) inputs, got "
                         f"{tuple(a.shape)} / {tuple(b.shape)}")
    return run_wavefront(tile_fn_b, a, b, top0, left0, corner0,
                         tile_r, tile_c, assemble=assemble)


def dp_tile_diagonal(cell_update, top: Tensor, left: Tensor, corner: Tensor,
                     a: Tensor, b: Tensor):
    """Generic diagonal-vectorized DP tile: M[i,j] = cell_update(diag, up,
    lft, a[i], b[j]) over a (tr x tc) tile given its boundaries, one
    anti-diagonal per step. Leading batch dimensions are carried through.
    """
    tr, tc = a.shape[-1], b.shape[-1]
    lead = tuple(a.shape[:-1])
    mat = torch.zeros(lead + (tr + 1, tc + 1), dtype=top.dtype,
                      device=top.device)
    mat[..., 0, 0] = corner
    mat[..., 0, 1:] = top
    mat[..., 1:, 0] = left

    rows = torch.arange(1, tr + 1, device=top.device)
    for k in range(2, tr + tc + 1):
        cols = k - rows
        valid = (cols >= 1) & (cols <= tc)
        cc = cols.clamp(1, tc)
        diag = mat[..., rows - 1, cc - 1]
        up = mat[..., rows - 1, cc]
        lft = mat[..., rows, cc - 1]
        av = a[..., rows - 1]
        bv = b[..., cc - 1]
        new = cell_update(diag, up, lft, av, bv)
        keep = mat[..., rows, cc]
        mat[..., rows, cc] = torch.where(valid, new, keep)

    tile = mat[..., 1:, 1:]
    return tile, tile[..., -1, :], tile[..., :, -1], tile[..., -1, -1]
