"""The 2-D DP wavefront (kinds ``sw`` and ``dtw``) on the card: two CUDA
kernels of ``csrc/dtw_wavefront.cu``, both replacing the TPU kernel
``repro.kernels.dtw_wavefront.dp_tile_pallas``, and their plain PyTorch
versions.

``dp_tile(top, left, corner, a, b, kind=...)`` is one tile: it follows the
wavefront tile-fn contract and returns ``(tile, bottom, right, corner)``,
row-major; leading batch dimensions launch one CTA per tile.

``dp_wavefront(a, b, top0, left0, corner0, kind=..., tile_r=..., tile_c=...)``
is the whole tile wavefront that ``core.wavefront.run_wavefront`` walks over
``dp_tile``, in one cooperative launch (Squire's Alg. 4: CTAs own column
strips and hand each finished row tile to the strip on their right through
a counter). It returns ``(matrix, bottom_row, right_col, corner)``, the
matrix always assembled, and equals its plain version bit for bit.

CPU tensors run the plain versions, CUDA tensors launch the kernels; neither
falls back from one to the other. ``launches`` counts ``dp_tile`` launches
and ``wavefront_launches`` counts ``dp_wavefront`` launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core import wavefront
from repro_torch.kernels import _build

Tensor = torch.Tensor

MAX_TILE = 128
KINDS = {"sw": 0, "dtw": 1}

#: number of CUDA kernel launches so far (CPU calls do not count): dp_tile
launches = 0
#: ... and dp_wavefront
wavefront_launches = 0
#: CTAs of the last dp_wavefront launch (the strips are dealt to them)
last_grid = 0

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 5 + [ctypes.c_float] * 3
             + [ctypes.c_int, ctypes.c_void_p])


def _sw_cell(match, mismatch, gap):
    def cell(diag, up, lft, av, bv):
        sub = torch.where(av == bv, match, mismatch)
        h = torch.maximum(diag + sub, torch.maximum(up - gap, lft - gap))
        return torch.clamp_min(h, 0.0)
    return cell


def _dtw_cell(diag, up, lft, av, bv):
    return torch.abs(av - bv) + torch.minimum(diag, torch.minimum(up, lft))


def dp_tile_plain(top, left, corner, a, b, *, kind="dtw", match=2.0,
                  mismatch=-4.0, gap=4.0):
    """The plain version: ``core.wavefront.dp_tile_diagonal`` with the sw or
    dtw cell (dtw inputs in fp32, sw characters compared as given)."""
    if kind == "sw":
        cell = _sw_cell(float(match), float(mismatch), float(gap))
    elif kind == "dtw":
        cell = _dtw_cell
        a, b = a.to(torch.float32), b.to(torch.float32)
    else:
        raise ValueError(f"unknown tile kind: {kind!r}")
    f32 = torch.float32
    return wavefront.dp_tile_diagonal(cell, top.to(f32), left.to(f32),
                                      corner.to(f32), a, b)


def _batch_view(x: Tensor, batch: int, last: int, name: str):
    """(x viewed as (batch, last), stride between tiles in elements)."""
    if last and x.stride(-1) != 1 and last > 1:
        raise ValueError(f"dp_tile: {name} must be contiguous in its last "
                         f"dimension")
    x2 = x.reshape(batch, last) if last else x.reshape(batch)
    return x2, (x2.stride(0) if batch > 1 else 0)


def dp_tile(top, left, corner, a, b, *, kind="dtw", match=2.0,
            mismatch=-4.0, gap=4.0):
    """One (tr x tc) tile from its boundaries; shapes top (..., tc),
    left (..., tr), corner (...), a (..., tr), b (..., tc)."""
    global launches
    if top.device.type == "cpu":
        return dp_tile_plain(top, left, corner, a, b, kind=kind, match=match,
                             mismatch=mismatch, gap=gap)
    if kind not in KINDS:
        raise ValueError(f"unknown tile kind: {kind!r}")
    dev = top.device
    if dev.type != "cuda" or any(x.device != dev
                                 for x in (left, corner, a, b)):
        raise ValueError("dp_tile: all inputs must be on one CUDA device")
    want = torch.int32 if kind == "sw" else torch.float32
    if a.dtype != want or b.dtype != want:
        raise TypeError(f"dp_tile(kind={kind!r}) takes {want} a and b, got "
                        f"{a.dtype} and {b.dtype}")
    if any(x.dtype != torch.float32 for x in (top, left, corner)):
        raise TypeError("dp_tile: top, left and corner must be float32")
    tr, tc = a.shape[-1], b.shape[-1]
    lead = tuple(a.shape[:-1])
    if (tuple(b.shape[:-1]) != lead or tuple(top.shape) != lead + (tc,)
            or tuple(left.shape) != lead + (tr,)
            or tuple(corner.shape) != lead):
        raise ValueError(
            f"dp_tile: shapes top {tuple(top.shape)}, left "
            f"{tuple(left.shape)}, corner {tuple(corner.shape)}, a "
            f"{tuple(a.shape)}, b {tuple(b.shape)} do not fit one tile")
    if not (1 <= tr <= MAX_TILE and 1 <= tc <= MAX_TILE):
        raise ValueError(f"dp_tile: tile {tr}x{tc} outside 1..{MAX_TILE}")
    batch = math.prod(lead)
    if lead:
        top2, s_top = _batch_view(top, batch, tc, "top")
        left2, s_left = _batch_view(left, batch, tr, "left")
        corner2, s_corner = _batch_view(corner, batch, 0, "corner")
        a2, s_a = _batch_view(a, batch, tr, "a")
        b2, s_b = _batch_view(b, batch, tc, "b")
    else:       # one tile, the read mapper's case: no reshapes
        if not all(x.is_contiguous() for x in (top, left, a, b)):
            raise ValueError("dp_tile: top, left, a and b must be "
                             "contiguous")
        top2, left2, corner2, a2, b2 = top, left, corner, a, b
        s_top = s_left = s_corner = s_a = s_b = 0

    n_tile = batch * tr * tc
    out = torch.empty(n_tile + batch * (tc + tr + 1), dtype=torch.float32,
                      device=dev)
    tile = out[:n_tile].view(lead + (tr, tc))
    bottom = out[n_tile:n_tile + batch * tc].view(lead + (tc,))
    o = n_tile + batch * tc
    right = out[o:o + batch * tr].view(lead + (tr,))
    corner_out = out[o + batch * tr:].view(lead)

    fn = _build.function("dtw_wavefront", "dp_tile_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches += 1
    err = fn(KINDS[kind], top2.data_ptr(), left2.data_ptr(),
             corner2.data_ptr(), a2.data_ptr(), b2.data_ptr(),
             tile.data_ptr(), bottom.data_ptr(), right.data_ptr(),
             corner_out.data_ptr(), batch, tr, tc, s_top, s_left, s_corner,
             s_a, s_b, float(match), float(mismatch), float(gap),
             dev.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"dp_tile kernel launch failed: CUDA error {err}")
    return tile, bottom, right, corner_out


_WF_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                + [ctypes.c_float] * 3 + [ctypes.c_int]
                + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])


def dp_wavefront_plain(a, b, top0, left0, corner0, *, kind="dtw",
                       tile_r: int, tile_c: int, match=2.0, mismatch=-4.0,
                       gap=4.0):
    """The plain version: ``core.wavefront.run_wavefront`` over
    ``dp_tile_plain``, the matrix assembled."""
    tile_fn = functools.partial(dp_tile_plain, kind=kind, match=match,
                                mismatch=mismatch, gap=gap)
    return wavefront.run_wavefront(tile_fn, a, b, top0, left0, corner0,
                                   tile_r, tile_c, assemble=True)


def dp_wavefront(a, b, top0, left0, corner0, *, kind="dtw", tile_r: int,
                 tile_c: int, match=2.0, mismatch=-4.0, gap=4.0):
    """The (n x m) DP matrix of a (..., n) against b (..., m) from its top
    row top0 (..., m), left column left0 (..., n) and corner corner0 (...),
    walked in (tile_r x tile_c) tiles; n and m are multiples of the tile.
    Returns (matrix (..., n, m), bottom_row (..., m), right_col (..., n),
    corner (...)). On the card it is one launch of as many CTAs as the card
    holds at once (at most one per strip), which deal the strips out
    round-robin."""
    global wavefront_launches, last_grid
    if a.device.type == "cpu":
        return dp_wavefront_plain(a, b, top0, left0, corner0, kind=kind,
                                  tile_r=tile_r, tile_c=tile_c, match=match,
                                  mismatch=mismatch, gap=gap)
    if kind not in KINDS:
        raise ValueError(f"unknown tile kind: {kind!r}")
    dev = a.device
    if dev.type != "cuda" or any(x.device != dev
                                 for x in (b, top0, left0, corner0)):
        raise ValueError("dp_wavefront: all inputs must be on one CUDA "
                         "device")
    want = torch.int32 if kind == "sw" else torch.float32
    if a.dtype != want or b.dtype != want:
        raise TypeError(f"dp_wavefront(kind={kind!r}) takes {want} a and b, "
                        f"got {a.dtype} and {b.dtype}")
    if any(x.dtype != torch.float32 for x in (top0, left0, corner0)):
        raise TypeError("dp_wavefront: top0, left0 and corner0 must be "
                        "float32")
    n, m = a.shape[-1], b.shape[-1]
    lead = tuple(a.shape[:-1])
    if (tuple(b.shape[:-1]) != lead or tuple(top0.shape) != lead + (m,)
            or tuple(left0.shape) != lead + (n,)
            or tuple(corner0.shape) != lead):
        raise ValueError(
            f"dp_wavefront: shapes a {tuple(a.shape)}, b {tuple(b.shape)}, "
            f"top0 {tuple(top0.shape)}, left0 {tuple(left0.shape)}, corner0 "
            f"{tuple(corner0.shape)} do not fit one DP matrix")
    if not (1 <= tile_r <= MAX_TILE and 1 <= tile_c <= MAX_TILE):
        raise ValueError(f"dp_wavefront: tile {tile_r}x{tile_c} outside "
                         f"1..{MAX_TILE}")
    if n == 0 or m == 0 or n % tile_r or m % tile_c:
        raise ValueError(f"inputs ({n},{m}) not multiples of tile "
                         f"({tile_r},{tile_c}); pad first")
    batch = math.prod(lead)
    matrix = torch.empty(lead + (n, m), dtype=torch.float32, device=dev)
    ins = [x.reshape(batch, -1).contiguous() for x in (a, b, top0, left0)]
    corner2 = corner0.reshape(batch).contiguous()
    done = torch.zeros(batch * (m // tile_c), dtype=torch.int32, device=dev)
    fn = _build.function("dtw_wavefront", "dp_wavefront_launch",
                         _WF_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    grid = ctypes.c_int(0)
    wavefront_launches += 1
    err = fn(KINDS[kind], *(x.data_ptr() for x in ins), corner2.data_ptr(),
             matrix.data_ptr(), done.data_ptr(), batch, n, m, tile_r,
             tile_c, float(match), float(mismatch), float(gap),
             dev.index or 0, stream, ctypes.byref(grid))
    if err != 0:
        raise RuntimeError(f"dp_wavefront kernel launch failed: CUDA error "
                           f"{err}")
    last_grid = grid.value
    return matrix, matrix[..., -1, :], matrix[..., :, -1], matrix[..., -1, -1]
