"""One 2-D DP wavefront tile (kinds ``sw`` and ``dtw``): the CUDA kernel
``csrc/dtw_wavefront.cu`` (which replaces the TPU kernel
``repro.kernels.dtw_wavefront.dp_tile_pallas``) and its plain PyTorch
version.

``dp_tile(top, left, corner, a, b, kind=...)`` follows the wavefront
tile-fn contract and returns ``(tile, bottom, right, corner)``, row-major.
CPU tensors run the plain version, CUDA tensors launch the kernel; it never
falls back from one to the other. Leading batch dimensions launch one CTA
per tile. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import wavefront
from repro_torch.kernels import _build

Tensor = torch.Tensor

MAX_TILE = 128
KINDS = {"sw": 0, "dtw": 1}

#: number of CUDA kernel launches so far (CPU calls do not count)
launches = 0

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
