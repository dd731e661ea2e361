"""Banded max-plus chain recurrence: the CUDA kernel ``csrc/chain_scan.cu``
(which replaces the TPU kernel ``repro.kernels.chain_scan.chain_scan_pallas``)
and its plain PyTorch version.

    f(i) = max(w_i, max_t S[i, t] + f(i - t)),   t in [1, T]

``chain_scan(scores, w)`` runs the plain version for CPU tensors and
launches the kernel for CUDA tensors; it never falls back from one to the
other. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.chain import chain_sequential
from repro_torch.kernels import _build

Tensor = torch.Tensor

MAX_T = 128

#: number of CUDA kernel launches so far (CPU calls do not count)
launches = 0


def chain_scan_plain(scores: Tensor, w: Tensor) -> Tuple[Tensor, Tensor]:
    """The plain version: ``core.chain.chain_sequential``'s row loop."""
    return chain_sequential(scores, w)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def chain_scan(scores: Tensor, w: Tensor) -> Tuple[Tensor, Tensor]:
    """scores (N, T) or (P, N, T) fp32, NEG where invalid; w (N,) or (P, N).

    Returns (f fp32, off int32 in [0, T], 0 = chain start), shaped like w.
    """
    global launches
    if scores.device.type == "cpu":
        return chain_scan_plain(scores, w)
    if scores.device.type != "cuda" or w.device != scores.device:
        raise ValueError(f"chain_scan: scores on {scores.device}, "
                         f"w on {w.device}")
    if scores.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"chain_scan: float32 required, got {scores.dtype} "
                        f"and {w.dtype}")
    if scores.dim() not in (2, 3) or tuple(w.shape) != tuple(
            scores.shape[:-1]):
        raise ValueError(f"chain_scan: scores {tuple(scores.shape)} and "
                         f"w {tuple(w.shape)} do not match")
    n, t = scores.shape[-2], scores.shape[-1]
    if not 1 <= t <= MAX_T:
        raise ValueError(f"chain_scan: band T={t} outside [1, {MAX_T}]")
    if not (scores.is_contiguous() and w.is_contiguous()):
        raise ValueError("chain_scan: scores and w must be contiguous")
    problems = scores.shape[0] if scores.dim() == 3 else 1
    f = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    off = torch.empty(w.shape, dtype=torch.int32, device=w.device)
    fn = _build.function("chain_scan", "chain_scan_launch", _ARGTYPES)
    dev = scores.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches += 1
    err = fn(scores.data_ptr(), w.data_ptr(), f.data_ptr(), off.data_ptr(),
             problems, n, t, dev.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"chain_scan kernel launch failed: CUDA error "
                           f"{err}")
    return f, off
