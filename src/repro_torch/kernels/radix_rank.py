"""Rank step of one 8-bit LSD radix pass: the CUDA kernel
``csrc/radix_rank.cu`` (which replaces the TPU kernel
``repro.kernels.radix_rank.radix_rank_pallas``) and its plain PyTorch
version.

For keys (n_chunks, chunk_len), unsigned 32-bit values carried as int64,
and bucket = (key >> shift) & 255: each key's stable rank within its
(chunk, bucket), and each chunk's 256-bucket histogram.

``radix_rank(keys, shift)`` runs the plain version for CPU tensors and
launches the kernel for CUDA tensors; it never falls back from one to the
other. Any ``chunk_len`` is taken. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

RADIX = 256

#: number of CUDA kernel launches so far (CPU calls do not count)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def buckets(keys: Tensor, shift: int) -> Tensor:
    """The pass's digit of each key (int64), as the kernel computes it."""
    return (keys >> shift) & (RADIX - 1)


def radix_rank_plain(keys: Tensor, shift: int = 0) -> Tuple[Tensor, Tensor]:
    """The plain version: a key's rank is its place in a stable sort of the
    digits, less the start of its bucket. Returns (ranks (n_chunks,
    chunk_len) int32, hists (n_chunks, 256) int32)."""
    bucket = buckets(keys, shift)
    hists = torch.zeros(keys.shape[:-1] + (RADIX,), dtype=torch.int64,
                        device=keys.device)
    hists.scatter_add_(-1, bucket, torch.ones_like(bucket))
    starts = torch.cumsum(hists, dim=-1) - hists
    order = torch.argsort(bucket, dim=-1, stable=True)
    sorted_b = torch.gather(bucket, -1, order)
    place = torch.arange(keys.shape[-1], device=keys.device).expand_as(order)
    ranks = torch.empty_like(bucket)
    ranks.scatter_(-1, order, place - torch.gather(starts, -1, sorted_b))
    return ranks.to(torch.int32), hists.to(torch.int32)


def radix_rank(keys: Tensor, shift: int = 0) -> Tuple[Tensor, Tensor]:
    """keys (n_chunks, chunk_len) int64 in [0, 2^32) -> (ranks int32 of the
    same shape, hists (n_chunks, 256) int32)."""
    global launches
    if keys.device.type == "cpu":
        return radix_rank_plain(keys, shift)
    if keys.device.type != "cuda":
        raise ValueError(f"radix_rank: keys on {keys.device}")
    if keys.dtype != torch.int64:
        raise TypeError(f"radix_rank: int64 keys required (uint32 values), "
                        f"got {keys.dtype}")
    if keys.dim() != 2 or keys.shape[0] < 1 or keys.shape[1] < 1:
        raise ValueError(f"radix_rank: keys must be (n_chunks, chunk_len), "
                         f"got {tuple(keys.shape)}")
    if keys.shape[1] >= 2**31 or keys.shape[0] >= 2**31:
        raise ValueError(f"radix_rank: shape {tuple(keys.shape)} too large")
    if not 0 <= shift <= 31:
        raise ValueError(f"radix_rank: shift {shift} outside [0, 31]")
    if not keys.is_contiguous():
        raise ValueError("radix_rank: keys must be contiguous")
    n_chunks, chunk_len = keys.shape
    dev = keys.device
    ranks = torch.empty((n_chunks, chunk_len), dtype=torch.int32, device=dev)
    hists = torch.empty((n_chunks, RADIX), dtype=torch.int32, device=dev)
    fn = _build.function("radix_rank", "radix_rank_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches += 1
    err = fn(keys.data_ptr(), ranks.data_ptr(), hists.data_ptr(), n_chunks,
             chunk_len, shift, dev.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"radix_rank kernel launch failed: CUDA error "
                           f"{err}")
    return ranks, hists
