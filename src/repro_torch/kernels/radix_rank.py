"""The LSD radix passes of paper Alg. 1: the CUDA kernels of
``csrc/radix_rank.cu`` (which replace the TPU kernel
``repro.kernels.radix_rank.radix_rank_pallas`` and the glue around it in
``repro.kernels.ops.radix_sort_chunks``) and their plain PyTorch versions.

For keys (n_chunks, chunk_len), unsigned 32-bit values carried as int64,
and bucket = (key >> shift) & 255:

- ``radix_rank(keys, shift)``: each key's stable rank within its (chunk,
  bucket), and each chunk's 256-bucket histogram;
- ``radix_hist(keys, key_bits)``: each chunk's histogram of every 8-bit
  digit of a ``key_bits`` sort, and its exclusive prefix (the bucket
  starts);
- ``radix_pass(keys, vals, starts, pass_idx)``: one stable counting-sort
  pass, each key and value scattered to its bucket start plus its rank.

Each runs its plain version for CPU tensors and launches its kernel for
CUDA tensors; none falls back from one to the other. The rank and pass
kernels cut each chunk into tiles of ``tile`` keys (one of ``TILES``;
``tile_for`` picks one when the caller does not), one CTA each, chained by
a decoupled look-back over status words kept in scratch (``_Scratch``);
``radix_rank_tiles_plain`` follows that tile order. ``radix_sort_chunks``
is the whole sort: one ``radix_hist`` launch, then one ``radix_pass`` per
digit.
``launches``, ``hist_launches`` and ``pass_launches`` count kernel launches;
``last_grid`` holds the CTAs of the last rank or pass launch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

RADIX = 256
MAX_PASSES = 4              # 8-bit digits of a 32-bit key
TILES = (1024, 2048)        # keys per CTA the kernels take
WAVE = 512                  # tiles of 1,024 beyond which 2,048 is faster
EPOCHS = 1 << 30            # status words carry a 30-bit launch epoch

#: kernel launches so far, per entry point (CPU calls do not count)
launches = 0
hist_launches = 0
pass_launches = 0
#: CTAs of the last radix_rank or radix_pass launch
last_grid = 0

_P, _I, _LL, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_uint
_RANK_ARGS = [_P] * 5 + [_I, _LL, _I, _I, _U, _I, _P]
_PASS_ARGS = [_P] * 7 + [_I, _LL, _I, _I, _I, _I, _U, _I, _P]
_HIST_ARGS = [_P] * 5 + [_I, _LL, _I, _I, _I, _P]
_SORT_ARGS = [_P] * 10 + [_I, _LL, _I, _I, _I, _U, _I, _P]


def buckets(keys: Tensor, shift: int) -> Tensor:
    """The pass's digit of each key (int64), as the kernels compute it."""
    return (keys >> shift) & (RADIX - 1)


def n_passes_of(key_bits: int) -> int:
    if not 1 <= key_bits <= 8 * MAX_PASSES:
        raise ValueError(f"key_bits {key_bits} outside [1, 32]")
    return -(-key_bits // 8)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _stable_ranks(digits: Tensor, n_values: int) -> Tuple[Tensor, Tensor]:
    """Stable rank of each digit among equal digits along the last axis,
    and the histogram over ``n_values`` values (both int64)."""
    hists = torch.zeros(digits.shape[:-1] + (n_values,), dtype=torch.int64,
                        device=digits.device)
    hists.scatter_add_(-1, digits, torch.ones_like(digits))
    starts = torch.cumsum(hists, dim=-1) - hists
    order = torch.argsort(digits, dim=-1, stable=True)
    sorted_d = torch.gather(digits, -1, order)
    place = torch.arange(digits.shape[-1],
                         device=digits.device).expand_as(order)
    ranks = torch.empty_like(digits)
    ranks.scatter_(-1, order, place - torch.gather(starts, -1, sorted_d))
    return ranks, hists


def radix_rank_plain(keys: Tensor, shift: int = 0) -> Tuple[Tensor, Tensor]:
    """The plain version: a key's rank is its place in a stable sort of the
    digits, less the start of its bucket. Returns (ranks (n_chunks,
    chunk_len) int32, hists (n_chunks, 256) int32)."""
    ranks, hists = _stable_ranks(buckets(keys, shift), RADIX)
    return ranks.to(torch.int32), hists.to(torch.int32)


def tile_for(n_chunks: int, chunk_len: int) -> int:
    """Keys a CTA when the caller names none: 1,024 while the grid stays
    within about one wave of resident CTAs (at most ``WAVE`` tiles), else
    2,048 (half the CTAs, each with twice the work, one wave longer)."""
    return 1024 if n_chunks * -(-chunk_len // 1024) <= WAVE else 2048


def radix_rank_tiles_plain(keys: Tensor, shift: int = 0, tile: int = 1024
                           ) -> Tuple[Tensor, Tensor]:
    """The same function in the kernel's tile order: each chunk cut into
    tiles of ``tile`` keys (the last one ragged); per tile the count of each
    bucket and each key's rank within the tile; a key's rank is the count
    of its bucket in the chunk's earlier tiles (the exclusive prefix over
    the tiles, what the look-back sums) plus its rank within the tile. The
    last tile's inclusive prefix is the histogram."""
    n_chunks, clen = keys.shape
    n_tiles = -(-clen // tile)
    pad = n_tiles * tile - clen
    digits = buckets(keys, shift)
    # padding takes a value outside the radix and comes last in its tile,
    # so it counts in no bucket and moves no key's rank
    digits = torch.cat([digits, digits.new_full((n_chunks, pad), RADIX)],
                       dim=1).reshape(n_chunks, n_tiles, tile)
    within, counts = _stable_ranks(digits, RADIX + 1)
    counts = counts[..., :RADIX]
    inclusive = torch.cumsum(counts, dim=1)
    before = inclusive - counts
    ranks = torch.gather(before, -1, digits.clamp(max=RADIX - 1)) + within
    ranks = ranks.reshape(n_chunks, n_tiles * tile)[:, :clen]
    return ranks.to(torch.int32), inclusive[:, -1].to(torch.int32)


def radix_hist_plain(keys: Tensor, key_bits: int = 32
                     ) -> Tuple[Tensor, Tensor]:
    """Each chunk's histogram of the digit of every pass of a ``key_bits``
    LSD sort and its exclusive prefix: (hists, starts), both (n_chunks,
    n_passes, 256) int32."""
    n_passes = n_passes_of(key_bits)
    digits = torch.stack([buckets(keys, 8 * p) for p in range(n_passes)],
                         dim=1)
    hists = torch.zeros(keys.shape[:1] + (n_passes, RADIX),
                        dtype=torch.int64, device=keys.device)
    hists.scatter_add_(-1, digits, torch.ones_like(digits))
    starts = torch.cumsum(hists, dim=-1) - hists
    return hists.to(torch.int32), starts.to(torch.int32)


def radix_pass_plain(keys: Tensor, vals: Optional[Tensor], starts: Tensor,
                     pass_idx: int) -> Tuple[Tensor, Tensor]:
    """One stable counting-sort pass on digit ``pass_idx`` (shift 8
    pass_idx): each key and value goes to starts[chunk, pass_idx, bucket]
    plus the key's rank, in new tensors. ``vals`` None carries each key's
    index in its chunk (int32)."""
    shift = 8 * pass_idx
    ranks, _ = radix_rank_plain(keys, shift)
    pos = (torch.take_along_dim(starts[:, pass_idx].to(torch.int64),
                                buckets(keys, shift), dim=1)
           + ranks.to(torch.int64))
    if vals is None:
        vals = torch.arange(keys.shape[1], dtype=torch.int32,
                            device=keys.device).expand(keys.shape)
    return (torch.empty_like(keys).scatter_(1, pos, keys),
            torch.empty_like(vals).scatter_(1, pos, vals))


def radix_sort_chunks_plain(keys: Tensor, vals: Optional[Tensor] = None,
                            key_bits: int = 32) -> Tuple[Tensor, Tensor]:
    """The plain sort in the kernels' order: the histograms of every digit,
    then one pass per digit."""
    _, starts = radix_hist_plain(keys, key_bits)
    for p in range(starts.shape[1]):
        keys, vals = radix_pass_plain(keys, vals, starts, p)
    return keys, vals


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

class _Scratch:
    """Per (device, stream): the ticket, the status words with their launch
    epoch, and the histogram accumulators. All start at zero and the
    kernels leave ticket, accumulators and counters at zero; status words
    need no clearing, because each launch takes a new epoch and a word of
    another epoch reads as not yet published. Buffers grow on demand (that
    allocation is the only zero fill); a stream's launches run in order, so
    they share them."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        self.status = torch.zeros(0, dtype=torch.int64, device=dev)
        self.acc = torch.zeros(0, dtype=torch.int32, device=dev)
        self.done = torch.zeros(0, dtype=torch.int32, device=dev)
        self.epoch = 0

    def status_for(self, n_tiles: int, count: int = 1
                   ) -> Tuple[Tensor, int]:
        """Status words for ``n_tiles`` tiles and the first of ``count``
        epochs, one for each launch to come. A CUDA graph would replay the
        same epochs, and a replay would then take the last replay's words
        for published ones: capture raises."""
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("radix kernels: a launch needs an epoch of "
                               "its own and cannot be captured in a CUDA "
                               "graph")
        with _LOCK:                       # two threads, one stream
            if self.status.numel() < n_tiles * RADIX:
                self.status = torch.zeros(n_tiles * RADIX,
                                          dtype=torch.int64, device=self.dev)
            if self.epoch + count >= EPOCHS:  # after 2^30 launches
                self.status.zero_()
                self.epoch = 0
            first = self.epoch + 1
            self.epoch += count
            return self.status, first

    def hist_for(self, n_chunks: int) -> Tuple[Tensor, Tensor]:
        if self.done.numel() < n_chunks:
            self.acc = torch.zeros(n_chunks * MAX_PASSES * RADIX,
                                   dtype=torch.int32, device=self.dev)
            self.done = torch.zeros(n_chunks, dtype=torch.int32,
                                    device=self.dev)
        return self.acc, self.done


_SCRATCH: Dict[Tuple[int, int], _Scratch] = {}
_LOCK = threading.Lock()


def _scratch(dev: torch.device, stream: int) -> _Scratch:
    key = (dev.index, stream)
    with _LOCK:
        if key not in _SCRATCH:
            _SCRATCH[key] = _Scratch(dev)
        return _SCRATCH[key]


def _check_keys(keys: Tensor, tile: Optional[int], what: str) -> int:
    """Raises on keys the kernels do not take; returns the tile."""
    if keys.device.type != "cuda":
        raise ValueError(f"{what}: keys on {keys.device}")
    if keys.dtype != torch.int64:
        raise TypeError(f"{what}: int64 keys required (uint32 values), got "
                        f"{keys.dtype}")
    if keys.dim() != 2 or keys.shape[0] < 1 or keys.shape[1] < 1:
        raise ValueError(f"{what}: keys must be (n_chunks, chunk_len), got "
                         f"{tuple(keys.shape)}")
    n_chunks, clen = keys.shape
    tile = tile_for(n_chunks, clen) if tile is None else tile
    if tile not in TILES:
        raise ValueError(f"{what}: tile {tile} not in {TILES}")
    if clen >= 2**31 or n_chunks * -(-clen // tile) >= 2**31:
        raise ValueError(f"{what}: shape {tuple(keys.shape)} too large")
    if not keys.is_contiguous():
        raise ValueError(f"{what}: keys must be contiguous")
    return tile


def _check_vals(vals: Optional[Tensor], keys: Tensor, what: str) -> None:
    if vals is None:
        return
    if (vals.shape != keys.shape or vals.device != keys.device
            or not vals.is_contiguous()):
        raise ValueError(f"{what}: vals must be contiguous, of the keys' "
                         f"shape and device")
    if vals.element_size() not in (4, 8):
        raise TypeError(f"{what}: vals of 4 or 8 bytes, got {vals.dtype}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def radix_rank(keys: Tensor, shift: int = 0, tile: Optional[int] = None
               ) -> Tuple[Tensor, Tensor]:
    """keys (n_chunks, chunk_len) int64 in [0, 2^32) -> (ranks int32 of the
    same shape, hists (n_chunks, 256) int32). One launch of
    n_chunks * ceil(chunk_len / tile) CTAs."""
    global launches, last_grid
    if keys.device.type == "cpu":
        return radix_rank_plain(keys, shift)
    tile = _check_keys(keys, tile, "radix_rank")
    if not 0 <= shift <= 31:
        raise ValueError(f"radix_rank: shift {shift} outside [0, 31]")
    n_chunks, clen = keys.shape
    dev = keys.device
    index, stream = _build.stream(dev)
    n_tiles = n_chunks * -(-clen // tile)
    scratch = _scratch(dev, stream)
    status, epoch = scratch.status_for(n_tiles)
    ranks = torch.empty((n_chunks, clen), dtype=torch.int32, device=dev)
    hists = torch.empty((n_chunks, RADIX), dtype=torch.int32, device=dev)
    fn = _build.function("radix_rank", "radix_rank_launch", _RANK_ARGS)
    launches += 1
    last_grid = n_tiles
    _raise_on(fn(keys.data_ptr(), ranks.data_ptr(), hists.data_ptr(),
                 status.data_ptr(), scratch.ticket.data_ptr(), n_chunks,
                 clen, shift, tile, epoch, index, stream), "radix_rank")
    return ranks, hists


def radix_hist(keys: Tensor, key_bits: int = 32, tile: Optional[int] = None
               ) -> Tuple[Tensor, Tensor]:
    """(hists, starts), each (n_chunks, n_passes, 256) int32: every pass's
    digit histogram of each chunk and its exclusive prefix, from one read of
    the keys (one launch)."""
    n_passes = n_passes_of(key_bits)
    if keys.device.type == "cpu":
        return radix_hist_plain(keys, key_bits)
    global hist_launches
    tile = _check_keys(keys, tile, "radix_hist")
    n_chunks, clen = keys.shape
    index, stream = _build.stream(keys.device)
    acc, done = _scratch(keys.device, stream).hist_for(n_chunks)
    hists, starts = torch.empty((2, n_chunks, n_passes, RADIX),
                                dtype=torch.int32, device=keys.device)
    fn = _build.function("radix_rank", "radix_hist_launch", _HIST_ARGS)
    hist_launches += 1
    _raise_on(fn(keys.data_ptr(), hists.data_ptr(), starts.data_ptr(),
                 acc.data_ptr(), done.data_ptr(), n_chunks, clen, n_passes,
                 tile, index, stream), "radix_hist")
    return hists, starts


def radix_pass(keys: Tensor, vals: Optional[Tensor], starts: Tensor,
               pass_idx: int, tile: Optional[int] = None
               ) -> Tuple[Tensor, Tensor]:
    """One stable counting-sort pass (see ``radix_pass_plain``) in one
    launch: rank as ``radix_rank`` does, then scatter key and value, into
    new tensors, to bucket start + earlier tiles' count + rank within the
    tile. ``vals`` (4- or 8-byte elements) or None, for each key's index
    as int32."""
    global pass_launches, last_grid
    if keys.device.type == "cpu":
        return radix_pass_plain(keys, vals, starts, pass_idx)
    tile = _check_keys(keys, tile, "radix_pass")
    _check_vals(vals, keys, "radix_pass")
    n_chunks = keys.shape[0]
    if (starts.dtype != torch.int32 or starts.dim() != 3
            or starts.shape[0] != n_chunks or starts.shape[2] != RADIX
            or not 1 <= starts.shape[1] <= MAX_PASSES
            or starts.device != keys.device or not starts.is_contiguous()):
        raise ValueError(f"radix_pass: starts must be int32 (n_chunks, "
                         f"n_passes, 256) contiguous on {keys.device}, got "
                         f"{starts.dtype} {tuple(starts.shape)} on "
                         f"{starts.device}")
    if not 0 <= pass_idx < starts.shape[1]:
        raise ValueError(f"radix_pass: pass {pass_idx} outside "
                         f"[0, {starts.shape[1]})")
    out_k = torch.empty_like(keys)
    out_v = torch.empty(keys.shape, device=keys.device,
                        dtype=torch.int32 if vals is None else vals.dtype)
    n_tiles = n_chunks * -(-keys.shape[1] // tile)
    index, stream = _build.stream(keys.device)
    scratch = _scratch(keys.device, stream)
    status, epoch = scratch.status_for(n_tiles)
    fn = _build.function("radix_rank", "radix_pass_launch", _PASS_ARGS)
    pass_launches += 1
    last_grid = n_tiles
    _raise_on(fn(keys.data_ptr(), None if vals is None else vals.data_ptr(),
                 out_k.data_ptr(), out_v.data_ptr(), starts.data_ptr(),
                 status.data_ptr(), scratch.ticket.data_ptr(), n_chunks,
                 keys.shape[1], pass_idx, starts.shape[1],
                 0 if vals is None else vals.element_size(), tile, epoch,
                 index, stream), "radix_pass")
    return out_k, out_v


def radix_sort_chunks(keys: Tensor, vals: Optional[Tensor] = None,
                      key_bits: int = 32, tile: Optional[int] = None
                      ) -> Tuple[Tensor, Tensor]:
    """Each row of keys sorted stably, with ``vals`` (None: each key's index
    in its chunk, int32) carried along, in 1 + ceil(key_bits / 8) launches
    enqueued by one call: ``radix_hist``'s kernel, then ``radix_pass``'s per
    digit between two pairs of buffers that never alias the caller's
    tensors. The CPU runs the plain versions in the same order
    (``radix_sort_chunks_plain``)."""
    global hist_launches, pass_launches, last_grid
    n_passes = n_passes_of(key_bits)
    dev = keys.device
    if dev.type == "cpu":
        return radix_sort_chunks_plain(keys, vals, key_bits)
    tile = _check_keys(keys, tile, "radix_sort_chunks")
    _check_vals(vals, keys, "radix_sort_chunks")
    n_chunks, clen = keys.shape
    index, stream = _build.stream(dev)
    scratch = _scratch(dev, stream)
    n_tiles = n_chunks * -(-clen // tile)
    status, epoch = scratch.status_for(n_tiles, n_passes)
    acc, done = scratch.hist_for(n_chunks)
    hs = torch.empty((2, n_chunks, n_passes, RADIX), dtype=torch.int32,
                     device=dev)
    n_bufs = min(2, n_passes)
    kbuf = torch.empty((n_bufs,) + keys.shape, dtype=keys.dtype, device=dev)
    vbuf = torch.empty((n_bufs,) + keys.shape, device=dev,
                       dtype=torch.int32 if vals is None else vals.dtype)
    fn = _build.function("radix_rank", "radix_sort_launch", _SORT_ARGS)
    hist_launches += 1
    pass_launches += n_passes
    last_grid = n_tiles
    _raise_on(fn(keys.data_ptr(), None if vals is None else vals.data_ptr(),
                 kbuf.data_ptr(), vbuf.data_ptr(), hs[0].data_ptr(),
                 hs[1].data_ptr(), acc.data_ptr(), done.data_ptr(),
                 status.data_ptr(), scratch.ticket.data_ptr(), n_chunks,
                 clen, n_passes, 0 if vals is None else vals.element_size(),
                 tile, epoch, index, stream), "radix_sort_chunks")
    last = (n_passes - 1) % 2
    return kbuf[last], vbuf[last]
