"""End-to-end read mapper (port of ``repro.apps.read_mapper``, paper §VI-C,
Fig. 8): seed -> chain -> align.

  1. **seed** — window minimizers over the read, hash-index probe against
     the reference, chunk-parallel radix sort by reference position.
  2. **chain** — banded max-plus DP over the sorted anchors (T = 64),
     backtracked on the host to the best chain.
  3. **align** — Smith-Waterman of the read against the reference window
     the chain selected, on the tiled wavefront engine.

Stage inputs are padded to shape buckets (``runtime.bucketing``) and run
through a ``runtime.dispatch.Dispatcher``. The index lives on the mapper's
device; each stage ends by copying its small result to the host, so stage
boundaries are where the host waits for the device.

``mode`` picks the strategy per stage, as in the paper's baseline-vs-Squire
comparison: ``baseline`` sorts in one chunk, scans the chain sequentially
and runs SW row by row; ``squire`` sorts in chunks, chains with the blocked
scan and runs SW as a tiled wavefront. ``use_kernels`` (the counterpart of
the reference's ``use_pallas``, on by default) routes the chain scan and
the SW tiles through the hand-written CUDA kernels; on a CPU device those
wrappers run their plain versions.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import align as align_lib
from repro_torch.core import chain as chain_lib
from repro_torch.core import seeding
from repro_torch.core.chain import ChainParams
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.runtime import bucketing
from repro_torch.runtime.dispatch import Dispatcher


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    k: int = 15                 # minimizer k-mer size
    w: int = 10                 # minimizer window
    max_occ: int = 8            # max hits per minimizer
    band_T: int = 64            # chain band (the paper's T=64)
    min_chain_score: float = 40.0
    sw_window_pad: int = 64     # reference slack around the chain span
    sw_params: align_lib.SWParams = align_lib.SWParams()
    num_workers: int = 8        # sort chunks / chain blocks knob
    mode: str = "squire"        # squire | baseline
    use_kernels: bool = True    # route chain and SW through the CUDA kernels
    read_bucket: int = 256      # reads padded to multiples of this
    anchor_bucket: int = 512    # anchor arrays padded to multiples of this
    sw_tile: int = 64           # wavefront tile (squire mode)


@dataclasses.dataclass
class MapResult:
    pos: int                    # mapped reference position (-1 = unmapped)
    sw_score: float
    chain_score: float
    n_anchors: int
    align_cells: int            # SW matrix cells (the align-stage work)


# --------------------------------------------------------------------------
# stage payload builders (host-side numpy, runtime.bucketing)
# --------------------------------------------------------------------------

def seed_payload(read: np.ndarray, cfg: MapperConfig
                 ) -> Tuple[np.ndarray, int]:
    """Read padded to its read bucket + its true length."""
    nb = bucketing.round_up(len(read), cfg.read_bucket)
    padded = bucketing.pad_to(np.asarray(read, np.int32), nb, 0)
    return padded, len(read)


def chain_payload(q: np.ndarray, r: np.ndarray, cfg: MapperConfig
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Anchors padded to their anchor bucket with sentinel positions."""
    nv = len(q)
    nb = bucketing.round_up(max(nv, 1), cfg.anchor_bucket)
    qp = bucketing.pad_to(np.asarray(q, np.int32), nb, 0)
    rp = bucketing.pad_to(np.asarray(r, np.int32), nb, 2**30)  # far sentinel
    vp = bucketing.pad_to(np.ones(nv, bool), nb, False)
    return qp, rp, vp


def align_payload(read: np.ndarray, window: np.ndarray, cfg: MapperConfig
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Read/window padded to buckets with mutually-mismatching sentinels."""
    na = bucketing.round_up(len(read), cfg.read_bucket)
    nb = bucketing.round_up(len(window), cfg.read_bucket)
    a = bucketing.pad_to(np.asarray(read, np.int32), na, 254)
    b = bucketing.pad_to(np.asarray(window, np.int32), nb, 255)
    return a, b


def chain_window(qv: np.ndarray, rv: np.ndarray, members: List[int],
                 read_len: int, ref_len: int, cfg: MapperConfig
                 ) -> Tuple[int, int]:
    """Best chain's span -> reference window for the align stage."""
    lo_anchor, hi_anchor = members[0], members[-1]
    ref_lo = max(0, int(rv[lo_anchor]) - int(qv[lo_anchor])
                 - cfg.sw_window_pad)
    ref_hi = min(ref_len,
                 int(rv[hi_anchor]) + (read_len - int(qv[hi_anchor]))
                 + cfg.sw_window_pad)
    return ref_lo, ref_hi


# --------------------------------------------------------------------------
# stage functions (one object per configuration, so the dispatcher's
# per-(fn, bucket) stats group by stage)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _seed_fn(k: int, w: int, max_occ: int, n_chunks: int):
    def run(idx_h, idx_p, read, valid_len):
        return seeding.seed(seeding.Index(idx_h, idx_p), read, k, w,
                            max_occ=max_occ, num_sort_chunks=n_chunks,
                            valid_len=valid_len)
    return run


@functools.lru_cache(maxsize=None)
def _chain_fn(T: int, mode: str, block: int):
    def run(q, r, valid):
        return chain_lib.chain_anchors(q, r, T=T, mode=mode, block=block,
                                       anchor_valid=valid)
    return run


@functools.lru_cache(maxsize=None)
def _chain_fn_kernel(T: int):
    from repro_torch.kernels import ops

    def run(q, r, valid):
        return ops.chain_anchors(q, r, T=T, params=ChainParams(),
                                 anchor_valid=valid)
    return run


@functools.lru_cache(maxsize=None)
def _sw_fn(mode: str, tile: int, use_kernels: bool,
           params: align_lib.SWParams):
    """fn(a, b) -> (H matrix, best score)."""
    if use_kernels:
        from repro_torch.kernels import ops
        tile_fn = ops.make_sw_tile_fn(params.match, params.mismatch,
                                      params.gap)
    elif mode == "squire":
        tile_fn = functools.partial(align_lib._sw_tile_fn, params)
    else:
        def run_base(a, b):
            mat = align_lib.sw_ref(a, b, params)
            return mat, torch.amax(mat, dim=(-2, -1))
        return run_base

    def run(a, b):
        return align_lib.sw_tiled(a, b, params, tile_r=tile, tile_c=tile,
                                  tile_fn=tile_fn)
    return run


class ReadMapper:
    """Maps reads against ``reference`` on ``device`` (``None``: the card;
    raises if there is none). ``index`` is the reference index to probe
    (for instance from ``convert.index_from_numpy``); by default it is
    built from ``reference``. ``stage_ms`` holds the host milliseconds of
    the seed, chain and align stages of the last mapped read."""

    def __init__(self, reference: np.ndarray, cfg: MapperConfig,
                 device: DeviceLike = None,
                 runtime: Optional[Dispatcher] = None,
                 index: Optional[seeding.Index] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.reference = np.asarray(reference, np.int8)
        if index is None:
            index = seeding.build_index(self.reference, cfg.k, cfg.w,
                                        device=self.device)
        self.index = index
        self.runtime = runtime or Dispatcher()
        self.stage_ms: Dict[str, float] = {}

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    # -- stages --------------------------------------------------------------

    def _seed(self, read: np.ndarray):
        cfg = self.cfg
        n_chunks = cfg.num_workers if cfg.mode == "squire" else 1
        padded, true_len = seed_payload(read, cfg)
        fn = _seed_fn(cfg.k, cfg.w, cfg.max_occ, n_chunks)
        q, r, valid = self.runtime.run_one(
            fn, (self.index.hashes, self.index.positions,
                 self._tensor(padded), true_len))
        return q.cpu().numpy(), r.cpu().numpy(), valid.cpu().numpy()

    def _chain(self, q: np.ndarray, r: np.ndarray):
        cfg = self.cfg
        nv = len(q)
        qp, rp, vp = chain_payload(q, r, cfg)
        if cfg.use_kernels:
            fn = _chain_fn_kernel(cfg.band_T)
        else:
            mode = "blocked" if cfg.mode == "squire" else "sequential"
            fn = _chain_fn(cfg.band_T, mode, 16)
        f, pred = self.runtime.run_one(
            fn, (self._tensor(qp), self._tensor(rp), self._tensor(vp)))
        return f.cpu().numpy()[:nv], pred.cpu().numpy()[:nv]

    def _align(self, read: np.ndarray, ref_lo: int, ref_hi: int
               ) -> Tuple[float, int, int]:
        cfg = self.cfg
        window = self.reference[ref_lo:ref_hi].astype(np.int32)
        a, b = align_payload(read, window, cfg)
        fn = _sw_fn(cfg.mode, cfg.sw_tile, cfg.use_kernels, cfg.sw_params)
        mat, score = self.runtime.run_one(
            fn, (self._tensor(a), self._tensor(b)))
        end_i, end_j = align_lib.sw_end_position(mat)
        return float(score), int(end_j), len(read) * len(window)

    # -- end to end ------------------------------------------------------------

    def map_read(self, read: np.ndarray) -> MapResult:
        cfg = self.cfg
        read = np.asarray(read)
        self.stage_ms = {}
        if len(read) < cfg.k + cfg.w:
            return MapResult(-1, 0.0, 0.0, 0, 0)

        t0 = time.perf_counter()
        q, r, valid = self._seed(read)
        t1 = time.perf_counter()
        self.stage_ms["seed"] = (t1 - t0) * 1e3
        nv = int(valid.sum())
        if nv < 2:
            return MapResult(-1, 0.0, 0.0, nv, 0)
        qv, rv = q[valid], r[valid]

        f, pred = self._chain(qv, rv)
        chains = chain_lib.backtrack(f, pred,
                                     min_score=cfg.min_chain_score)
        t2 = time.perf_counter()
        self.stage_ms["chain"] = (t2 - t1) * 1e3
        if not chains:
            return MapResult(-1, 0.0, 0.0, nv, 0)
        score, members = chains[0]

        ref_lo, ref_hi = chain_window(qv, rv, members, len(read),
                                      len(self.reference), cfg)
        if ref_hi - ref_lo < cfg.k:
            return MapResult(-1, 0.0, score, nv, 0)

        sw_score, end_j, cells = self._align(read, ref_lo, ref_hi)
        self.stage_ms["align"] = (time.perf_counter() - t2) * 1e3
        return MapResult(pos=ref_lo, sw_score=sw_score, chain_score=score,
                         n_anchors=nv, align_cells=cells)

    def map_reads(self, reads: List[np.ndarray]) -> List[MapResult]:
        return [self.map_read(rd) for rd in reads]


def mapping_accuracy(results: List[MapResult], truths: List[int],
                     tol: int = 200) -> float:
    """Fraction of reads mapped within ``tol`` bases of their true start."""
    ok = sum(1 for res, t in zip(results, truths)
             if res.pos >= 0 and abs(res.pos - t) <= tol)
    return ok / max(len(results), 1)
