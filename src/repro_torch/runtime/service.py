"""KernelService — one entry point for bulk dependency-bound kernel work
(port of ``repro.runtime.service``).

The paper's pitch is that very different dependency-bound kernels (chain,
Smith-Waterman, DTW, sort/seeding, 1-D scans) accelerate behind *one*
dispatch interface. This registry is that interface at traffic scale:
heterogeneous requests go in, the service groups them by kernel, buckets
them by shape (``runtime.bucketing``), runs each bucket as one batch
(``runtime.dispatch``) with host padding overlapped with device work
(``runtime.pipeline``), and scatters per-request results back in order.

    svc = KernelService(ServiceConfig(), reference=ref)   # ref: seed/map
    results = svc.submit([
        Request("chain", {"q": q, "r": r}),
        Request("dtw",   {"s": s, "r": r2}),
        Request("map",   {"read": read}),
        ...
    ])

Payloads are host (numpy) arrays and so are the results. The service runs
on ``device`` (``None``: the card; it raises without one). With
``ServiceConfig.use_kernels`` on (the default, the counterpart of the
reference's ``use_pallas``), the chain stage of ``chain`` (fission and
sequential modes) and ``map`` launches the ``chain_scan`` kernel once per
anchor bucket on the stacked scores, and ``sw``, ``dtw`` and ``map``'s
align stage run the whole batched wavefront as one ``dp_wavefront`` launch
per bucket. On the CPU those wrappers run their plain versions; with
``use_kernels`` off, the wavefront walks the plain tiles.

Every result equals the corresponding direct call into
``repro_torch.core`` / ``repro_torch.kernels.ops`` / ``ReadMapper``:
batching runs the same per-request arithmetic over a leading axis, and
sentinel padding is appended *after* the true data, which none of these
left-to-right recurrences can see.

LM traffic comes through the same door: ``generate`` and ``score``
requests go to the ``serve.Scheduler`` passed as ``KernelService(lm=...)``,
which batches them in time on its slot pool.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.apps import read_mapper as rm
from repro_torch.core import align as align_lib
from repro_torch.core import chain as chain_lib
from repro_torch.core import dtw as dtw_lib
from repro_torch.core import seeding
from repro_torch.core import sort as rsort
from repro_torch.core import wavefront
from repro_torch.core.scan1d import affine_scan
from repro_torch.core.semiring import SEMIRINGS, finite_zero
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import sampler as obs_sampler
from repro_torch.runtime import bucketing
from repro_torch.runtime.autotune import Autotuner
from repro_torch.runtime.dispatch import Dispatcher
from repro_torch.runtime.pipeline import run_pipelined

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Static knobs, as in the reference, plus ``use_kernels``."""
    # bucketing
    seq_bucket: int = 64        # sw/dtw sequence quantum (tile-aligned)
    anchor_bucket: int = 256    # chain anchor quantum
    sort_bucket: int = 256
    scan_bucket: int = 64
    bucket_mode: str = "linear"     # 'linear' | 'pow2'
    # chain
    chain_T: int = 64
    chain_mode: str = "fission"     # fission | sequential | blocked
    chain_block: int = 16
    # align / dtw
    sw_params: align_lib.SWParams = align_lib.SWParams()
    sw_tile: int = 32
    dtw_tile: int = 32
    # sort / seed / scan
    sort_chunks: int = 4
    scan_semiring: str = "real"
    scan_mode: str = "sequential"
    # end-to-end mapper
    mapper: rm.MapperConfig = rm.MapperConfig()
    # pipeline
    pipeline_depth: int = 2
    # route chain and the wavefront tiles through the CUDA kernels
    use_kernels: bool = True

    def tuned(self, tuner: Optional[Autotuner] = None) -> "ServiceConfig":
        """Override tile/chunk knobs from the autotune cache."""
        tuner = tuner or Autotuner()
        over = {}
        dtw_tile = tuner.get("dtw.tile")
        if dtw_tile:
            over["dtw_tile"] = int(dtw_tile)
            over["sw_tile"] = int(dtw_tile)     # same engine, same knee
        chunk = tuner.get("ssm.chunk")
        if chunk:
            over["scan_bucket"] = int(chunk)
        return dataclasses.replace(self, **over) if over else self


@dataclasses.dataclass(frozen=True)
class Request:
    kernel: str
    payload: Dict[str, Any]


def _spec(size: int, mode: str) -> bucketing.BucketSpec:
    return bucketing.BucketSpec(size=size, mode=mode)


def _payload_key(payload: Dict) -> Tuple:
    """Content key for a kernel payload (bulk-submit dedup). dtype and shape
    ride along with the bytes: equal bytes alone collide across dtypes and
    shapes."""
    parts: List[Tuple] = []
    for k in sorted(payload):
        v = payload[k]
        if isinstance(v, (np.ndarray, list, tuple)):
            a = np.ascontiguousarray(v)
            parts.append((k, a.tobytes(), a.dtype.str, a.shape))
        else:
            parts.append((k, v))
    return tuple(parts)


def _map_arrays(fn, res: Any) -> Any:
    """``fn`` applied to every array leaf of a nest of tuples, lists and
    dicts."""
    if isinstance(res, dict):
        return {k: _map_arrays(fn, v) for k, v in res.items()}
    if isinstance(res, (list, tuple)):
        return type(res)(_map_arrays(fn, v) for v in res)
    if isinstance(res, (np.ndarray, torch.Tensor)):
        return fn(res)
    return res


def _copy_result(res: Any) -> Any:
    """Fresh arrays for a deduped duplicate: handing every requester the
    SAME array would let one caller's in-place edit corrupt another's
    result."""
    return _map_arrays(lambda x: x.copy(), res)


def _to_host(res: Any) -> Any:
    return _map_arrays(
        lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else x, res)


# --------------------------------------------------------------------------
# batched building blocks (functions written for a leading batch axis)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _scan_fn(srname: str, mode: str):
    sr = SEMIRINGS[srname]

    def run(a, b, x0):
        # affine_scan runs time on axis 0 with the batch as the state
        return affine_scan(a.T, b.T, x0, sr, mode=mode).T
    return run


@functools.lru_cache(maxsize=None)
def _sort_fn(num_chunks: int):
    def run(keys, vals):
        return rsort.radix_sort(keys, vals, num_chunks=num_chunks,
                                min_parallel=0)
    return run


def _sw_wavefront_fn(params: align_lib.SWParams, use_kernels: bool):
    """Batched SW wavefront with ``run_wavefront``'s signature: one
    ``dp_wavefront`` launch, or the loop over the plain diagonal tile (both
    carry leading batch axes)."""
    if use_kernels:
        return ops.make_sw_wavefront_fn(params.match, params.mismatch,
                                        params.gap)
    return functools.partial(wavefront.run_wavefront_batched,
                             functools.partial(align_lib._sw_tile_fn,
                                               params))


def _sw_batched(a: Tensor, b: Tensor, run, tile: int) -> Tensor:
    """(B, na) x (B, nb) int32 -> H matrices (B, na, nb) over the batched
    wavefront ``run``; each row equals ``align.sw_tiled`` on that row."""
    bsz, na = a.shape
    nb = b.shape[1]
    ap = wavefront.pad_to_multiple(a, tile, 1, 255)
    bp = wavefront.pad_to_multiple(b, tile, 1, 255)
    dev = a.device
    mat, _, _, _ = run(
        ap, bp, torch.zeros((bsz, bp.shape[1]), dtype=torch.float32,
                            device=dev),
        torch.zeros((bsz, ap.shape[1]), dtype=torch.float32, device=dev),
        torch.zeros((bsz,), dtype=torch.float32, device=dev), tile, tile)
    return mat[:, :na, :nb]


def _dtw_batched(s: Tensor, r: Tensor, tile: int, use_kernels: bool
                 ) -> Tensor:
    """(B, n) x (B, m) fp32 -> DTW matrices (B, n, m); each row equals
    ``dtw.dtw_tiled`` on that row."""
    bsz, n = s.shape
    m = r.shape[1]
    dev = s.device
    sp = wavefront.pad_to_multiple(s, tile, 1, 1e18)
    rp = wavefront.pad_to_multiple(r, tile, 1, 1e18)
    run = (ops.dtw_wavefront_fn if use_kernels else functools.partial(
        wavefront.run_wavefront_batched, dtw_lib._dtw_tile_fn))
    mat, _, _, _ = run(
        sp, rp, torch.full((bsz, rp.shape[1]), dtw_lib.BIG,
                           dtype=torch.float32, device=dev),
        torch.full((bsz, sp.shape[1]), dtw_lib.BIG, dtype=torch.float32,
                   device=dev),
        torch.zeros((bsz,), dtype=torch.float32, device=dev), tile, tile)
    return mat[:, :n, :m]


def _first_argmax_2d(mats: Tensor, rows: Tensor, cols: Tensor
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """Per batch row: (max, i, j) of the first maximum in row-major order
    over mats[b, :rows[b], :cols[b]]. Cells outside are masked to -inf,
    which keeps the row-major order of the cells inside."""
    _, n, m = mats.shape
    dev = mats.device
    inside = ((torch.arange(n, device=dev)[None, :, None] < rows[:, None,
                                                                None])
              & (torch.arange(m, device=dev)[None, None, :]
                 < cols[:, None, None]))
    flat = torch.where(inside, mats, -torch.inf).reshape(mats.shape[0], -1)
    arg = torch.argmax(flat, dim=1)       # the first maximum, as np.argmax
    best = torch.gather(flat, 1, arg[:, None])[:, 0]
    return best, arg // m, arg % m


# --------------------------------------------------------------------------
# kernel adapters
# --------------------------------------------------------------------------

class KernelAdapter:
    """Bucket -> batch -> dispatch -> unpack for one kernel family.

    Subclasses implement ``bucket_key`` / ``prepare`` (host padding, numpy)
    / ``launch`` (device work) / ``collect`` (host results); the generic
    ``run`` pipelines the buckets, padding the next bucket on the host
    while the current one computes."""

    name: str = ""

    def __init__(self, svc: "KernelService"):
        self.svc = svc
        self.cfg = svc.cfg

    # hooks -------------------------------------------------------------
    def bucket_key(self, payload: Dict) -> Tuple:
        raise NotImplementedError

    def prepare(self, key: Tuple, payloads: List[Dict]):
        raise NotImplementedError

    def launch(self, key: Tuple, leaves):
        raise NotImplementedError

    def collect(self, key: Tuple, out, payloads: List[Dict]) -> List[Any]:
        raise NotImplementedError

    # generic pipeline ---------------------------------------------------
    def run(self, payloads: List[Dict]) -> List[Any]:
        """Dedup identical payloads (by content), run the unique set
        through the bucketed pipeline and fan the results back out.
        Duplicates receive fresh array copies, so no two requesters alias
        one buffer."""
        keys = []
        for p in payloads:
            try:
                keys.append(_payload_key(p))
            except TypeError:       # unhashable extra: never deduped
                keys.append(object())
        first: Dict[Any, int] = {}
        uniq: List[int] = []
        for i, k in enumerate(keys):
            if k not in first:
                first[k] = len(uniq)
                uniq.append(i)
        if len(uniq) == len(payloads):
            return self._run_unique(payloads)
        self.svc.deduped_requests += len(payloads) - len(uniq)
        got = self._run_unique([payloads[i] for i in uniq])
        return [got[first[k]] if i == uniq[first[k]]
                else _copy_result(got[first[k]])
                for i, k in enumerate(keys)]

    def _run_unique(self, payloads: List[Dict]) -> List[Any]:
        groups = bucketing.group_by_key(
            [self.bucket_key(p) for p in payloads])
        results: List[Any] = [None] * len(payloads)

        def work():
            for key, rows in groups.items():
                yield key, rows, self.prepare(
                    key, [payloads[r] for r in rows])

        def launch(item):
            key, rows, leaves = item
            return key, rows, self.launch(key, self.svc.tensors(leaves))

        for key, rows, out in run_pipelined(
                work(), launch, depth=self.cfg.pipeline_depth):
            got = self.collect(key, _to_host(out),
                               [payloads[r] for r in rows])
            for r, res in zip(rows, got):
                results[r] = res
        return results


class ChainAdapter(KernelAdapter):
    """payload {q, r} -> {"f", "pred"} (minimap2 chain DP)."""

    name = "chain"

    def bucket_key(self, p):
        return (_spec(self.cfg.anchor_bucket, self.cfg.bucket_mode)
                .padded(max(len(p["q"]), 1)),)

    def prepare(self, key, payloads):
        nb = key[0]
        qp = bucketing.pad_stack([np.asarray(p["q"], np.int32)
                                  for p in payloads], nb, 0)
        rp = bucketing.pad_stack([np.asarray(p["r"], np.int32)
                                  for p in payloads], nb, 2**30)
        vp = bucketing.valid_mask(
            bucketing.lengths_of([p["q"] for p in payloads]), nb)
        return qp, rp, vp

    def launch(self, key, leaves):
        cfg = self.cfg
        if cfg.use_kernels and cfg.chain_mode in ("fission", "sequential"):
            fn = rm._chain_fn_kernel(cfg.chain_T)
        else:
            block = cfg.chain_block
            if cfg.chain_mode == "blocked":
                # per-bucket tuned block; only the blocked schedule has one
                block = int(self.svc.tuner.get_bucketed(
                    "chain.block", key[0], block))
            fn = rm._chain_fn(cfg.chain_T, cfg.chain_mode, block)
        return self.svc.dispatcher.run(fn, leaves)

    def collect(self, key, out, payloads):
        f, pred = out
        return [{"f": f[i, :len(p["q"])], "pred": pred[i, :len(p["q"])]}
                for i, p in enumerate(payloads)]


class SWAdapter(KernelAdapter):
    """payload {a, b} -> {"score", "end"} (Smith-Waterman)."""

    name = "sw"

    def _padded(self, n):
        spec = _spec(self.cfg.seq_bucket, self.cfg.bucket_mode)
        return bucketing.round_up(spec.padded(n), self.cfg.sw_tile)

    def bucket_key(self, p):
        return (self._padded(len(p["a"])), self._padded(len(p["b"])))

    def prepare(self, key, payloads):
        na, nb = key
        a = bucketing.pad_stack([np.asarray(p["a"], np.int32)
                                 for p in payloads], na, 254)
        b = bucketing.pad_stack([np.asarray(p["b"], np.int32)
                                 for p in payloads], nb, 255)
        return (a, b, bucketing.lengths_of([p["a"] for p in payloads]),
                bucketing.lengths_of([p["b"] for p in payloads]))

    def launch(self, key, leaves):
        a, b, la, lb = leaves
        cfg = self.cfg
        mats = _sw_batched(a, b, _sw_wavefront_fn(cfg.sw_params,
                                                  cfg.use_kernels),
                           cfg.sw_tile)
        return _first_argmax_2d(mats, la, lb)

    def collect(self, key, out, payloads):
        best, ei, ej = out
        return [{"score": best[i], "end": (int(ei[i]), int(ej[i]))}
                for i in range(len(payloads))]


class DTWAdapter(KernelAdapter):
    """payload {s, r} -> {"distance"} (dynamic time warping)."""

    name = "dtw"

    def _padded(self, n):
        spec = _spec(self.cfg.seq_bucket, self.cfg.bucket_mode)
        return bucketing.round_up(spec.padded(n), self.cfg.dtw_tile)

    def bucket_key(self, p):
        return (self._padded(len(p["s"])), self._padded(len(p["r"])))

    def prepare(self, key, payloads):
        n, m = key
        s = bucketing.pad_stack([np.asarray(p["s"], np.float32)
                                 for p in payloads], n, 1e18)
        r = bucketing.pad_stack([np.asarray(p["r"], np.float32)
                                 for p in payloads], m, 1e18)
        return (s, r, bucketing.lengths_of([p["s"] for p in payloads]),
                bucketing.lengths_of([p["r"] for p in payloads]))

    def launch(self, key, leaves):
        s, r, ls, lr = leaves
        mats = _dtw_batched(s, r, self.cfg.dtw_tile, self.cfg.use_kernels)
        return mats[torch.arange(s.shape[0], device=s.device), ls - 1,
                    lr - 1]

    def collect(self, key, dist, payloads):
        return [{"distance": dist[i]} for i in range(len(payloads))]


class SortAdapter(KernelAdapter):
    """payload {keys[, vals]} -> {"keys", "vals"} (chunked radix sort)."""

    name = "sort"

    def bucket_key(self, p):
        return (_spec(self.cfg.sort_bucket, self.cfg.bucket_mode)
                .padded(max(len(p["keys"]), 1)),)

    def prepare(self, key, payloads):
        nb = key[0]
        # uint32 keys ride as int64 (torch's uint32 lacks >> on the CPU)
        keys = bucketing.pad_stack(
            [np.asarray(p["keys"], np.uint32).astype(np.int64)
             for p in payloads], nb, np.int64(0xFFFFFFFF))
        vals = bucketing.pad_stack(
            [np.asarray(p["vals"], np.int32) if "vals" in p
             else np.arange(len(p["keys"]), dtype=np.int32)
             for p in payloads], nb, 0)
        return keys, vals

    def launch(self, key, leaves):
        chunks = self.svc.tuner.get_bucketed("sort.chunks", key[0],
                                             self.cfg.sort_chunks)
        return self.svc.dispatcher.run(_sort_fn(int(chunks)), leaves)

    def collect(self, key, out, payloads):
        keys, vals = out
        return [{"keys": keys[i, :len(p["keys"])].astype(np.uint32),
                 "vals": vals[i, :len(p["keys"])]}
                for i, p in enumerate(payloads)]


class SeedAdapter(KernelAdapter):
    """payload {read} -> {"q", "r"} anchors (minimizer seeding). The
    reference index is service state (``KernelService(reference=...)``),
    shared by every read of the batch."""

    name = "seed"

    def bucket_key(self, p):
        cfg = self.cfg.mapper
        return (bucketing.round_up(len(p["read"]), cfg.read_bucket),)

    def prepare(self, key, payloads):
        nb = key[0]
        reads = bucketing.pad_stack(
            [np.asarray(p["read"], np.int32) for p in payloads], nb, 0)
        lens = bucketing.lengths_of([p["read"] for p in payloads])
        return reads, lens

    def launch(self, key, leaves):
        cfg = self.cfg.mapper
        n_chunks = cfg.num_workers if cfg.mode == "squire" else 1
        fn = rm._seed_fn(cfg.k, cfg.w, cfg.max_occ, n_chunks)
        index = self.svc.index
        return self.svc.dispatcher.run(
            fn, (index.hashes, index.positions) + tuple(leaves),
            in_axes=(None, None, 0, 0))

    def collect(self, key, out, payloads):
        q, r, valid = out
        return [{"q": q[i][valid[i]], "r": r[i][valid[i]]}
                for i in range(len(payloads))]


class ScanAdapter(KernelAdapter):
    """payload {a, b, x0} -> {"xs"} (1-D affine recurrence; semiring and
    mode from ServiceConfig)."""

    name = "scan1d"

    def bucket_key(self, p):
        return (_spec(self.cfg.scan_bucket, self.cfg.bucket_mode)
                .padded(max(len(p["a"]), 1)),)

    def prepare(self, key, payloads):
        nb = key[0]
        sr = SEMIRINGS[self.cfg.scan_semiring]
        dtype = np.float32
        one = np.asarray(sr.one, dtype)
        zero = np.asarray(finite_zero(sr, torch.float32).item(), dtype)
        a = bucketing.pad_stack([np.asarray(p["a"], dtype)
                                 for p in payloads], nb, one)
        b = bucketing.pad_stack([np.asarray(p["b"], dtype)
                                 for p in payloads], nb, zero)
        x0 = np.asarray([np.asarray(p["x0"], dtype) for p in payloads])
        return a, b, x0

    def launch(self, key, leaves):
        fn = _scan_fn(self.cfg.scan_semiring, self.cfg.scan_mode)
        return self.svc.dispatcher.run(fn, leaves)

    def collect(self, key, out, payloads):
        return [{"xs": out[i, :len(p["a"])]}
                for i, p in enumerate(payloads)]


class MapperAdapter(KernelAdapter):
    """payload {read} -> MapResult: the end-to-end mapper with each stage
    batched across the requests in flight (the paper's Fig. 8 pipeline at
    traffic scale). Stage functions and padding are ReadMapper's, so the
    results equal per-read mapping."""

    name = "map"

    def run(self, payloads: List[Dict]) -> List[Any]:
        cfg = self.cfg.mapper
        svc = self.svc
        reads = [np.asarray(p["read"]) for p in payloads]
        results: List[Optional[rm.MapResult]] = [None] * len(reads)

        live = []
        for i, rd in enumerate(reads):
            if len(rd) < cfg.k + cfg.w:
                results[i] = rm.MapResult(-1, 0.0, 0.0, 0, 0)
            else:
                live.append(i)

        # -- seed: the same adapter the standalone "seed" kernel uses ----
        anchors: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        seeded = svc._adapters["seed"].run(
            [{"read": reads[i]} for i in live])
        for i, got in zip(live, seeded):
            nv = len(got["q"])
            if nv < 2:
                results[i] = rm.MapResult(-1, 0.0, 0.0, nv, 0)
            else:
                anchors[i] = (got["q"], got["r"])

        # -- chain (bucketed by padded anchor count) ---------------------
        windows: Dict[int, Tuple[float, int, int]] = {}
        if cfg.use_kernels:
            chain_fn = rm._chain_fn_kernel(cfg.band_T)
        else:
            mode = "blocked" if cfg.mode == "squire" else "sequential"
            chain_fn = rm._chain_fn(cfg.band_T, mode, 16)
        order = sorted(anchors)
        groups = bucketing.group_by_key(
            [(bucketing.round_up(max(len(anchors[i][0]), 1),
                                 cfg.anchor_bucket),)
             for i in order])
        for (nb,), rows in groups.items():
            idxs = [order[r] for r in rows]
            parts = [rm.chain_payload(anchors[i][0], anchors[i][1], cfg)
                     for i in idxs]
            leaves = svc.tensors(tuple(np.stack([x[k] for x in parts])
                                       for k in range(3)))
            f, pred = _to_host(svc.dispatcher.run(chain_fn, leaves))
            for row, i in enumerate(idxs):
                qv, rv = anchors[i]
                nv = len(qv)
                chains = chain_lib.backtrack(f[row][:nv], pred[row][:nv],
                                             min_score=cfg.min_chain_score)
                if not chains:
                    results[i] = rm.MapResult(-1, 0.0, 0.0, nv, 0)
                    continue
                score, members = chains[0]
                lo, hi = rm.chain_window(qv, rv, members, len(reads[i]),
                                         len(svc.reference), cfg)
                if hi - lo < cfg.k:
                    results[i] = rm.MapResult(-1, 0.0, score, nv, 0)
                else:
                    windows[i] = (score, lo, hi)

        # -- align (bucketed by padded (read, window) shape) -------------
        pend = sorted(windows)
        pairs = {}
        for i in pend:
            _, lo, hi = windows[i]
            window = svc.reference[lo:hi].astype(np.int32)
            pairs[i] = rm.align_payload(reads[i], window, cfg)
        groups = bucketing.group_by_key(
            [(pairs[i][0].shape[0], pairs[i][1].shape[0]) for i in pend])
        for (na, nb), rows in groups.items():
            idxs = [pend[r] for r in rows]
            a, b = svc.tensors((np.stack([pairs[i][0] for i in idxs]),
                                np.stack([pairs[i][1] for i in idxs])))
            scores = self._align_batched(a, b).cpu().numpy()
            for row, i in enumerate(idxs):
                chain_score, lo, hi = windows[i]
                results[i] = rm.MapResult(
                    pos=lo, sw_score=float(scores[row]),
                    chain_score=chain_score,
                    n_anchors=len(anchors[i][0]),
                    align_cells=len(reads[i]) * (hi - lo))
        return results

    def _align_batched(self, a: Tensor, b: Tensor) -> Tensor:
        """Best SW score per row, routed as ReadMapper routes its align
        stage: the kernel tiles, the plain tiles (squire) or the row-wise
        oracle (baseline)."""
        cfg = self.cfg.mapper
        if cfg.use_kernels or cfg.mode == "squire":
            mats = _sw_batched(a, b, _sw_wavefront_fn(cfg.sw_params,
                                                      cfg.use_kernels),
                               cfg.sw_tile)
            return torch.amax(mats, dim=(-2, -1))
        fn = rm._sw_fn("baseline", cfg.sw_tile, False, cfg.sw_params)
        _, scores = self.svc.dispatcher.run(fn, (a, b))
        return scores


class GenerateAdapter(KernelAdapter):
    """payload {prompt[, max_new_tokens, temperature, top_k, top_p]} ->
    {"tokens", "reason"}: LM decode traffic through the same front door as
    the dependency-bound kernels.

    Decode is the request-scale 1-D recurrence, so batching happens in time
    (continuous batching), not in the request list: the adapter forwards
    the whole bulk to the attached ``serve.Scheduler``, whose slot pool
    interleaves prefill/decode/retire per step. Attach with
    ``KernelService(lm=Scheduler(...))``; the scheduler runs on the device
    of its weights."""

    name = "generate"

    def run(self, payloads: List[Dict]) -> List[Any]:
        sched = self.svc.lm
        if sched is None:
            raise ValueError(
                "generate kernel needs KernelService(lm=serve.Scheduler)")
        rids = []
        for p in payloads:
            rids.extend(sched.submit(
                [np.asarray(p["prompt"], np.int32)],
                max_new_tokens=p.get("max_new_tokens"),
                temperature=p.get("temperature"),
                top_k=p.get("top_k"), top_p=p.get("top_p")))
        sched.drain()
        # pop: a long-lived service must not accumulate Completions
        done = [sched.results.pop(r) for r in rids]
        return [{"tokens": c.tokens, "reason": c.reason} for c in done]


class ScoreAdapter(KernelAdapter):
    """payload {prompt} -> {"logprobs", "reason"}: per-token prompt logprobs
    (``logprobs[i-1] = log p(prompt[i] | prompt[:i])``) through the
    scheduler's chunk and decode steps: the same slot pool, cache and
    admission as 'generate', no sampled tokens. Attach with
    ``KernelService(lm=Scheduler(...))``."""

    name = "score"

    def run(self, payloads: List[Dict]) -> List[Any]:
        sched = self.svc.lm
        if sched is None:
            raise ValueError(
                "score kernel needs KernelService(lm=serve.Scheduler)")
        rids = []
        for p in payloads:
            rids.extend(sched.score([np.asarray(p["prompt"], np.int32)]))
        sched.drain()
        done = [sched.results.pop(r) for r in rids]
        return [{"logprobs": c.logprobs, "reason": c.reason} for c in done]


_ADAPTERS = (ChainAdapter, SWAdapter, DTWAdapter, SortAdapter, SeedAdapter,
             ScanAdapter, MapperAdapter, GenerateAdapter, ScoreAdapter)


class KernelService:
    """The software Squire accelerator pool: submit heterogeneous kernel
    requests in bulk, get per-request results back in order."""

    def __init__(self, cfg: ServiceConfig = ServiceConfig(),
                 reference: Optional[np.ndarray] = None,
                 dispatcher: Optional[Dispatcher] = None,
                 lm: Optional[Any] = None,
                 tuner: Optional[Autotuner] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dispatcher = dispatcher or Dispatcher()
        self.reference = (None if reference is None
                          else np.asarray(reference, np.int8))
        self.lm = lm    # serve.Scheduler for the 'generate'/'score' kernels
        self.tuner = tuner or Autotuner()
        self._index = None
        self._adapters: Dict[str, KernelAdapter] = {
            a.name: a(self) for a in _ADAPTERS}
        # per-kernel traffic: requests routed / bulk submits seen /
        # duplicate payloads served from a sibling's dispatch
        self.request_counts = collections.Counter(
            dict.fromkeys(self.kernels, 0))
        self.submit_count = 0
        self.deduped_requests = 0
        obs_metrics.REGISTRY.register_provider("runtime.service", self)

    def tensors(self, leaves) -> Tuple[Tensor, ...]:
        """Host arrays -> tensors on the service's device."""
        return tuple(torch.as_tensor(np.asarray(x)).to(self.device)
                     for x in leaves)

    @property
    def index(self) -> seeding.Index:
        """Lazily-built reference minimizer index (seed/map kernels)."""
        if self._index is None:
            if self.reference is None:
                raise ValueError(
                    "seed/map kernels need KernelService(reference=...)")
            m = self.cfg.mapper
            self._index = seeding.build_index(self.reference, m.k, m.w,
                                              device=self.device)
        return self._index

    @property
    def kernels(self) -> Tuple[str, ...]:
        return tuple(sorted(self._adapters))

    def metrics(self) -> Dict[str, Any]:
        """Registry 'runtime.service' provider: per-kernel request traffic
        (``requests.<kernel>``) and the bulk submit count."""
        out: Dict[str, Any] = {"submits": self.submit_count,
                               "deduped_requests": self.deduped_requests}
        out.update({f"requests.{k}": int(v)
                    for k, v in sorted(self.request_counts.items())})
        return out

    def stats(self) -> Dict[str, Any]:
        """Registered kernels plus the traffic counters of ``metrics`` and,
        when an LM scheduler is attached, its pool counters (``lm``)."""
        out: Dict[str, Any] = {"kernels": list(self.kernels),
                               **self.metrics()}
        if self.lm is not None:
            out["lm"] = self.lm.stats()
        return out

    def submit(self, requests: Sequence[Request]) -> List[Any]:
        """Run a heterogeneous batch; results align with ``requests``."""
        results: List[Any] = [None] * len(requests)
        by_kernel: Dict[str, List[int]] = {}
        for i, req in enumerate(requests):
            if req.kernel not in self._adapters:
                raise KeyError(f"unknown kernel {req.kernel!r}; "
                               f"have {self.kernels}")
            by_kernel.setdefault(req.kernel, []).append(i)
        self.submit_count += 1
        for kernel, idxs in by_kernel.items():
            self.request_counts[kernel] += len(idxs)
            got = self._adapters[kernel].run(
                [requests[i].payload for i in idxs])
            for i, res in zip(idxs, got):
                results[i] = res
        obs_sampler.tick("service.submit")
        return results
