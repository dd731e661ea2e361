#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels
from ``src/repro_torch/kernels/csrc``, holds each against its plain PyTorch
version on the card, maps reads at the paper's Table IV lengths over a
4,641,652-base reference (the length of E. coli K-12 MG1655) through the
chain and tile kernels, drives one mixed submit through ``KernelService``
(map, seed, chain, sw, dtw, sort, scan) and holds every result to its
direct call, sorts the sort traffic through the radix-rank kernel
(``ops.radix_sort_chunks``), checks kernels-on against kernels-off, and
times each kernel.

    python3 chip_smoke.py [--seed 0]

Exits non-zero, printing no result, without a CUDA card or without the
repository's ``src/`` beside it. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is a JSON object with
one entry per kernel.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

REF_LEN = 4_641_652          # E. coli K-12 MG1655
LENGTH_SCALE = 10            # genomics.PROFILES hold Table IV lengths / 10
READS_PER_PROFILE = 2        # after one warm-up read
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
FP32_OPS_PER_S = 67e12       # H100 SXM data sheet, fp32 outside tensor cores
NEG = -1e18


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean milliseconds per call of ``reps``
    back-to-back calls, by CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions on the card
# --------------------------------------------------------------------------

def masked_scores(n, t, seed, dev):
    """Random band scores, half masked to NEG, no forward references (as in
    tests/test_kernels_pallas.py), made from a seed on the card."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    scores = torch.randn((n, t), generator=g, device=dev)
    mask = torch.rand((n, t), generator=g, device=dev) < 0.5
    i = torch.arange(n, device=dev)[:, None]
    tt = torch.arange(t, device=dev)[None, :]
    return torch.where(mask | (tt >= i), torch.full_like(scores, NEG),
                       scores)


def check_kernels(dev) -> dict:
    import torch
    from repro_torch.kernels import chain_scan as KC
    from repro_torch.kernels import dtw_wavefront as KT

    errs = {"chain_scan": 0.0, "dp_tile": 0.0}
    for t in (64, 128):
        n = 32_768
        scores = masked_scores(n, t, t, dev)
        w = torch.full((n,), 15.0, device=dev)
        f_ref, off_ref = KC.chain_scan_plain(scores, w)
        f, off = KC.chain_scan(scores, w)
        torch.cuda.synchronize()
        err = float((f - f_ref).abs().max())
        errs["chain_scan"] = max(errs["chain_scan"], err)
        same = torch.equal(f, f_ref) and torch.equal(off, off_ref)
        log(f"[kernels] chain_scan N={n} T={t}: exact={same} "
            f"max_abs_err={err} chain_starts={int((off == 0).sum())}")
        check(same, f"chain_scan N={n} T={t} differs from its plain version")

    g = torch.Generator(device=dev).manual_seed(1)
    for tr, tc in ((64, 64), (128, 128), (32, 16)):
        for lead in ((), (8,)):
            ins = (torch.randint(0, 40, lead + (tc,), generator=g,
                                 device=dev).float(),
                   torch.randint(0, 40, lead + (tr,), generator=g,
                                 device=dev).float(),
                   torch.randint(0, 40, lead, generator=g,
                                 device=dev).float(),
                   torch.randint(0, 4, lead + (tr,), generator=g, device=dev,
                                 dtype=torch.int32),
                   torch.randint(0, 4, lead + (tc,), generator=g, device=dev,
                                 dtype=torch.int32))
            want = KT.dp_tile_plain(*ins, kind="sw")
            got = KT.dp_tile(*ins, kind="sw")
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got, want))
            err = max(float((x - y).abs().max()) for x, y in zip(got, want))
            errs["dp_tile"] = max(errs["dp_tile"], err)
            log(f"[kernels] dp_tile sw {tr}x{tc} batch={lead}: exact={same}")
            check(same, f"dp_tile sw {tr}x{tc} {lead} differs")
    for tr, tc in ((64, 64), (32, 16)):
        for lead in ((), (8,)):
            ins = tuple(torch.randn(s, generator=g, device=dev) for s in
                        (lead + (tc,), lead + (tr,), lead, lead + (tr,),
                         lead + (tc,)))
            want = KT.dp_tile_plain(*ins, kind="dtw")
            got = KT.dp_tile(*ins, kind="dtw")
            torch.cuda.synchronize()
            err = max(float((x - y).abs().max()) for x, y in zip(got, want))
            errs["dp_tile"] = max(errs["dp_tile"], err)
            close = all(torch.allclose(x, y, rtol=1e-5, atol=1e-4)
                        for x, y in zip(got, want))
            log(f"[kernels] dp_tile dtw {tr}x{tc} batch={lead}: "
                f"allclose(rtol=1e-5, atol=1e-4)={close} max_abs_err={err}")
            check(close, f"dp_tile dtw {tr}x{tc} {lead} differs")
    errs["radix_rank"] = check_radix_rank(dev)
    return errs


def check_radix_rank(dev) -> float:
    """radix_rank against its plain version, exact, at every pass's shift,
    for ragged and whole chunk lengths; radix_sort_chunks against
    torch.sort(stable=True) along each chunk."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import radix_rank as KR

    g = torch.Generator(device=dev).manual_seed(2)
    err = 0.0
    for clen in (1, 255, 1024, 16_384):
        keys = torch.randint(0, 2**32, (4, clen), generator=g, device=dev,
                             dtype=torch.int64)
        keys[:, ::3] = keys[:, :1].clone()    # repeated keys
        for shift in (0, 8, 16, 24):
            want_r, want_h = KR.radix_rank_plain(keys, shift)
            ranks, hists = KR.radix_rank(keys, shift)
            torch.cuda.synchronize()
            err = max(err, float((ranks - want_r).abs().max()),
                      float((hists - want_h).abs().max()))
            same = torch.equal(ranks, want_r) and torch.equal(hists, want_h)
            log(f"[kernels] radix_rank (4, {clen}) shift={shift}: "
                f"exact={same}")
            check(same, f"radix_rank (4, {clen}) shift {shift} differs")
        sk, sv = ops.radix_sort_chunks(keys)
        want_k, want_i = torch.sort(keys, dim=1, stable=True)
        same = torch.equal(sk, want_k) and torch.equal(sv.long(), want_i)
        log(f"[kernels] radix_sort_chunks (4, {clen}) == torch.sort(stable)"
            f": {same}")
        check(same, f"radix_sort_chunks (4, {clen}) differs from torch.sort")
    return err


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------

def table_iv_profiles():
    from repro_torch.data import genomics
    return [genomics.ReadProfile(p.name, p.mean_len * LENGTH_SCALE,
                                 p.std_len * LENGTH_SCALE, p.accuracy, p.mix)
            for p in genomics.PROFILES]


def expected_tiles(read_len: int, cells: int, cfg) -> int:
    """Tiles of one alignment, from the bucketed read and window lengths."""
    from repro_torch.runtime import bucketing
    win = cells // read_len
    rows = bucketing.round_up(read_len, cfg.read_bucket)
    cols = bucketing.round_up(win, cfg.read_bucket)
    return -(-rows // cfg.sw_tile) * -(-cols // cfg.sw_tile)


def map_main_path(reference, reads, dev):
    import torch
    from repro_torch.apps.read_mapper import (MapperConfig, ReadMapper,
                                              mapping_accuracy)
    from repro_torch.kernels import chain_scan as KC
    from repro_torch.kernels import dtw_wavefront as KT
    from repro_torch.runtime import bucketing

    cfg = MapperConfig(mode="squire")
    t0 = time.perf_counter()
    mapper = ReadMapper(reference, cfg, device=dev)
    torch.cuda.synchronize()
    log(f"[main] index of {len(reference)} bases on {dev}: "
        f"{mapper.index.hashes.shape[0]} minimizers in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    warm = reads[0][1][0]                 # first read: warm-up, not counted
    mapper.map_read(warm)
    torch.cuda.synchronize()

    KC.launches = KT.launches = 0
    want_chain = want_tiles = 0
    max_n = 0
    results, by_profile = [], {}
    t_all = time.perf_counter()
    for name, read, truth in ((n, r, t) for n, (r, t) in reads[1:]):
        torch.cuda.synchronize()
        res = mapper.map_read(read)
        ms = mapper.stage_ms
        if res.n_anchors >= 2:
            want_chain += 1
            max_n = max(max_n, bucketing.round_up(res.n_anchors,
                                                  cfg.anchor_bucket))
        if res.align_cells:
            want_tiles += expected_tiles(len(read), res.align_cells, cfg)
        results.append((name, res, truth))
        by_profile.setdefault(name, []).append((res, truth))
        log(f"[main] {name:6s} len={len(read):6d} "
            f"n_anchors={res.n_anchors:5d} pos={res.pos:8d} "
            f"truth={truth:8d} sw_score={res.sw_score:8.1f} "
            f"chain_score={res.chain_score:.4f} "
            f"seed_ms={ms.get('seed', 0.0):.3f} "
            f"chain_ms={ms.get('chain', 0.0):.3f} "
            f"align_ms={ms.get('align', 0.0):.3f}")
    wall = time.perf_counter() - t_all
    launches = {"chain_scan": KC.launches, "dp_tile": KT.launches}
    log(f"[main] {len(results)} reads in {wall:.3f} s; launches {launches}; "
        f"expected chain={want_chain} tiles={want_tiles}")
    check(KC.launches == want_chain and want_chain > 0,
          f"chain_scan launched {KC.launches} times, expected {want_chain}")
    check(KT.launches == want_tiles and want_tiles > 0,
          f"dp_tile launched {KT.launches} times, expected {want_tiles}")
    for name, pairs in by_profile.items():
        acc = mapping_accuracy([r for r, _ in pairs], [t for _, t in pairs])
        log(f"[main] accuracy {name}: {acc}")
        if name.startswith("PBHF"):
            check(acc == 1.0, f"{name} reads not within 200 bases of truth: "
                  f"{[(r.pos, t) for r, t in pairs]}")
    return mapper, launches, max_n, results


# --------------------------------------------------------------------------
# phase 3b: the KernelService front door, one mixed submit
# --------------------------------------------------------------------------

SERVICE_SEQ = 64             # sw / dtw bucket quantum and tile
SW_PREFIX = 2000             # sw requests: each read's first 2,000 bases
DTW_LENGTHS = (2048, 4096)   # 4 pairs of each, so two buckets batch 4 each
BULK_N = 65_536              # keys per sort request, steps per scan request
BULK_REQUESTS = 8
SORT_CHUNKS = 4


def service_requests(mapper, reads, seed):
    """The mixed submit, and the anchors the direct seed stage returns."""
    import numpy as np
    rng = np.random.default_rng(seed + 500)
    reqs, anchors = [], []
    for _, (read, _) in reads:
        reqs.append(("map", {"read": read}))
        reqs.append(("seed", {"read": read}))
        q, r, valid = mapper._seed(read)
        anchors.append((q[valid], r[valid]))
    for q, r in anchors:
        reqs.append(("chain", {"q": q, "r": r}))
    ref = mapper.reference
    for _, (read, truth) in reads:
        lo = max(0, truth - 64)
        reqs.append(("sw", {"a": read[:SW_PREFIX].astype(np.int32),
                            "b": ref[lo:truth + SW_PREFIX + 64]
                            .astype(np.int32)}))
    for n in DTW_LENGTHS:
        for _ in range(4):
            walk = np.cumsum(rng.normal(size=(2, n)), axis=1)
            reqs.append(("dtw", {"s": walk[0].astype(np.float32),
                                 "r": walk[1].astype(np.float32)}))
    for _ in range(BULK_REQUESTS):
        reqs.append(("sort", {"keys": rng.integers(0, 2**32, BULK_N,
                                                   dtype=np.uint32)}))
    for _ in range(BULK_REQUESTS):
        reqs.append(("scan1d", {
            "a": rng.uniform(0.5, 1.0, BULK_N).astype(np.float32),
            "b": rng.normal(size=BULK_N).astype(np.float32),
            "x0": np.float32(rng.normal())}))
    return reqs, anchors


class _Counted:
    """Stands in for one service adapter: records, per kernel of the
    submit, the change of each wrapper's launch count and the host ms.
    A nested call (the map kernel's seed stage) counts for its caller."""

    depth = 0

    def __init__(self, adapter, tally):
        self.adapter, self.tally = adapter, tally

    def run(self, payloads):
        from repro_torch.kernels import chain_scan as KC
        from repro_torch.kernels import dtw_wavefront as KT
        from repro_torch.kernels import radix_rank as KR
        if _Counted.depth:
            return self.adapter.run(payloads)
        _Counted.depth += 1
        c0 = (KC.launches, KT.launches, KR.launches)
        t0 = time.perf_counter()
        try:
            return self.adapter.run(payloads)
        finally:
            _Counted.depth -= 1
            c1 = (KC.launches, KT.launches, KR.launches)
            self.tally[self.adapter.name] = {
                "ms": (time.perf_counter() - t0) * 1e3,
                "chain_scan": c1[0] - c0[0], "dp_tile": c1[1] - c0[1],
                "radix_rank": c1[2] - c0[2]}


def tile_positions(n, m):
    return -(-n // SERVICE_SEQ) * -(-m // SERVICE_SEQ)


def service_phase(mapper, reads, main_results, dev, seed):
    """One mixed KernelService.submit on the card at full width, every
    result held to its direct call in the port on the card."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.apps.read_mapper import MapperConfig
    from repro_torch.core import scan1d
    from repro_torch.core import sort as rsort
    from repro_torch.kernels import chain_scan as KC
    from repro_torch.kernels import dtw_wavefront as KT
    from repro_torch.kernels import ops
    from repro_torch.kernels import radix_rank as KR
    from repro_torch.runtime import KernelService, Request, ServiceConfig
    from repro_torch.runtime import bucketing

    cfg = ServiceConfig(seq_bucket=SERVICE_SEQ, sw_tile=SERVICE_SEQ,
                        dtw_tile=SERVICE_SEQ, sort_chunks=SORT_CHUNKS,
                        mapper=MapperConfig(mode="squire"))
    svc = KernelService(cfg, reference=mapper.reference, device=dev)
    t0 = time.perf_counter()
    svc.index
    torch.cuda.synchronize()
    log(f"[service] index built in {(time.perf_counter() - t0) * 1e3:.1f} "
        f"ms")
    reqs, anchors = service_requests(mapper, reads, seed)
    tally = {}
    for name in list(svc._adapters):
        svc._adapters[name] = _Counted(svc._adapters[name], tally)

    torch.cuda.synchronize()
    KC.launches = KT.launches = KR.launches = 0
    t0 = time.perf_counter()
    got = svc.submit([Request(k, p) for k, p in reqs])
    wall = time.perf_counter() - t0
    launches = {"chain_scan": KC.launches, "dp_tile": KT.launches,
                "radix_rank": KR.launches}
    log(f"[service] {len(reqs)} requests in one submit: {wall:.3f} s; "
        f"launches {launches}")

    # expected launches, from the bucket keys alone
    mcfg = cfg.mapper
    by = {}
    for (k, p), res in zip(reqs, got):
        by.setdefault(k, []).append((p, res))
    chain_b = {bucketing.round_up(max(len(p["q"]), 1), cfg.anchor_bucket)
               for p, _ in by["chain"]}
    map_chain_b = {bucketing.round_up(r.n_anchors, mcfg.anchor_bucket)
                   for _, r, _ in main_results if r.n_anchors >= 2}
    sw_b = {(bucketing.round_up(len(p["a"]), SERVICE_SEQ),
             bucketing.round_up(len(p["b"]), SERVICE_SEQ))
            for p, _ in by["sw"]}
    dtw_b = {(bucketing.round_up(len(p["s"]), SERVICE_SEQ),
              bucketing.round_up(len(p["r"]), SERVICE_SEQ))
             for p, _ in by["dtw"]}
    map_b = {(bucketing.round_up(len(read), mcfg.read_bucket),
              bucketing.round_up(r.align_cells // len(read),
                                 mcfg.read_bucket))
             for (_, (read, _)), (_, r, _) in zip(reads, main_results)
             if r.align_cells}
    want_chain = len(chain_b) + len(map_chain_b)
    want_tiles = (sum(tile_positions(*b) for b in sw_b)
                  + sum(tile_positions(*b) for b in dtw_b)
                  + sum(-(-a // mcfg.sw_tile) * -(-b // mcfg.sw_tile)
                        for a, b in map_b))
    log(f"[service] expected chain_scan={want_chain} (chain buckets "
        f"{sorted(chain_b)}, map anchor buckets {sorted(map_chain_b)}), "
        f"dp_tile={want_tiles} (sw buckets {sorted(sw_b)}, dtw buckets "
        f"{sorted(dtw_b)}, {len(map_b)} map align buckets)")
    check(launches["chain_scan"] == want_chain,
          f"service chain_scan launches {launches['chain_scan']} != "
          f"{want_chain} (one per anchor bucket)")
    check(launches["dp_tile"] == want_tiles,
          f"service dp_tile launches {launches['dp_tile']} != {want_tiles} "
          f"(one per tile position per bucket)")
    check(len(dtw_b) == 2 and len(by["dtw"]) == 8,
          "dtw traffic should fill two buckets of 4")

    # every result against its direct call on the card
    for (_, r_direct, _), (_, r_svc) in zip(main_results, by["map"]):
        check(dataclasses.asdict(r_direct) == dataclasses.asdict(r_svc),
              f"service map {r_svc} != ReadMapper.map_read {r_direct}")
    for (q, r), (_, res) in zip(anchors, by["seed"]):
        check(np.array_equal(res["q"], q) and np.array_equal(res["r"], r),
              "service seed anchors differ from the seed stage")
    for p, res in by["chain"]:
        f, pred = ops.chain_anchors(torch.as_tensor(p["q"], device=dev),
                                    torch.as_tensor(p["r"], device=dev),
                                    T=64)
        check(np.array_equal(res["f"], f.cpu().numpy())
              and np.array_equal(res["pred"], pred.cpu().numpy()),
              f"service chain (N={len(p['q'])}) differs from "
              f"ops.chain_anchors")
    for p, res in by["sw"]:
        mat, best = ops.sw_tiled(torch.as_tensor(p["a"], device=dev),
                                 torch.as_tensor(p["b"], device=dev),
                                 tile_r=SERVICE_SEQ, tile_c=SERVICE_SEQ)
        flat = int(torch.argmax(mat.reshape(-1)))
        end = (flat // mat.shape[1], flat % mat.shape[1])
        check(float(res["score"]) == float(best) and res["end"] == end,
              f"service sw {res} != ops.sw_tiled ({float(best)}, {end})")
    dtw_err = 0.0
    for p, res in by["dtw"]:
        _, dist = ops.dtw_tiled(torch.as_tensor(p["s"], device=dev),
                                torch.as_tensor(p["r"], device=dev),
                                SERVICE_SEQ, SERVICE_SEQ)
        d = float(dist)
        dtw_err = max(dtw_err, abs(float(res["distance"]) - d))
        check(abs(float(res["distance"]) - d) <= 1e-5 * abs(d),
              f"service dtw {float(res['distance'])} != ops.dtw_tiled {d}")
    for p, res in by["sort"]:
        sk, sv = rsort.radix_sort(
            torch.as_tensor(p["keys"].astype(np.int64), device=dev),
            num_chunks=SORT_CHUNKS, min_parallel=0)
        check(np.array_equal(res["keys"], sk.cpu().numpy())
              and np.array_equal(res["vals"], sv.cpu().numpy()),
              "service sort differs from core.sort.radix_sort")
    for p, res in by["scan1d"]:
        xs = scan1d.affine_scan(torch.as_tensor(p["a"], device=dev),
                                torch.as_tensor(p["b"], device=dev),
                                torch.as_tensor(p["x0"], device=dev))
        check(np.array_equal(res["xs"], xs.cpu().numpy()),
              "service scan1d differs from core.scan1d.affine_scan")
    log(f"[service] every result equals its direct call on the card "
        f"(map field for field, dtw max abs diff {dtw_err})")

    seed_b = {bucketing.round_up(len(read), mcfg.read_bucket)
              for _, (read, _) in reads}
    buckets = {"map": len(map_b), "chain": len(chain_b), "sw": len(sw_b),
               "dtw": len(dtw_b), "sort": 1, "scan1d": 1,
               "seed": len(seed_b)}
    positions = {"sw": sum(tile_positions(*b) for b in sw_b),
                 "dtw": sum(tile_positions(*b) for b in dtw_b),
                 "map": sum(-(-a // mcfg.sw_tile) * -(-b // mcfg.sw_tile)
                            for a, b in map_b)}
    per_kernel = {}
    for name, t in sorted(tally.items()):
        n_req = len(by[name])
        nb = buckets[name]
        row = {"requests": n_req, "buckets": nb,
               "batch_per_launch": n_req / nb, "host_ms": t["ms"],
               "host_ms_per_request": t["ms"] / n_req,
               "launches": {k: t[k] for k in ("chain_scan", "dp_tile",
                                               "radix_rank") if t[k]}}
        if name in positions:
            row["us_per_tile_position"] = t["ms"] * 1e3 / positions[name]
        per_kernel[name] = row
        log(f"[service] {name:6s} requests={n_req} buckets={nb} "
            f"batch/launch={n_req / nb:.2f} launches={row['launches']} "
            f"host_ms={t['ms']:.3f} ({t['ms'] / n_req:.3f} per request)"
            + (f" us/tile position={row['us_per_tile_position']:.3f}"
               if name in positions else ""))
    check(tally["map"]["chain_scan"] == len(map_chain_b)
          and tally["chain"]["chain_scan"] == len(chain_b),
          "chain_scan launches per kernel differ from the anchor buckets")
    return {"launches": launches, "per_kernel": per_kernel,
            "sort": [(p, res) for p, res in by["sort"]]}


def alg1_sort(keys, n_chunks):
    """Paper Alg. 1 on the rank kernel: the keys as ``n_chunks`` chunks
    through ops.radix_sort_chunks, merged pairwise with
    core.sort.merge_sorted. Returns (sorted keys, original indices)."""
    import torch
    from repro_torch.core import sort as rsort
    from repro_torch.kernels import ops

    lc = keys.shape[0] // n_chunks
    ck, cv = ops.radix_sort_chunks(keys.reshape(n_chunks, lc))
    cv = cv.to(torch.int64) + lc * torch.arange(
        n_chunks, device=keys.device, dtype=torch.int64)[:, None]
    chunks = [(ck[i], cv[i]) for i in range(n_chunks)]
    while len(chunks) > 1:
        chunks = [rsort.merge_sorted(*chunks[i], *chunks[i + 1])
                  for i in range(0, len(chunks), 2)]
    return chunks[0]


def rank_path(sort_traffic, dev):
    """The sort traffic through the radix-rank kernel: each request's keys
    as 4 chunks through ops.radix_sort_chunks, the chunks merged with
    core.sort.merge_sorted, held exactly to the service's sort. Then, for
    timing, 1,048,576 keys in 64 chunks the same way, against
    torch.sort(stable=True)."""
    import numpy as np
    import torch
    from repro_torch.kernels import radix_rank as KR

    keys = [torch.as_tensor(p["keys"].astype(np.int64), device=dev)
            for p, _ in sort_traffic]
    torch.cuda.synchronize()
    KR.launches = 0
    t0 = time.perf_counter()
    merged = [alg1_sort(k, SORT_CHUNKS) for k in keys]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = KR.launches
    for (mk, mv), (_, res) in zip(merged, sort_traffic):
        check(np.array_equal(mk.cpu().numpy(), res["keys"])
              and np.array_equal(mv.cpu().numpy(), res["vals"]),
              "radix_sort_chunks + merge_sorted differs from the service's "
              "sort")
    log(f"[rank] {len(keys)} sort requests of {BULK_N} keys as "
        f"{SORT_CHUNKS} chunks through radix_sort_chunks + merge_sorted: "
        f"equal to the service's sort; {launches} radix_rank launches, "
        f"{ms:.3f} ms host")
    check(launches == len(keys) * 4,
          f"radix_rank launched {launches} times, expected {len(keys) * 4}")

    g = torch.Generator(device=dev).manual_seed(5)
    big = torch.randint(0, 2**32, (64 * BULK_N // SORT_CHUNKS,),
                        generator=g, device=dev, dtype=torch.int64)
    mk, mv = alg1_sort(big, 64)
    want_k, want_i = torch.sort(big, stable=True)
    check(torch.equal(mk, want_k) and torch.equal(mv, want_i),
          "Alg. 1 on 1,048,576 keys differs from torch.sort(stable=True)")
    alg1_ms = time_cuda(lambda: alg1_sort(big, 64), reps=3, rounds=3)
    lib_ms = time_cuda(lambda: torch.sort(big, stable=True), reps=10)
    log(f"[rank] {big.numel()} keys in 64 chunks: radix_sort_chunks + "
        f"merge_sorted {alg1_ms:.3f} ms, equal to torch.sort(stable) "
        f"{lib_ms:.4f} ms")
    return {"launches": launches, "path_ms": ms, "alg1_1m_ms": alg1_ms,
            "torch_sort_1m_ms": lib_ms}


def radix_rank_entry(dev, rank_info, errs):
    """Times of radix_rank at the path's shape (4, 16384) and at 1,048,576
    keys in 64 chunks, beside its bound, its plain version and torch.sort."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import radix_rank as KR

    g = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for n_chunks in (SORT_CHUNKS, 64):
        lc = BULK_N // SORT_CHUNKS
        keys = torch.randint(0, 2**32, (n_chunks, lc), generator=g,
                             device=dev, dtype=torch.int64)
        ms = time_cuda(lambda: KR.radix_rank(keys, 8), reps=50)
        plain = time_cuda(lambda: KR.radix_rank_plain(keys, 8), reps=5)
        lib = time_cuda(lambda: torch.sort(keys, dim=1, stable=True),
                        reps=20)
        chunks_ms = time_cuda(lambda: ops.radix_sort_chunks(keys), reps=20)
        n = keys.numel()
        b_ms, b_by = bound(n * 8 + n * 4 + n_chunks * 256 * 4, 2 * n)
        out[n_chunks] = (ms, plain, lib, chunks_ms, b_ms, b_by)
        log(f"[time] radix_rank ({n_chunks}, {lc}): kernel {ms:.4f} ms, "
            f"plain {plain:.3f} ms, bound {b_ms:.6f} ms ({b_by}); "
            f"radix_sort_chunks {chunks_ms:.4f} ms, torch.sort(stable) "
            f"{lib:.4f} ms")
    ms, plain, lib, chunks_ms, b_ms, b_by = out[SORT_CHUNKS]
    big = out[64]
    return {"name": "radix_rank", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/radix_rank.cu",
            "replaces": "src/repro/kernels/radix_rank.py:57",
            "launches": rank_info["launches"],
            "max_abs_err": errs["radix_rank"], "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "library": "torch.sort(keys, dim=1, stable=True)",
            "shape": [SORT_CHUNKS, BULK_N // SORT_CHUNKS],
            "radix_sort_chunks_ms": chunks_ms,
            "alg1_1m_ms": rank_info["alg1_1m_ms"],
            "torch_sort_1m_ms": rank_info["torch_sort_1m_ms"],
            "at_64_chunks": {"ms": big[0], "plain_ms": big[1],
                             "library_ms": big[2],
                             "radix_sort_chunks_ms": big[3],
                             "bound_ms": big[4]}}


# --------------------------------------------------------------------------
# phase 4: kernels on against kernels off
# --------------------------------------------------------------------------

def kernels_on_vs_off(mapper, reads, dev):
    """The first 2,000 bases of one read per profile, mapped with the
    kernels and without them on the card. Against the baseline schedule
    (sequential chain, row-by-row SW) every field is equal; against the
    squire schedule without kernels (blocked chain, whose fp32 sums
    associate differently) every field is equal but chain_score, which
    agrees to rtol 1e-5."""
    import dataclasses
    from repro_torch.apps.read_mapper import MapperConfig, ReadMapper

    off = {mode: ReadMapper(mapper.reference,
                            MapperConfig(mode=mode, use_kernels=False),
                            device=dev, index=mapper.index)
           for mode in ("baseline", "squire")}
    seen = set()
    for name, (read, truth) in reads:
        if name in seen:
            continue
        seen.add(name)
        part = read[:2000]
        on = mapper.map_read(part)
        for mode, m in off.items():
            t0 = time.perf_counter()
            res = m.map_read(part)
            dt = time.perf_counter() - t0
            a, b = dataclasses.asdict(on), dataclasses.asdict(res)
            if mode == "baseline":
                same = a == b
            else:
                cs = a.pop("chain_score"), b.pop("chain_score")
                same = a == b and abs(cs[0] - cs[1]) <= 1e-5 * abs(cs[1])
            log(f"[on/off] {name:6s} {mode:8s} on={on} off={res} "
                f"equal={same} off_s={dt:.2f}")
            check(same, f"{name} kernels on/off differ ({mode})")


# --------------------------------------------------------------------------
# phase 5: timings and the kernels line
# --------------------------------------------------------------------------

def kernel_line(dev, launches, errs, max_n):
    import torch
    from repro_torch.kernels import chain_scan as KC
    from repro_torch.kernels import dtw_wavefront as KT

    t = 64
    scores = masked_scores(max_n, t, 7, dev)
    w = torch.full((max_n,), 15.0, device=dev)
    chain_ms = time_cuda(lambda: KC.chain_scan(scores, w), reps=20)
    chain_plain = time_cuda(lambda: KC.chain_scan_plain(scores, w), reps=1,
                            rounds=3)
    c_bytes = max_n * t * 4 + max_n * 4 + max_n * 4 + max_n * 4
    c_bound, c_by = bound(c_bytes, 2 * max_n * t)
    log(f"[time] chain_scan N={max_n} T={t}: kernel {chain_ms:.4f} ms, "
        f"plain {chain_plain:.3f} ms, bound {c_bound:.6f} ms ({c_by}); "
        f"{chain_ms / max_n * 1e6:.1f} ns per serial row")

    tr = tc = 64
    g = torch.Generator(device=dev).manual_seed(3)
    ins = (torch.zeros(tc, device=dev), torch.zeros(tr, device=dev),
           torch.zeros((), device=dev),
           torch.randint(0, 4, (tr,), generator=g, device=dev,
                         dtype=torch.int32),
           torch.randint(0, 4, (tc,), generator=g, device=dev,
                         dtype=torch.int32))
    tile_ms = time_cuda(lambda: KT.dp_tile(*ins, kind="sw"), reps=500)
    tile_plain = time_cuda(lambda: KT.dp_tile_plain(*ins, kind="sw"),
                           reps=2, rounds=3)
    batch = 132 * 8
    bins = tuple(x.expand((batch,) + x.shape).contiguous() for x in ins)
    batched_ms = time_cuda(lambda: KT.dp_tile(*bins, kind="sw"), reps=20)
    t_bytes = 4 * (tc + tr + 1) + 4 * (tr + tc) + 4 * (tr * tc + tc + tr + 1)
    t_bound, t_by = bound(t_bytes, 7 * tr * tc)
    log(f"[time] dp_tile sw {tr}x{tc}: per launch {tile_ms:.4f} ms, plain "
        f"{tile_plain:.3f} ms, bound {t_bound:.7f} ms ({t_by}); "
        f"{batch} tiles in one launch {batched_ms:.4f} ms = "
        f"{batched_ms / batch * 1e3:.3f} us per tile")

    return {"kernels": [
        {"name": "chain_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/chain_scan.cu",
         "replaces": "src/repro/kernels/chain_scan.py:61",
         "launches": launches["chain_scan"],
         "max_abs_err": errs["chain_scan"], "ms": chain_ms,
         "plain_ms": chain_plain, "bound_ms": c_bound, "bound_by": c_by,
         "library_ms": None, "shape": [max_n, t]},
        {"name": "dp_tile", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dtw_wavefront.cu",
         "replaces": "src/repro/kernels/dtw_wavefront.py:102",
         "launches": launches["dp_tile"],
         "max_abs_err": errs["dp_tile"], "ms": tile_ms,
         "plain_ms": tile_plain, "bound_ms": t_bound, "bound_by": t_by,
         "library_ms": None, "shape": [tr, tc],
         "batched_us_per_tile": batched_ms / batch * 1e3},
    ]}


def device_trace(mapper, read):
    """One read through the kernels under torch.profiler (CUDA activity
    only): the card's busy share of the wall time, and the mean device
    time of one dp_tile launch. Returns None values when the trace holds
    no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mapper.map_read(read)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        log("[trace] no device events in the profiler trace: not measured")
        return {"busy_share": None, "tile_device_us": None}
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e, _ in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    tiles = [e - s for s, e, name in spans if "dp_tile_kernel" in name]
    out = {"busy_share": busy / wall_us,
           "tile_device_us": statistics.mean(tiles) if tiles else None}
    log(f"[trace] {len(read)}-base read: wall {wall_us / 1e3:.3f} ms under "
        f"the profiler, device busy {busy / 1e3:.3f} ms "
        f"(share {out['busy_share']:.4f}), {len(spans)} device events, "
        f"{len(tiles)} dp_tile launches of {out['tile_device_us']} us mean")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.data import genomics
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in _build.PTXAS_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    errs = check_kernels(dev)

    reference = genomics.make_reference(REF_LEN, seed=args.seed)
    reads = []
    profiles = table_iv_profiles()
    warm = genomics.sample_reads(reference, profiles[1], 1,
                                 seed=args.seed + 100)[0]
    reads.append((profiles[1].name, warm))
    for i, prof in enumerate(profiles):
        for pair in genomics.sample_reads(reference, prof, READS_PER_PROFILE,
                                          seed=args.seed + 1 + i):
            reads.append((prof.name, pair))
    mapper, launches, max_n, results = map_main_path(reference, reads, dev)

    svc_info = service_phase(mapper, reads[1:], results, dev, args.seed)
    rank_info = rank_path(svc_info.pop("sort"), dev)

    kernels_on_vs_off(mapper, reads[1:], dev)

    line = kernel_line(dev, launches, errs, max_n)
    line["kernels"].append(radix_rank_entry(dev, rank_info, errs))
    line["kernels"][0]["service_launches"] = svc_info["launches"]["chain_scan"]
    line["kernels"][1]["service_launches"] = svc_info["launches"]["dp_tile"]
    line["service"] = svc_info["per_kernel"]
    trace = device_trace(mapper, reads[1][1][0][:2000])
    line["kernels"][1]["tile_device_us"] = trace["tile_device_us"]
    line["align_busy_share"] = trace["busy_share"]
    log(smi)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
