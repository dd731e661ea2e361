#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels
from ``src/repro_torch/kernels/csrc``, holds each against its plain PyTorch
version on the card, maps reads at the paper's Table IV lengths over a
4,641,652-base reference (the length of E. coli K-12 MG1655) through both
kernels, checks kernels-on against kernels-off, and times each kernel.

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
    return errs


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
    return mapper, launches, max_n


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
    mapper, launches, max_n = map_main_path(reference, reads, dev)

    kernels_on_vs_off(mapper, reads[1:], dev)

    line = kernel_line(dev, launches, errs, max_n)
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
