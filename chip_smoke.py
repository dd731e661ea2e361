#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the CUDA kernels
from ``src/repro_torch/kernels/csrc``, holds each against its plain PyTorch
version on the card, maps reads at the paper's Table IV lengths over a
4,641,652-base reference (the length of E. coli K-12 MG1655) through the
chain kernel and the one-launch SW wavefront (``dp_wavefront``), drives one
mixed submit through ``KernelService``
(map, seed, chain, sw, dtw, sort, scan) and holds every result to its
direct call (and one chain bucket again through ``Dispatcher(mesh=...)``),
sorts the sort traffic through the radix kernels
(``ops.radix_sort_chunks``: one histogram launch, then one rank-and-scatter
launch per 8-bit digit), checks kernels-on against kernels-off, and times
each kernel. Then the paper's last two kernels in plain torch: SpMV
(``core.spmv``, two matrices of over 10^6 nonzeros) and Needleman-Wunsch
(``core.align.nw_tiled`` at 2,048 x 2,048), each against an oracle. Then
the LM paths at full width: RWKV-6 1.6B (``rwkv6-1.6b``) and gemma-2b
(``gemma-2b``). For each, an fp32 prefill with the kernel (the WKV scan,
flash attention) held against the plain version, one prompt fed through
``generate``'s chunk path and through one prefill with the last logits
gated, the continuous-batching ``serve.Scheduler`` (8 requests on 4 slots,
every greedy stream against per-request ``generate``, ``score()``, and
``KernelService(lm=...)``'s generate/score requests), and bf16 serving
through ``launch.serve`` (batch 4, 2,048-token prompts, 16 greedy tokens),
``engine.generate`` (chunked prefill of two ragged prompts) and the
scheduler (continuous and static admission). Then the paged KV pool
(``SchedulerConfig(allocator="paged")``): for gemma-2b five fp32 arms
against the contiguous run (equal memory; a tight pool under recompute,
swap and reserved admission; prefix sharing) and bf16 occupancy against
the contiguous pool at equal memory; for RWKV-6 a paged run with no
page-table group; and gemma3-12b at full width, cut to 6 layers, whose
sliding-window rings page through a ring group. Then the sharded paged
pool (``mesh_shards``): gemma-2b's fp32 trace at 1 shard (bitwise the
unsharded pool, also on ``make_worker_mesh(1)``), 2 and 4 shards, a
skewed arm (steals) and a swap arm (a swap entry migrated); bf16 at 2
shards with speculation and in one pair against the unsharded pool;
RWKV-6 at 2 shards. Then speculative decoding
(``speculate=3``, bf16) against plain decode on the scheduler trace, for
gemma-2b on contiguous slots and on the paged pool and for gemma3-12b on
the paged pool with its ring group (and its ``score()`` with and without
speculation), and the closed observability loop: a forced overload on the
tight paged pool under a queue-wait SLO and a ``BackpressureController``
against the uncontrolled run, and one ``AutotuneController`` re-sweep of
``dtw.tile`` over ``KernelService`` DTW submits. Then the MoE, hybrid and
embeds LMs: ``olmoe-1b-7b`` at full width and depth and ``jamba-v0.1-52b``
at full width cut to one period (8 of 32 layers), each with an fp32
prefill with and without ``flash_attention`` (logits and every top-k
routing set held), ``generate``'s chunk path against one prefill and the
scheduler on contiguous slots and on the paged pool against per-request
``generate`` (drop-free, routing pinned for the gates, free runs counted),
bf16 serving and a profiled prefill split by part (experts, dispatch,
Mamba scan, ``flash_attention``); and ``musicgen-large`` served through
``launch.serve`` on prompt embeddings. Then training: the backward
kernels of ``flash_attention`` and ``ssm_scan`` against their plain
backwards (fp32 and bf16, each twice, bitwise), an fp32 train step with the
kernels on against off, ``gemma-2b`` (batch 2 x 2,048) and ``rwkv6-1.6b``
(4 x 2,048) trained in bf16 through ``launch.train`` at full width and
depth with every kernel launch counted, and an exact resume after an
injected failure on a 2-layer cut of ``rwkv6-1.6b``. Last, the launch tools
(``repro_torch.launch``): the dry-run grid of four archs over the four
shapes, walked on the meta device in worker processes that start with the
smoke, and ``launch.perf`` on gemma-2b's bf16 prefill and rwkv6-1.6b's bf16
train step at 4 x 2,048, with the walk's FLOPs held to ``FlopCounterMode``,
its kernel charges to the launches, its meta temp bytes to the card's peak
and ``kernels.work`` to each kernel row's bound.

    python3 chip_smoke.py [--seed 0]

Exits non-zero, printing no result, without a CUDA card or without the
repository's ``src/`` beside it. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is a JSON object with
one entry per kernel, the SpMV and NW numbers (``paper_kernels``), the
LM paths' serving numbers (``lm``, ``attn_lm``, ``ring_lm``,
``spec_ring_lm``, ``moe_lm``, ``hybrid_lm``, ``embeds_lm``), the
autotune re-sweep (``obs_autotune``), training (``train_lm``) and the
launch tools (``launch_tools``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
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
BF16_OPS_PER_S = 989e12      # H100 SXM data sheet, dense bf16 tensor cores
NEG = -1e18


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def log(*parts):
    print(*parts, flush=True)


@contextlib.contextmanager
def timed(what: str):
    """Log ``[time] <what> took <s> s`` when the block ends."""
    t0 = time.perf_counter()
    yield
    log(f"[time] {what} took {time.perf_counter() - t0:.1f} s")


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


# the tensor-core attention kernels of each library, by a substring of
# their names: the forward's and the bf16 backward's
TC_KERNELS = {"flash_attention": ("flash_attention_tc_kernel",),
              "flash_attention_bwd": ("dkdv_tc_kernel", "dq_tc_kernel")}


def sass_hgmma(build) -> dict:
    """The tensor-core attention kernels in the built libraries' SASS
    (cuobjdump, beside nvcc): per library, per instantiation, its HGMMA
    instructions and the first of them."""
    tool = Path(build._nvcc()).parent / "cuobjdump"
    out = {}
    for lib, names in TC_KERNELS.items():
        res = subprocess.run([str(tool), "-sass", str(build.lib_path(lib))],
                             capture_output=True, text=True, timeout=300,
                             check=True)
        fns, cur = {}, None
        for line in res.stdout.splitlines():
            if "Function :" in line:
                name = line.split("Function :", 1)[1].strip()
                cur = name if any(n in name for n in names) else None
                if cur:
                    fns[cur] = {"hgmma": 0, "first": None}
            elif cur and "HGMMA" in line:
                fns[cur]["hgmma"] += 1
                fns[cur]["first"] = fns[cur]["first"] or " ".join(
                    line.split())
        out[lib] = fns
    return out


def bound(n_bytes: float, n_ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
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
    errs["chain_scan"] = max(errs["chain_scan"], check_chain_edges(dev))
    errs["dp_wavefront"] = check_dp_wavefront(dev)
    errs.update(check_radix_rank(dev))
    errs["ssm_scan"] = max(check_ssm_scan(dev), check_ssm_edges(dev))
    errs["flash_attention"], errs["flash_shapes"] = check_flash_attention(dev)
    return errs


def tie_scores(lead, n, t, g, dev):
    """Integer-valued band scores (candidates tie), half masked to NEG, the
    band reaching before row 0 unmasked (the NEG-seeded candidates tie
    there); w of 15, 1 or 2 with a tenth NEG (invalid anchors)."""
    import torch
    scores = torch.randint(-3, 4, lead + (n, t), generator=g,
                           device=dev).float()
    scores[torch.rand(lead + (n, t), generator=g, device=dev) < 0.5] = NEG
    choice = torch.tensor([15.0, 1.0, 2.0], device=dev)
    w = choice[torch.randint(0, 3, lead + (n,), generator=g, device=dev)]
    w[torch.rand(lead + (n,), generator=g, device=dev) < 0.1] = NEG
    return scores, w


def check_chain_edges(dev) -> float:
    """The forwarding kernel bit for bit at its edges: T in {1, 33, 128}
    (one slot, a second slot of one row, four slots) times N in {1, 31, 32,
    33, 4096} (one row, part of a round, a round, a round and one, many),
    ties and NEG weights, the second problem's w all NEG (the NEG-seeded
    candidates then decide off); the mapper's T = 64 at N = 4096; and a
    (13, 777, 64) stack, as the service's anchor buckets launch it."""
    import torch
    from repro_torch.kernels import chain_scan as KC

    g = torch.Generator(device=dev).manual_seed(11)
    cases = [((2,), n, t) for t in (1, 33, 128)
             for n in (1, 31, 32, 33, 4096)] + [((2,), 4096, 64),
                                                ((13,), 777, 64)]
    err, starts, ns_row = 0.0, 0, {}
    for lead, n, t in cases:
        scores, w = tie_scores(lead, n, t, g, dev)
        if lead == (2,):
            w[1] = NEG
        f_ref, off_ref = KC.chain_scan_plain(scores, w)
        f, off = KC.chain_scan(scores, w)
        torch.cuda.synchronize()
        same = torch.equal(f, f_ref) and torch.equal(off, off_ref)
        err = max(err, float((f - f_ref).abs().max()))
        starts += int((off == 0).sum())
        check(same, f"chain_scan {lead + (n, t)} (ties, NEG w) differs from "
              f"its plain version")
        if n == 4096:       # two problems of 4,096 rows, one warp each
            ms = time_cuda(lambda: KC.chain_scan(scores, w), reps=10,
                           rounds=3)
            ns_row[t] = round(ms / n * 1e6, 1)
    log(f"[kernels] chain_scan at {len(cases)} edge shapes (T 1/33/128 x N "
        f"1/31/32/33/4096 and 64 x 4096, P=2 with one all-NEG w; 13 x 777 x "
        f"64): exact, "
        f"{starts} chain starts; ns per serial row at N=4096 by T: {ns_row}")
    return err


def check_ssm_edges(dev) -> float:
    """ssm_scan at B = 1 from a random state, y and the final state at
    rtol = atol = 1e-4: dv in {1, 24, 64, 128} (one column to eight column
    blocks), dk in {1, 8, 64}, T in {1, 33, 2048} (one step to many
    chunks); dk = 1 and dv = 1 take the 4-byte staging path."""
    import torch
    from repro_torch.kernels import ssm_scan as KS

    g = torch.Generator(device=dev).manual_seed(12)
    err, n = 0.0, 0
    for dv in (1, 24, 64, 128):
        for dk in (1, 8, 64):
            for t in (1, 33, 2048):
                ins = wkv_inputs(1, t, dk, dv, g, dev, True)
                want_y, want_s = KS.ssm_scan_plain(*ins)
                y, s_fin = KS.ssm_scan(*ins)
                torch.cuda.synchronize()
                e = max(float((y - want_y).abs().max()),
                        float((s_fin - want_s).abs().max()))
                err = max(err, e)
                close = (torch.allclose(y, want_y, rtol=1e-4, atol=1e-4)
                         and torch.allclose(s_fin, want_s, rtol=1e-4,
                                            atol=1e-4))
                check(close, f"ssm_scan (1, {t}, {dk}, {dv}) differs from "
                      f"its plain version (max abs err {e})")
                n += 1
    log(f"[kernels] ssm_scan at {n} edge shapes (B=1, dv 1/24/64/128 x dk "
        f"1/8/64 x T 1/33/2048, random s0): allclose(rtol=1e-4, atol=1e-4), "
        f"max_abs_err={err}")
    return err


def ptxas_summary(text: str) -> dict:
    """Registers, spill bytes and shared memory of every entry function in
    one source's ptxas report."""
    import re
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
        elif cur and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[cur]["spill_bytes"] = nums[1] + nums[2]
        elif cur and "registers" in line:
            out[cur]["registers"] = int(re.search(r"Used (\d+) registers",
                                                  line).group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[cur]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


# (kind, lead, n, m, tile) of the dp_wavefront checks against the plain
# tile loop: 64 and 128 tiles at batch 1 and 5, tile 8 across 10,000
# columns, and 5 x 128 strips of 128 columns, more than the CTAs the card
# holds at once at that tile (checked below), so CTAs walk several strips
WAVEFRONT_SHAPES = tuple(
    (kind,) + shape for kind in ("sw", "dtw") for shape in (
        ((), 192, 256, 64), ((5,), 192, 256, 64),
        ((), 256, 384, 128), ((5,), 256, 384, 128),
        ((), 16, 10_000, 8), ((5,), 128, 16_384, 128)))
MANY_STRIPS = 5 * 16_384 // 128
WIDE = (128, 131_072, 64)    # more 64-column strips than resident CTAs


def wavefront_inputs(kind, lead, n, m, g, dev):
    """a, b, top0, left0, corner0 on the card: sw characters 0..3 with
    integer boundaries, dtw random walks with normal boundaries."""
    import torch
    if kind == "sw":
        ab = [torch.randint(0, 4, lead + (x,), generator=g, device=dev,
                            dtype=torch.int32) for x in (n, m)]
        bnd = [torch.randint(0, 30, lead + x, generator=g, device=dev)
               .float() for x in ((m,), (n,), ())]
    else:
        ab = [torch.randn(lead + (x,), generator=g, device=dev).cumsum(-1)
              for x in (n, m)]
        bnd = [torch.randn(lead + x, generator=g, device=dev)
               for x in ((m,), (n,), ())]
    return (*ab, *bnd)


def check_dp_wavefront(dev) -> float:
    """dp_wavefront against its plain version (run_wavefront over
    dp_tile_plain), bit for bit, at every WAVEFRONT_SHAPES entry; at WIDE
    (2,048 strips) against the row-scan oracle core.align.sw_ref, exact in
    fp32 for integer scores (the plain tile loop would take minutes there);
    ops.dtw_tiled with its 1e18 padding against core.dtw.dtw_tiled."""
    import torch
    from repro_torch.core import align as TA
    from repro_torch.core import dtw as TD
    from repro_torch.kernels import dtw_wavefront as KT
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(12)
    err = 0.0
    for kind, lead, n, m, tile in WAVEFRONT_SHAPES:
        ins = wavefront_inputs(kind, lead, n, m, g, dev)
        want = KT.dp_wavefront_plain(*ins, kind=kind, tile_r=tile,
                                     tile_c=tile)
        got = KT.dp_wavefront(*ins, kind=kind, tile_r=tile, tile_c=tile)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, want))
        err = max([err] + [float((x - y).abs().max())
                           for x, y in zip(got, want)])
        strips = (lead[0] if lead else 1) * (m // tile)
        log(f"[kernels] dp_wavefront {kind} batch={lead} {n}x{m} tile "
            f"{tile}: {strips} strips on {KT.last_grid} CTAs, exact={same}")
        check(same, f"dp_wavefront {kind} {lead} {n}x{m} tile {tile} "
              "differs from its plain version")
        check(strips != MANY_STRIPS or KT.last_grid < strips,
              f"dp_wavefront {kind}: {strips} strips did not outnumber its "
              f"{KT.last_grid} CTAs")
    n, m, tile = WIDE
    a, b, *_ = wavefront_inputs("sw", (), n, m, g, dev)
    b[1000:1000 + n] = a                         # one planted local match
    z = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731
    mat, bottom, right, corner = KT.dp_wavefront(
        a, b, z(m), z(n), z(), kind="sw", tile_r=tile, tile_c=tile)
    want = TA.sw_ref(a, b)
    torch.cuda.synchronize()
    same = (torch.equal(mat, want) and torch.equal(bottom, want[-1])
            and torch.equal(right, want[:, -1])
            and float(corner) == float(want[-1, -1]))
    err = max(err, float((mat - want).abs().max()))
    log(f"[kernels] dp_wavefront sw {n}x{m} tile {tile}: {m // tile} strips "
        f"on {KT.last_grid} resident CTAs, equal to sw_ref: {same}, best "
        f"{float(mat.max())}")
    check(same and KT.last_grid < m // tile and float(mat.max()) == 2 * n,
          f"dp_wavefront sw {n}x{m} differs from sw_ref, or its {m // tile} "
          f"strips did not outnumber its {KT.last_grid} CTAs")
    for tile in (64, 32):
        s_, r_ = (torch.randn(x, generator=g, device=dev).cumsum(0)
                  for x in (100, 130))
        want, want_d = TD.dtw_tiled(s_, r_, tile, tile)
        got, d = ops.dtw_tiled(s_, r_, tile, tile)
        torch.cuda.synchronize()
        same = torch.equal(got, want) and float(d) == float(want_d)
        log(f"[kernels] ops.dtw_tiled 100x130 (1e18 padding) tile {tile}: "
            f"exact={same}")
        check(same, f"ops.dtw_tiled tile {tile} differs from dtw_tiled")
    return err


# chunk lengths about both tile sizes (1,024 and 2,048 keys a CTA)
RADIX_CHUNK_LENS = (1, 255, 1023, 1024, 1025, 2047, 2048, 2049, 16_384,
                    65_536)


def radix_draw(n_chunks, clen, draw, g, dev):
    """uint32 keys as int64 on the card: "repeated" (every third key equal
    to its chunk's first, so ties and stability count) or "one_bucket"
    (every key of a chunk equal: each digit falls in one bucket, and each
    warp of a tile is one __match_any_sync group)."""
    import torch
    keys = torch.randint(0, 2**32, (n_chunks, clen), generator=g,
                         device=dev, dtype=torch.int64)
    if draw == "repeated":
        keys[:, ::3] = keys[:, :1].clone()
    else:
        keys[:] = keys[:, :1].clone()
    return keys


def int_err(got, want) -> float:
    """Largest absolute difference over pairs of tensors of one shape and
    type (0.0 when every pair is equal bit for bit)."""
    import torch
    return max(0.0 if torch.equal(x, y)
               else float((x.double() - y.double()).abs().max())
               for x, y in zip(got, want))


def check_radix_rank(dev) -> dict:
    """The radix kernels against their plain versions, exact, at both tile
    sizes, at RADIX_CHUNK_LENS, 1, 4 and 64 chunks and both draws:
    radix_rank at every pass's shift; radix_hist; radix_pass for every
    digit with no values (each key's index), int64 and float32 values; and
    radix_sort_chunks against torch.sort(stable=True) along each chunk."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import radix_rank as KR

    g = torch.Generator(device=dev).manual_seed(2)
    errs = dict.fromkeys(("radix_rank", "radix_hist", "radix_pass"), 0.0)
    cases = 0
    for clen in RADIX_CHUNK_LENS:
        sorted_ok = True
        for n_chunks in (1, 4, 64):
            for draw in ("repeated", "one_bucket"):
                keys = radix_draw(n_chunks, clen, draw, g, dev)
                ranks = [KR.radix_rank_plain(keys, s) for s in (0, 8, 16, 24)]
                hist = KR.radix_hist_plain(keys)
                passes = [(p, v, KR.radix_pass_plain(keys, v, hist[1], p))
                          for p in range(4)
                          for v in (None,
                                    torch.randint(-2**40, 2**40, keys.shape,
                                                  generator=g, device=dev),
                                    torch.randn(keys.shape, generator=g,
                                                device=dev))]
                for tile in KR.TILES:
                    for shift, want in zip((0, 8, 16, 24), ranks):
                        errs["radix_rank"] = max(errs["radix_rank"], int_err(
                            KR.radix_rank(keys, shift, tile=tile), want))
                    errs["radix_hist"] = max(errs["radix_hist"], int_err(
                        KR.radix_hist(keys, tile=tile), hist))
                    for p, v, want in passes:
                        errs["radix_pass"] = max(errs["radix_pass"], int_err(
                            KR.radix_pass(keys, v, hist[1], p, tile=tile),
                            want))
                    cases += 1
                sk, sv = ops.radix_sort_chunks(keys)
                want_k, want_i = torch.sort(keys, dim=1, stable=True)
                sorted_ok &= (torch.equal(sk, want_k)
                              and torch.equal(sv.long(), want_i))
        torch.cuda.synchronize()
        log(f"[kernels] radix chunk_len {clen} (1/4/64 chunks, 2 draws, "
            f"tiles {KR.TILES}): max abs err rank {errs['radix_rank']}, "
            f"hist {errs['radix_hist']}, pass {errs['radix_pass']}; "
            f"radix_sort_chunks == torch.sort(stable): {sorted_ok}")
        check(sorted_ok, f"radix_sort_chunks chunk_len {clen} differs from "
              f"torch.sort(stable=True)")
    log(f"[kernels] radix: {cases} (shape, draw, tile) cases, each with 4 "
        f"shifts of radix_rank, radix_hist and 12 radix_pass calls")
    for name, err in errs.items():
        check(err == 0.0, f"{name} differs from its plain version (max abs "
              f"err {err})")
    return errs


SCAN_SHAPES = ((128, 2048, 64, 64),   # the prefill: batch 4 x 32 heads
               (1, 1000, 16, 16),     # ragged T at the reduced width
               (3, 96, 8, 24))


def wkv_inputs(b, t, dk, dv, g, dev, with_state):
    """r, w, k, v, u and s0 (or None) for the WKV scan, made on the card:
    w = sigmoid(N(0, 1) + 2) as in tests/test_kernels_pallas.py."""
    import torch
    r = torch.randn((b, t, dk), generator=g, device=dev)
    w = torch.sigmoid(torch.randn((b, t, dk), generator=g, device=dev) + 2)
    k = torch.randn((b, t, dk), generator=g, device=dev)
    v = torch.randn((b, t, dv), generator=g, device=dev)
    u = 0.5 * torch.randn((dk,), generator=g, device=dev)
    s0 = (torch.randn((b, dk, dv), generator=g, device=dev) if with_state
          else None)
    return r, w, k, v, u, s0


def check_ssm_scan(dev) -> float:
    """ssm_scan against its plain version at rtol = atol = 1e-4, y and the
    final state, from a zero and from a random state; ops.ssm_scan (T
    padded to the chunk) the same way."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as KS

    g = torch.Generator(device=dev).manual_seed(6)
    err = 0.0
    for shape in SCAN_SHAPES:
        for with_state in (False, True):
            ins = wkv_inputs(*shape, g, dev, with_state)
            want_y, want_s = KS.ssm_scan_plain(*ins)
            y, s_fin = KS.ssm_scan(*ins)
            torch.cuda.synchronize()
            e = max(float((y - want_y).abs().max()),
                    float((s_fin - want_s).abs().max()))
            err = max(err, e)
            close = (torch.allclose(y, want_y, rtol=1e-4, atol=1e-4)
                     and torch.allclose(s_fin, want_s, rtol=1e-4, atol=1e-4))
            log(f"[kernels] ssm_scan {shape} s0={'random' if with_state else 0}"
                f": allclose(rtol=1e-4, atol=1e-4)={close} max_abs_err={e} "
                f"max|y|={float(want_y.abs().max()):.3f}")
            check(close, f"ssm_scan {shape} (s0 {with_state}) differs from "
                  f"its plain version")
    r, w, k, v, u, _ = wkv_inputs(2, 1000, 16, 16, g, dev, False)
    want, _ = KS.ssm_scan_plain(r, w, k, v, u)
    got = ops.ssm_scan(r, w, k, v, u, chunk=64)
    torch.cuda.synchronize()
    e = float((got - want).abs().max())
    err = max(err, e)
    close = torch.allclose(got, want, rtol=1e-4, atol=1e-4)
    log(f"[kernels] ops.ssm_scan (2, 1000, 16, 16) padded to chunk 64: "
        f"allclose={close} max_abs_err={e}")
    check(close, "ops.ssm_scan with T padding differs from the plain scan")
    return err


# (B, H, KV, Sq, Skv, hd, window) of the flash_attention checks
FLASH_SHAPES = ((2, 4, 4, 128, 128, 64, 0),       # the reference's sweep: MHA
                (1, 8, 2, 256, 256, 32, 0),       # GQA 4:1
                (1, 4, 1, 256, 256, 64, 0),       # MQA
                (1, 4, 2, 256, 256, 64, 96),      # window 96
                (2, 4, 2, 300, 300, 16, 0),       # ragged, hd 16
                (1, 8, 1, 1537, 1537, 256, 0),    # ragged at gemma-2b's heads
                (2, 32, 32, 1024, 1024, 128, 0),  # hd 128: deepseek-7b (MHA)
                (1, 40, 8, 1000, 1000, 128, 0),   # hd 128: qwen2.5-14b, ragged
                (1, 16, 8, 2048, 2048, 256, 1024),  # gemma3-12b's local layers
                (4, 16, 16, 2048, 2048, 128, 0),  # olmoe-1b-7b's prefill
                (1, 32, 8, 2048, 2048, 128, 0),   # jamba-v0.1-52b's prefill
                (4, 32, 32, 2048, 2048, 64, 0),   # musicgen-large's prefill
                (4, 8, 1, 2048, 2048, 256, 0))    # gemma-2b's prefill
# kernel against plain version: in fp32 both sum in fp32 in other orders
# (errors near 1e-6 on outputs near 1); in bf16 the tensor-core kernel also
# rounds p to bf16 for the p.v product (2^-9 relative per term, which
# averages out over a row) and both round the output once, so they differ
# by about one bf16 ulp of |out| <= 4 (2^-8 * 4 = 0.016) at most
FLASH_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def attn_inputs(shape, dtype, g, dev):
    import torch
    b, h, kvh, sq, skv, hd, _ = shape
    return (torch.randn((b, h, sq, hd), generator=g, device=dev).to(dtype),
            torch.randn((b, kvh, skv, hd), generator=g, device=dev).to(dtype),
            torch.randn((b, kvh, skv, hd), generator=g, device=dev).to(dtype))


def check_flash_attention(dev):
    """flash_attention against its plain version, fp32 and bf16, at every
    shape of FLASH_SHAPES, within FLASH_TOL (rtol = atol)."""
    import torch
    from repro_torch.kernels import flash_attention as KF

    g = torch.Generator(device=dev).manual_seed(9)
    err, rows = 0.0, []
    for shape in FLASH_SHAPES:
        for name, tol in FLASH_TOL.items():
            q, k, v = attn_inputs(shape, getattr(torch, name), g, dev)
            want = KF.flash_attention_plain(q, k, v, shape[-1]).float()
            got = KF.flash_attention(q, k, v, shape[-1])
            torch.cuda.synchronize()
            e = float((got.float() - want).abs().max())
            err = max(err, e)
            close = (got.dtype == q.dtype and torch.allclose(
                got.float(), want, rtol=tol, atol=tol))
            rows.append({"shape": list(shape), "dtype": name, "ok": close,
                         "max_abs_err": e})
            log(f"[kernels] flash_attention {shape} {name}: allclose(rtol="
                f"atol={tol})={close} max_abs_err={e} "
                f"max|out|={float(want.abs().max()):.3f}")
            check(close, f"flash_attention {shape} {name} differs from its "
                  "plain version")
            del q, k, v, want, got
    return err, rows


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------

def table_iv_profiles():
    from repro_torch.data import genomics
    return [genomics.ReadProfile(p.name, p.mean_len * LENGTH_SCALE,
                                 p.std_len * LENGTH_SCALE, p.accuracy, p.mix)
            for p in genomics.PROFILES]


def align_shape(read_len: int, cells: int, cfg):
    """(rows, columns) of one alignment's DP matrix, from the bucketed read
    and window lengths."""
    from repro_torch.runtime import bucketing
    return (bucketing.round_up(read_len, cfg.read_bucket),
            bucketing.round_up(cells // read_len, cfg.read_bucket))


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

    KC.launches = KT.launches = KT.wavefront_launches = 0
    want_chain = want_align = 0
    max_n, max_align = 0, (0, 0)
    results, by_profile = [], {}
    sums = {"seed": 0.0, "chain": 0.0, "align": 0.0}
    t_all = time.perf_counter()
    for name, read, truth in ((n, r, t) for n, (r, t) in reads[1:]):
        torch.cuda.synchronize()
        res = mapper.map_read(read)
        ms = mapper.stage_ms
        for stage in sums:
            sums[stage] += ms.get(stage, 0.0)
        if res.n_anchors >= 2:
            want_chain += 1
            max_n = max(max_n, bucketing.round_up(res.n_anchors,
                                                  cfg.anchor_bucket))
        if res.align_cells:
            want_align += 1
            max_align = max(max_align, align_shape(len(read),
                                                   res.align_cells, cfg),
                            key=lambda x: x[0] * x[1])
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
    launches = {"chain_scan": KC.launches,
                "dp_wavefront": KT.wavefront_launches, "dp_tile": KT.launches}
    log(f"[main] stages summed over the {len(results)} reads: seed "
        f"{sums['seed']:.3f} ms, chain {sums['chain']:.3f} ms, align "
        f"{sums['align']:.3f} ms")
    log(f"[main] {len(results)} reads in {wall:.3f} s; launches {launches}; "
        f"expected chain={want_chain} dp_wavefront={want_align} (one per "
        f"aligned read) dp_tile=0; longest alignment {max_align}")
    check(KC.launches == want_chain and want_chain > 0,
          f"chain_scan launched {KC.launches} times, expected {want_chain}")
    check(KT.wavefront_launches == want_align and want_align > 0,
          f"dp_wavefront launched {KT.wavefront_launches} times, expected "
          f"{want_align}")
    check(KT.launches == 0, f"dp_tile launched {KT.launches} times on the "
          "main path, expected 0")
    for name, pairs in by_profile.items():
        acc = mapping_accuracy([r for r, _ in pairs], [t for _, t in pairs])
        log(f"[main] accuracy {name}: {acc}")
        if name.startswith("PBHF"):
            check(acc == 1.0, f"{name} reads not within 200 bases of truth: "
                  f"{[(r.pos, t) for r, t in pairs]}")
    return mapper, launches, max_n, max_align, results


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
        c0 = (KC.launches, KT.launches, KR.launches, KT.wavefront_launches)
        t0 = time.perf_counter()
        try:
            return self.adapter.run(payloads)
        finally:
            _Counted.depth -= 1
            c1 = (KC.launches, KT.launches, KR.launches,
                  KT.wavefront_launches)
            self.tally[self.adapter.name] = {
                "ms": (time.perf_counter() - t0) * 1e3,
                "chain_scan": c1[0] - c0[0], "dp_tile": c1[1] - c0[1],
                "radix_rank": c1[2] - c0[2], "dp_wavefront": c1[3] - c0[3]}


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
    KC.launches = KT.launches = KR.launches = KT.wavefront_launches = 0
    t0 = time.perf_counter()
    got = svc.submit([Request(k, p) for k, p in reqs])
    wall = time.perf_counter() - t0
    launches = {"chain_scan": KC.launches,
                "dp_wavefront": KT.wavefront_launches, "dp_tile": KT.launches,
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
    want_wf = {"sw": len(sw_b), "dtw": len(dtw_b), "map": len(map_b)}
    log(f"[service] expected chain_scan={want_chain} (chain buckets "
        f"{sorted(chain_b)}, map anchor buckets {sorted(map_chain_b)}), "
        f"dp_wavefront={want_wf} (one per bucket: sw {sorted(sw_b)}, dtw "
        f"{sorted(dtw_b)}, map align {sorted(map_b)}), dp_tile=0")
    check(launches["chain_scan"] == want_chain,
          f"service chain_scan launches {launches['chain_scan']} != "
          f"{want_chain} (one per anchor bucket)")
    check(launches["dp_wavefront"] == sum(want_wf.values())
          and all(tally[k]["dp_wavefront"] == v for k, v in want_wf.items()),
          f"service dp_wavefront launches "
          f"{ {k: tally[k]['dp_wavefront'] for k in want_wf} } != {want_wf} "
          f"(one per sw, dtw and map bucket)")
    check(launches["dp_tile"] == 0,
          f"service dp_tile launches {launches['dp_tile']} != 0")
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

    # one chain bucket again, through a dispatcher over a worker mesh of
    # the one card: position by position the mesh-less service's results
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.runtime import Dispatcher
    mesh_svc = KernelService(cfg, reference=mapper.reference, device=dev,
                             dispatcher=Dispatcher(mesh=make_worker_mesh(1)))
    bucket0 = min(chain_b)
    sel = [(p, res) for p, res in by["chain"]
           if bucketing.round_up(max(len(p["q"]), 1),
                                 cfg.anchor_bucket) == bucket0]
    torch.cuda.synchronize()
    KC.launches = 0
    got_mesh = mesh_svc.submit([Request("chain", p) for p, _ in sel])
    mesh_launches = KC.launches
    same = all(np.array_equal(a["f"], b["f"])
               and np.array_equal(a["pred"], b["pred"])
               for (_, a), b in zip(sel, got_mesh))
    log(f"[service] chain bucket {bucket0} ({len(sel)} requests) through "
        f"Dispatcher(mesh=make_worker_mesh(1)): {mesh_launches} chain_scan "
        f"launch; equal to the mesh-less results position by position: "
        f"{same}")
    check(same and len(got_mesh) == len(sel),
          "Dispatcher(mesh=...) chain results differ from mesh=None")
    check(mesh_launches == 1, f"mesh dispatch launched chain_scan "
          f"{mesh_launches} times for one bucket")

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
               "launches": {k: t[k] for k in ("chain_scan", "dp_wavefront",
                                               "dp_tile", "radix_rank")
                            if t[k]}}
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
            "mesh_dispatch": {"bucket": bucket0, "requests": len(sel),
                              "chain_scan_launches": mesh_launches,
                              "equal": same},
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
    """The sort traffic through the radix kernels: each request's keys as 4
    chunks through ops.radix_sort_chunks (one radix_hist and 4 radix_pass
    launches), the chunks merged with
    core.sort.merge_sorted, held exactly to the service's sort. Then, for
    timing, 1,048,576 keys in 64 chunks the same way, against
    torch.sort(stable=True)."""
    import numpy as np
    import torch
    from repro_torch.kernels import radix_rank as KR

    keys = [torch.as_tensor(p["keys"].astype(np.int64), device=dev)
            for p, _ in sort_traffic]
    torch.cuda.synchronize()
    KR.launches = KR.hist_launches = KR.pass_launches = 0
    t0 = time.perf_counter()
    merged = [alg1_sort(k, SORT_CHUNKS) for k in keys]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {"radix_rank": KR.launches, "radix_hist": KR.hist_launches,
                "radix_pass": KR.pass_launches}
    for (mk, mv), (_, res) in zip(merged, sort_traffic):
        check(np.array_equal(mk.cpu().numpy(), res["keys"])
              and np.array_equal(mv.cpu().numpy(), res["vals"]),
              "radix_sort_chunks + merge_sorted differs from the service's "
              "sort")
    log(f"[rank] {len(keys)} sort requests of {BULK_N} keys as "
        f"{SORT_CHUNKS} chunks through radix_sort_chunks + merge_sorted: "
        f"equal to the service's sort; launches {launches}, {ms:.3f} ms "
        f"host")
    want = {"radix_rank": 0, "radix_hist": len(keys),
            "radix_pass": 4 * len(keys)}
    check(launches == want, f"radix launches {launches}, expected {want} "
          f"(one histogram and 4 passes per chunked sort)")

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


def profiled_again(fn, tries=3):
    """profiled(fn) for an fn that may run again: a window in which the
    profiler recorded no device event at all is taken again, up to
    ``tries`` windows (on that machine CUPTI now and then returns an empty
    window; a window with events is never retaken)."""
    for _ in range(tries):
        wall, spans = profiled(fn)
        if spans:
            break
    return wall, spans


def kernel_device_us(fn, name, n=20):
    """Mean device microseconds of the kernels whose name holds ``name``
    over n calls of fn, from the profiler."""
    _, spans = profiled_again(lambda: [fn() for _ in range(n)])
    times = [e - st for st, e, nm in spans if name in nm]
    check(bool(times), f"the profiler saw no {name} in {n} calls")
    return statistics.mean(times)


def radix_times(dev, n_chunks, g) -> dict:
    """At (n_chunks, 16384): each radix kernel's ms (CUDA events), device
    us (profiler), plain ms and bound; radix_sort_chunks' ms, its device
    span and kernel sequence (one histogram, then 4 passes, nothing else),
    beside torch.sort(stable=True)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import radix_rank as KR

    lc = BULK_N // SORT_CHUNKS
    keys = torch.randint(0, 2**32, (n_chunks, lc), generator=g, device=dev,
                         dtype=torch.int64)
    vals = torch.randint(0, 2**31, (n_chunks, lc), generator=g, device=dev,
                         dtype=torch.int32)
    n = keys.numel()
    _, starts = KR.radix_hist(keys)
    r = {"shape": [n_chunks, lc], "tile": KR.tile_for(n_chunks, lc)}

    rank = lambda: KR.radix_rank(keys, 8)  # noqa: E731
    rank()
    r["rank_ctas"] = KR.last_grid
    r["rank_ms"] = time_cuda(rank, reps=50)
    r["rank_device_us"] = kernel_device_us(rank, "rank_tiles_kernel")
    r["rank_device_us_by_tile"] = {
        t: kernel_device_us(lambda: KR.radix_rank(keys, 8, tile=t),
                            "rank_tiles_kernel") for t in KR.TILES}
    r["rank_plain_ms"] = time_cuda(lambda: KR.radix_rank_plain(keys, 8),
                                   reps=5)
    r["rank_bound"] = bound(n * 8 + n * 4 + n_chunks * 256 * 4, 2 * n)

    hist = lambda: KR.radix_hist(keys)  # noqa: E731
    r["hist_ms"] = time_cuda(hist, reps=50)
    r["hist_device_us"] = kernel_device_us(hist, "radix_hist_kernel")
    r["hist_plain_ms"] = time_cuda(lambda: KR.radix_hist_plain(keys), reps=5)
    r["hist_bound"] = bound(n * 8 + 2 * n_chunks * 4 * 256 * 4, 4 * n)

    # a middle pass: int32 values in, keys and values out
    one = lambda: KR.radix_pass(keys, vals, starts, 1)  # noqa: E731
    r["pass_ms"] = time_cuda(one, reps=50)
    r["pass_device_us"] = kernel_device_us(one, "rank_tiles_kernel")
    r["pass_device_us_by_tile"] = {
        t: kernel_device_us(lambda: KR.radix_pass(keys, vals, starts, 1,
                                                  tile=t),
                            "rank_tiles_kernel") for t in KR.TILES}
    r["pass_plain_ms"] = time_cuda(
        lambda: KR.radix_pass_plain(keys, vals, starts, 1), reps=5)
    r["pass_bound"] = bound(n * 24 + n_chunks * 4 * 256 * 4, 2 * n)

    sort = lambda: ops.radix_sort_chunks(keys)  # noqa: E731
    r["sort_ms"] = time_cuda(sort, reps=20)
    # 5 sorts in one profiler window. The profiler may miss an event now
    # and then, so: every event it saw is a histogram or a pass kernel,
    # at least one call shows whole (histogram, then 4 passes), and the
    # times come from the whole calls.
    _, spans = profiled_again(lambda: [sort() for _ in range(5)])
    kinds = ["hist" if "radix_hist_kernel" in nm
             else "pass" if "rank_tiles_kernel" in nm else nm
             for _, _, nm in spans]
    calls = []
    for span, kind in zip(spans, kinds):
        if kind == "hist" or not calls:
            calls.append([])
        calls[-1].append((span, kind))
    whole = [[sp for sp, _ in c] for c in calls
             if [k for _, k in c] == ["hist"] + ["pass"] * 4]
    check(set(kinds) <= {"hist", "pass"} and whole,
          f"radix_sort_chunks ({n_chunks}, {lc}) ran {kinds} on the card: "
          f"not a histogram and 4 passes a call, and nothing else")
    kinds = ["hist"] + ["pass"] * 4
    r["sort_events_seen"] = [len(spans), 25]
    r["sort_device_us"] = statistics.median(busy_us(c) for c in whole)
    r["sort_span_us"] = statistics.median(c[-1][1] - c[0][0] for c in whole)
    r["sort_plain_ms"] = time_cuda(
        lambda: KR.radix_sort_chunks_plain(keys), reps=2, rounds=3)
    # the function reads the keys and writes keys and int32 indices once
    r["sort_bound"] = bound(n * (8 + 8 + 4), 2 * 5 * n)
    # the passes' own traffic: 8 bytes a key for the histogram, 24 a pass
    r["sort_lsd_bound_ms"] = n * (8 + 4 * 24) / HBM_BYTES_PER_S * 1e3
    lib = lambda: torch.sort(keys, dim=1, stable=True)  # noqa: E731
    r["torch_sort_ms"] = time_cuda(lib, reps=20)
    r["torch_sort_device_us"] = busy_us(
        profiled_again(lambda: [lib() for _ in range(5)])[1]) / 5
    log(f"[time] radix ({n_chunks}, {lc}), tile {r['tile']}: radix_rank "
        f"{r['rank_ms']:.4f} ms ({r['rank_device_us']:.2f} us device, "
        f"{r['rank_ctas']} CTAs; by tile {r['rank_device_us_by_tile']}), "
        f"plain {r['rank_plain_ms']:.3f} ms, bound "
        f"{r['rank_bound'][0]:.6f} ms; radix_hist {r['hist_ms']:.4f} ms "
        f"({r['hist_device_us']:.2f} us device), bound "
        f"{r['hist_bound'][0]:.6f} ms; radix_pass {r['pass_ms']:.4f} ms "
        f"({r['pass_device_us']:.2f} us device; by tile "
        f"{r['pass_device_us_by_tile']}), bound {r['pass_bound'][0]:.6f} ms")
    log(f"[time] radix_sort_chunks ({n_chunks}, {lc}): {r['sort_ms']:.4f} ms "
        f"({r['sort_device_us']:.2f} us device busy, "
        f"{r['sort_span_us']:.2f} us from the histogram's start to the last "
        f"pass's end; kernels {kinds}, {len(whole)} of 5 calls seen whole, "
        f"no other kernel), plain {r['sort_plain_ms']:.3f} ms, bound "
        f"{r['sort_bound'][0]:.6f} ms (LSD traffic "
        f"{r['sort_lsd_bound_ms']:.6f} ms); torch.sort(stable) "
        f"{r['torch_sort_ms']:.4f} ms ({r['torch_sort_device_us']:.2f} us "
        f"device busy)")
    return r


def radix_entries(dev, rank_info, errs) -> list:
    """The kernel-line entries of radix_rank, radix_hist, radix_pass and
    radix_sort_chunks at the rank path's shape (4, 16384), each with its
    numbers at 1,048,576 keys in 64 chunks beside."""
    import torch
    g = torch.Generator(device=dev).manual_seed(4)
    at = {n: radix_times(dev, n, g) for n in (SORT_CHUNKS, 64)}
    src = "src/repro_torch/kernels/csrc/radix_rank.cu"
    tpu = "src/repro/kernels/radix_rank.py:57"
    launches = rank_info["launches"]

    def entry(name, key, launch_key, err, library):
        out = {}
        for n, r in at.items():
            out[n] = {"ms": r[f"{key}_ms"],
                      "device_us": r[f"{key}_device_us"],
                      "plain_ms": r[f"{key}_plain_ms"],
                      "bound_ms": r[f"{key}_bound"][0],
                      "bound_by": r[f"{key}_bound"][1],
                      "library_ms": r["torch_sort_ms"] if library else None,
                      "shape": r["shape"], "tile": r["tile"]}
        e = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
             "launches": launches[launch_key], "max_abs_err": err,
             **out[SORT_CHUNKS], "at_64_chunks": out[64]}
        if library:
            e["library"] = "torch.sort(keys, dim=1, stable=True)"
        return e

    rank = entry("radix_rank", "rank", "radix_rank", errs["radix_rank"], True)
    hist = entry("radix_hist", "hist", "radix_hist", errs["radix_hist"],
                 False)
    one = entry("radix_pass", "pass", "radix_pass", errs["radix_pass"],
                False)
    sort = entry("radix_sort_chunks", "sort", "radix_pass",
                 max(errs["radix_hist"], errs["radix_pass"]), True)
    sort["launches"] = launches["radix_hist"] + launches["radix_pass"]
    sort["kernels"] = "radix_hist, then radix_pass per 8-bit digit"
    for n, r in at.items():
        part = sort if n == SORT_CHUNKS else sort["at_64_chunks"]
        part["lsd_bound_ms"] = r["sort_lsd_bound_ms"]
        part["span_us"] = r["sort_span_us"]
        part["torch_sort_device_us"] = r["torch_sort_device_us"]
        part["events_seen"] = r["sort_events_seen"]
        rpart = rank if n == SORT_CHUNKS else rank["at_64_chunks"]
        rpart["ctas"] = r["rank_ctas"]
        rpart["device_us_by_tile"] = r["rank_device_us_by_tile"]
        opart = one if n == SORT_CHUNKS else one["at_64_chunks"]
        opart["device_us_by_tile"] = r["pass_device_us_by_tile"]
    sort["alg1_1m_ms"] = rank_info["alg1_1m_ms"]
    sort["torch_sort_1m_ms"] = rank_info["torch_sort_1m_ms"]
    return [rank, hist, one, sort]


# --------------------------------------------------------------------------
# phase 4: kernels on against kernels off
# --------------------------------------------------------------------------

# bases of each read mapped with kernels on and off: the plain squire tiles
# take ~35 s per read at 2,000 bases, a quarter of that at 1,000 (500 makes
# room for the sharded arms)
ON_OFF_BASES = 500


def kernels_on_vs_off(mapper, reads, dev):
    """The first ON_OFF_BASES bases of one read per profile, mapped with the
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
        part = read[:ON_OFF_BASES]
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

WAVEFRONT_PLAIN_SHAPE = (512, 512)   # the plain tile loop's timing shape


def kernel_line(dev, launches, errs, max_n, max_align):
    import torch
    from repro_torch.core import align as TA
    from repro_torch.kernels import chain_scan as KC
    from repro_torch.kernels import dtw_wavefront as KT

    t = 64
    scores = masked_scores(max_n, t, 7, dev)
    w = torch.full((max_n,), 15.0, device=dev)
    chain_ms = time_cuda(lambda: KC.chain_scan(scores, w), reps=20)
    chain_plain = time_cuda(lambda: KC.chain_scan_plain(scores, w), reps=1,
                            rounds=3)
    # the timed call at the mapper's largest anchor bucket, held bit for bit
    f, off = KC.chain_scan(scores, w)
    f_ref, off_ref = KC.chain_scan_plain(scores, w)
    check(torch.equal(f, f_ref) and torch.equal(off, off_ref),
          f"chain_scan N={max_n} T={t} (the timed call) differs from its "
          f"plain version")
    c_bytes = max_n * t * 4 + max_n * 4 + max_n * 4 + max_n * 4
    c_bound, c_by = bound(c_bytes, 2 * max_n * t)
    chain_ns_row = chain_ms / max_n * 1e6
    log(f"[time] chain_scan N={max_n} T={t}: kernel {chain_ms:.4f} ms, "
        f"plain {chain_plain:.3f} ms, bound {c_bound:.6f} ms ({c_by}); "
        f"{chain_ns_row:.1f} ns per serial row; share of the bound "
        f"{c_bound / chain_ms:.6f}")

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
    _, spans = profiled(lambda: [KT.dp_tile(*ins, kind="sw")
                                 for _ in range(50)])
    tiles = [e - st for st, e, name in spans if "dp_tile_kernel" in name]
    tile_dev_us = statistics.mean(tiles) if tiles else None
    log(f"[time] dp_tile sw {tr}x{tc}: per launch {tile_ms:.4f} ms "
        f"({tile_dev_us} us device time), plain {tile_plain:.3f} ms, bound "
        f"{t_bound:.7f} ms ({t_by}); {batch} tiles in one launch "
        f"{batched_ms:.4f} ms = {batched_ms / batch * 1e3:.3f} us per tile")

    # dp_wavefront at the longest alignment of the main path, held there
    # cell by cell to the row-scan oracle core.align.sw_ref (exact in fp32
    # for integer scores); its plain version (the tile loop, ~30 ms per
    # tile) is timed only at a small shape. b is a copy of a with one base
    # in ten changed, so high scores run along the whole diagonal and pass
    # through every strip's hand-off.
    n, m = max_align
    a = torch.randint(0, 4, (n,), generator=g, device=dev, dtype=torch.int32)
    b = torch.randint(0, 4, (m,), generator=g, device=dev, dtype=torch.int32)
    k = min(n, m)
    keep = torch.rand(k, generator=g, device=dev) >= 0.1
    b[:k] = torch.where(keep, a[:k], b[:k])
    z = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731
    wf = lambda a_, b_: KT.dp_wavefront(  # noqa: E731
        a_, b_, z(b_.shape[0]), z(a_.shape[0]), z(), kind="sw", tile_r=tr,
        tile_c=tc)
    wf_ms = time_cuda(lambda: wf(a, b), reps=3, rounds=3)
    grid = KT.last_grid
    mat, bottom, right, corner = wf(a, b)
    want = TA.sw_ref(a, b)
    torch.cuda.synchronize()
    same = (torch.equal(mat, want) and torch.equal(bottom, want[-1])
            and torch.equal(right, want[:, -1])
            and float(corner) == float(want[-1, -1]))
    main_err = float((mat - want).abs().max())
    best = float(mat.max())
    del mat, want
    log(f"[kernels] dp_wavefront sw {n}x{m} tile {tr} (the timed call): "
        f"equal to sw_ref: {same}, max abs err {main_err}, best {best}")
    check(same and best > k, f"dp_wavefront sw {n}x{m} differs from sw_ref "
          f"(max abs err {main_err}) or missed the diagonal (best {best})")
    pn, pm = WAVEFRONT_PLAIN_SHAPE
    pa, pb = a[:pn].contiguous(), b[:pm].contiguous()
    wf_small_ms = time_cuda(lambda: wf(pa, pb), reps=10, rounds=3)
    wf_plain = time_cuda(lambda: KT.dp_wavefront_plain(
        pa, pb, z(pm), z(pn), z(), kind="sw", tile_r=tr, tile_c=tc),
        reps=1, rounds=3)
    # a, b, top0, left0, corner0 read once; the matrix, bottom row, right
    # column and corner written once; 7 fp32 operations per cell
    w_bytes = 4 * (2 * (n + m) + 1) + 4 * (n * m + m + n + 1)
    w_bound, w_by = bound(w_bytes, 7 * n * m)
    steps = n // tr + m // tc - 1
    log(f"[time] dp_wavefront sw {n}x{m} tile {tr}: kernel {wf_ms:.4f} ms "
        f"({grid} CTAs, {steps} tile steps: {wf_ms / steps * 1e3:.2f} us "
        f"each; {n * m * 4 / wf_ms / 1e9:.3f} TB/s of matrix), bound "
        f"{w_bound:.6f} ms ({w_by}); at {pn}x{pm}: kernel "
        f"{wf_small_ms:.4f} ms, plain {wf_plain:.3f} ms")

    return {"kernels": [
        {"name": "chain_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/chain_scan.cu",
         "replaces": "src/repro/kernels/chain_scan.py:61",
         "launches": launches["chain_scan"],
         "max_abs_err": errs["chain_scan"], "ms": chain_ms,
         "plain_ms": chain_plain, "bound_ms": c_bound, "bound_by": c_by,
         "library_ms": None, "shape": [max_n, t],
         "ns_per_row": chain_ns_row, "bound_share": c_bound / chain_ms},
        {"name": "dp_tile", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dtw_wavefront.cu",
         "replaces": "src/repro/kernels/dtw_wavefront.py:102",
         "launches": launches["dp_tile"],
         "max_abs_err": errs["dp_tile"], "ms": tile_ms,
         "plain_ms": tile_plain, "bound_ms": t_bound, "bound_by": t_by,
         "library_ms": None, "shape": [tr, tc],
         "batched_us_per_tile": batched_ms / batch * 1e3,
         "tile_device_us": tile_dev_us},
        {"name": "dp_wavefront", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dtw_wavefront.cu",
         "replaces": "src/repro/kernels/dtw_wavefront.py:102",
         "launches": launches["dp_wavefront"],
         "max_abs_err": max(errs["dp_wavefront"], main_err), "ms": wf_ms,
         "plain_ms": wf_plain, "plain_shape": list(WAVEFRONT_PLAIN_SHAPE),
         "ms_at_plain_shape": wf_small_ms, "bound_ms": w_bound,
         "bound_by": w_by, "library_ms": None, "shape": [n, m],
         "tile": tr, "ctas": grid, "tile_steps": steps},
    ]}


def device_spans(prof):
    """(start, end, name) of every device event of a profiler run, sorted."""
    from torch.autograd import DeviceType
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA)


def busy_us(spans) -> float:
    """Microseconds in which at least one device event ran."""
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e, _ in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def device_trace(mapper, read):
    """One read through the kernels under torch.profiler (CUDA activity
    only): the card's busy share of the wall time, the chain and align
    stages' host ms, and the device ms of their chain_scan and dp_wavefront
    launches (and of any dp_tile launch). Returns None values when the
    trace holds no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mapper.map_read(read)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = device_spans(prof)
    if not spans:
        log("[trace] no device events in the profiler trace: not measured")
        return {"read_len": len(read), "busy_share": None,
                "align_device_ms": None}
    busy = busy_us(spans)
    wfs = [e - s for s, e, name in spans if "dp_wavefront_kernel" in name]
    tiles = [e - s for s, e, name in spans if "dp_tile_kernel" in name]
    chains = [e - s for s, e, name in spans if "chain_scan_kernel" in name]
    out = {"read_len": len(read), "wall_ms": wall_us / 1e3,
           "busy_share": busy / wall_us,
           "chain_host_ms": mapper.stage_ms.get("chain"),
           "chain_device_ms": sum(chains) / 1e3 if chains else None,
           "align_host_ms": mapper.stage_ms.get("align"),
           "dp_wavefront_spans": len(wfs), "dp_tile_spans": len(tiles),
           "align_device_ms": sum(wfs) / 1e3 if wfs else None}
    log(f"[trace] {len(read)}-base read: wall {wall_us / 1e3:.3f} ms under "
        f"the profiler, device busy {busy / 1e3:.3f} ms "
        f"(share {out['busy_share']:.4f}), {len(spans)} device events; "
        f"chain {out['chain_host_ms']:.3f} ms host, {len(chains)} chain_scan "
        f"launches of {out['chain_device_ms']} ms device time; "
        f"align {out['align_host_ms']:.3f} ms host, {len(wfs)} dp_wavefront "
        f"launches of {out['align_device_ms']} ms device time, "
        f"{len(tiles)} dp_tile launches")
    check(len(wfs) == 1 and not tiles, "the traced read's align stage did "
          "not run as one dp_wavefront launch")
    return out


# --------------------------------------------------------------------------
# phase paper_kernels: SpMV (Fig. 1c) and Needleman-Wunsch (§V-C)
# --------------------------------------------------------------------------

# (name, rows = columns, nonzeros per row at density, skew) of the SpMV
# checks: 65,536 x 65,536 with 16 nonzeros per row (1,048,576) and with
# power-law row lengths around 32 (skew 0.5: Lomax(3) lengths, mean 17 per
# row, 1.08 million nonzeros for seed 0, longest row 1,180). Both pass 10^6
# nonzeros while the ELL plan, whose width is the longest row, stays at
# 8 MB and ~0.6 GB (int32 columns and fp32 values); skew 1 would give
# Lomax(2) lengths whose longest row (and plan) grows ~10x
SPMV_CASES = (("uniform", 65_536, 16, 0.0), ("skewed", 65_536, 32, 0.5))
SPMV_CHUNKS = 64
SPMV_RTOL = 1e-4              # of max |y|
ELL_MAX_BYTES = 4e9
NW_LEN, NW_TILE, NW_REF_LEN = 2048, 64, 256


def nw_oracle(a, b, match=2.0, mismatch=-4.0, gap=4.0):
    """Needleman-Wunsch by a double loop over Python numbers (exact for the
    integer scores): the (len(a), len(b)) matrix with linear-gap
    boundaries M[i, -1] = -(i+1)*gap, M[-1, j] = -(j+1)*gap."""
    import numpy as np
    n, m = len(a), len(b)
    prev = [-gap * (j + 1) for j in range(m)]
    out = np.empty((n, m), np.float32)
    for i in range(n):
        ai, left = a[i], -gap * (i + 1)
        diag = left + gap
        row = [0.0] * m
        for j in range(m):
            h = max(diag + (match if ai == b[j] else mismatch),
                    prev[j] - gap, left - gap)
            row[j] = h
            diag, left = prev[j], h
        out[i] = row
        prev = row
    return out


def spmv_case(dev, name, n, per_row, skew, seed) -> dict:
    """random_csr on the card; spmv_chunked (ELL plan of SPMV_CHUNKS worker
    chunks) and spmv_segsum against each other and against
    torch.sparse_csr_tensor(...) @ x (used here only as this check), each
    within SPMV_RTOL of max |y|; then the ms of each on the card."""
    import torch
    from repro_torch.core import spmv as TS

    t0 = time.perf_counter()
    m = TS.random_csr(n, n, per_row / n, seed=seed, skew=skew, device=dev)
    gen_s = time.perf_counter() - t0
    nnz = int(m.data.shape[0])
    lens = torch.diff(m.indptr)
    check(nnz >= 1_000_000, f"spmv {name}: {nnz} nonzeros < 10^6")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn(n, generator=g, device=dev)
    t0 = time.perf_counter()
    cols, vals = TS.ell_plan(m, n, SPMV_CHUNKS, dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    ell_bytes = cols.numel() * 4 + vals.numel() * 4     # int32 + fp32
    check(ell_bytes <= ELL_MAX_BYTES, f"spmv {name}: ELL plan of "
          f"{ell_bytes} bytes")
    y_chunk = TS.spmv_chunked(m, x, n, num_chunks=SPMV_CHUNKS)
    y_seg = TS.spmv_segsum(m, x, n)
    sparse = torch.sparse_csr_tensor(m.indptr, m.indices, m.data, (n, n))
    y_lib = sparse @ x
    scale = float(y_lib.abs().max())
    errs = {"chunked_vs_segsum": float((y_chunk - y_seg).abs().max()),
            "chunked_vs_sparse": float((y_chunk - y_lib).abs().max()),
            "segsum_vs_sparse": float((y_seg - y_lib).abs().max())}
    for what, e in errs.items():
        check(e <= SPMV_RTOL * scale, f"spmv {name}: {what} differ by {e} "
              f"> {SPMV_RTOL} * {scale}")
    ms_chunk = time_cuda(lambda: TS.spmv_ell(cols, vals, x, n), reps=20)
    ms_seg = time_cuda(lambda: TS.spmv_segsum(m, x, n), reps=20)
    ms_lib = time_cuda(lambda: sparse @ x, reps=20)
    # indptr, indices, data and x read once, y written once
    n_bytes = 4 * ((n + 1) + 2 * nnz + 2 * n)
    b_ms, b_by = bound(n_bytes, 2 * nnz)
    log(f"[spmv] {name} {n}x{n}, {nnz} nonzeros (rows {int(lens.min())}-"
        f"{int(lens.max())}), skew {skew}: generated in {gen_s:.2f} s, ELL "
        f"plan {tuple(cols.shape)} of {ell_bytes} bytes packed in "
        f"{pack_s:.2f} s; max |y| {scale:.4f}, errors {errs}; "
        f"spmv_chunked (spmv_ell on the plan) {ms_chunk:.4f} ms, "
        f"spmv_segsum {ms_seg:.4f} ms, sparse_csr @ x {ms_lib:.4f} ms, "
        f"bound {b_ms:.6f} ms ({b_by})")
    del cols, vals, sparse
    return {"name": name, "n": n, "nnz": nnz, "skew": skew,
            "max_row": int(lens.max()), "chunks": SPMV_CHUNKS,
            "ell_bytes": ell_bytes, "max_abs_y": scale, "errors": errs,
            "rtol": SPMV_RTOL, "gen_s": gen_s, "pack_s": pack_s,
            "ms_chunked": ms_chunk, "ms_segsum": ms_seg,
            "ms_sparse_csr": ms_lib, "bound_ms": b_ms, "bound_by": b_by}


def paper_kernels(dev, seed) -> dict:
    """SpMV at two matrices of >= 10^6 nonzeros, then Needleman-Wunsch:
    nw_tiled at NW_LEN^2 in NW_TILE tiles (the plain tile on the port's
    run_wavefront) and nw_ref at NW_REF_LEN^2, each equal to the double-loop
    oracle exactly."""
    import numpy as np
    import torch
    from repro_torch.core import align as TA

    out = {"spmv": [spmv_case(dev, name, n, per_row, skew, seed)
                    for name, n, per_row, skew in SPMV_CASES]}
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 70)
    a = rng.integers(0, 4, NW_LEN)
    b = a.copy()                    # a with one base in ten changed
    hit = rng.random(NW_LEN) < 0.1
    b[hit] = (b[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    t0 = time.perf_counter()
    want = nw_oracle(a.tolist(), b.tolist())
    oracle_s = time.perf_counter() - t0
    at = torch.as_tensor(a, dtype=torch.int32, device=dev)
    bt = torch.as_tensor(b, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mat, score = TA.nw_tiled(at, bt, tile_r=NW_TILE, tile_c=NW_TILE)
    torch.cuda.synchronize()
    tiled_ms = (time.perf_counter() - t0) * 1e3
    got = mat.cpu().numpy()
    check(np.array_equal(got, want) and float(score) == want[-1, -1],
          f"nw_tiled {NW_LEN}^2 differs from the oracle in "
          f"{int((got != want).sum())} cells")
    k = NW_REF_LEN
    ref = TA.nw_ref(at[:k], bt[:k])
    torch.cuda.synchronize()
    ref_ms = time_cuda(lambda: TA.nw_ref(at[:k], bt[:k]), reps=1, rounds=3)
    check(np.array_equal(ref.cpu().numpy(), want[:k, :k]),
          f"nw_ref {k}^2 differs from the oracle")
    tiles = (NW_LEN // NW_TILE) ** 2
    log(f"[nw] nw_tiled {NW_LEN}x{NW_LEN}, tile {NW_TILE} ({tiles} plain "
        f"tiles on run_wavefront): {tiled_ms:.1f} ms, score "
        f"{float(score)}, equal to the double-loop oracle ({oracle_s:.1f} s "
        f"on the host); nw_ref {k}x{k}: {ref_ms:.3f} ms, equal")
    out["nw"] = {"n": NW_LEN, "tile": NW_TILE, "tiles": tiles,
                 "tiled_ms": tiled_ms, "score": float(score),
                 "ref_n": k, "ref_ms": ref_ms, "oracle_s": oracle_s}
    return out


# --------------------------------------------------------------------------
# phase 6: the LM path, RWKV-6 1.6B at full width
# --------------------------------------------------------------------------

LM_ARCH = "rwkv6-1.6b"
LM_PARAMS = 1_583_990_784     # jax.eval_shape of the reference's init_model
# launch.serve's greedy tokens (16, down from 32, to make room)
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 16
# generate's ragged prompt rides (796 - 1) mod 256 = 27 tokens on the
# decode ramp (a 1,000-token prompt rode 231; cut to make room)
GEN_PROMPTS, GEN_CHUNK, GEN_NEW = (796, 1537), 256, 16
ON_OFF_RTOL = 1e-3            # of the largest magnitude of each tensor
DECODE_PROFILE_STEPS = 8


def tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def perturb_decay(params, g):
    """Random decay LoRA in every layer. At init ``w_lora_b`` is zero, every
    decay lies in [0.69, 0.9975] and the clamp to >= e^-1 never bites;
    with these values some decays fall below e^-1."""
    for layer in params.layers:
        layer["rwkv"]["w_lora_a"].normal_(0.0, 0.1, generator=g)
        layer["rwkv"]["w_lora_b"].normal_(0.0, 0.3, generator=g)


def decay_share_below_clamp(params, cfg, tokens) -> float:
    """Share of layer 0's decays below e^-1 on these tokens."""
    import math
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as TS
    with torch.inference_mode():
        h = L.rmsnorm(params.layers[0]["norm1"],
                      L.embed(params.embed, tokens, cfg.dtype))
        *_, w = TS._time_mix_inputs(params.layers[0]["rwkv"], h,
                                    TS._token_shift(h, None))
        return float((w < math.exp(-1.0)).float().mean())



# one prompt through generate's chunk path and through one prefill, fp32
GVP_PROMPT, GVP_CHUNK = 200, 64     # 3 chunks of 64, then 8 decode steps
# gate on max |generate-path logits - prefill logits| / max |prefill logits|:
# RWKV carries fp32 state either way, so only fp32 sums reassociate (the
# kernel-vs-plain gate's 1e-3); attention's chunks and decode steps attend
# over the bf16 KV cache, the prefill over unrounded fp32 k and v (as in the
# reference), one rounding of 2^-9 on every cached value: 2.4e-3 on the
# reduced gemma-2b on the CPU, so 3e-2 leaves room for 18 layers at full
# width, while a wrong position, mask or cache entry moves the last logits
# by a large part of their magnitude
GVP_RTOL = {"rwkv": 1e-3, "attn": 3e-2}


def chunk_walk(params, cfg, dev, prompt, kv_dtype=None):
    """``prompt`` consumed as engine.generate consumes it: full chunks of
    GVP_CHUNK through make_chunk_step over the first L-1 tokens, the rest
    through make_slot_decode_step, on KV caches in ``kv_dtype`` if given
    (else the port's bf16). Returns the last position's logits and the
    (first, end) positions of each step, in order."""
    import torch
    from repro_torch.models import transformer as TT
    from repro_torch.serve import engine

    n = prompt.shape[0]
    chunk = engine.make_chunk_step(cfg)
    step = engine.make_slot_decode_step(cfg)
    caches = TT.init_caches(cfg, 1, n + 1, per_slot_pos=True, device=dev)
    if kv_dtype is not None:
        for c in caches.values():
            if "attn" in c:
                c["attn"] = c["attn"]._replace(k=c["attn"].k.to(kv_dtype),
                                               v=c["attn"].v.to(kv_dtype))
    at = lambda p: torch.tensor([p], device=dev)  # noqa: E731
    ctx, spans = 0, []
    while n - 1 - ctx >= GVP_CHUNK:
        _, caches = chunk(params, caches, prompt[None, ctx:ctx + GVP_CHUNK],
                          at(ctx))
        spans.append((ctx, ctx + GVP_CHUNK))
        ctx += GVP_CHUNK
    while ctx < n:
        _, lg, caches = step(params, caches, prompt[None, ctx:ctx + 1],
                             at(ctx), torch.zeros(1, device=dev), None)
        spans.append((ctx, ctx + 1))
        ctx += 1
    return lg[0, -1], spans


def generate_vs_prefill(params, cfg, dev, seed, rtol) -> dict:
    """The prompt consumed as engine.generate consumes it (chunk_walk) up
    to its last position, against one make_prefill_step over the whole
    prompt: the last position's logits within rtol of the largest prefill
    logit."""
    import torch
    from repro_torch.serve import engine

    g = torch.Generator(device=dev).manual_seed(seed + 30)
    prompt = torch.randint(0, cfg.vocab, (GVP_PROMPT,), generator=g,
                           device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, spans = chunk_walk(params, cfg, dev, prompt)
    n_chunks = sum(1 for a, b in spans if b - a > 1)
    n_steps = len(spans) - n_chunks
    want, _ = engine.make_prefill_step(cfg, 0)(params,
                                               {"tokens": prompt[None]})
    torch.cuda.synchronize()
    err = float((lg - want[0, -1]).abs().max())
    scale = float(want.abs().max())
    log(f"[gen-vs-prefill] {cfg.name} fp32, prompt {GVP_PROMPT}: {n_chunks} "
        f"chunks of {GVP_CHUNK} + {n_steps} decode steps against one "
        f"prefill: last logits max_abs_err {err} of max |logit| "
        f"{scale:.4f} ({err / scale:.3e} relative, gate {rtol}); "
        f"{(time.perf_counter() - t0):.1f} s")
    check(err <= rtol * scale, f"{cfg.name}: generate's chunk path and one "
          f"prefill differ by {err} > {rtol} * {scale}")
    return {"prompt": GVP_PROMPT, "chunk": GVP_CHUNK, "chunks": n_chunks,
            "decode_steps": n_steps, "max_abs_err": err,
            "max_abs_logit": scale, "rel_err": err / scale, "rtol": rtol}


# the scheduler sub-phases: 8 requests on a pool of 4 slots, prompts of
# 257-2,049 tokens with (L-1) mod 256 <= 31 (full chunks of 256, then a
# short decode ramp) and 8-24 new tokens; 4 submitted at once, then one
# every 3 steps
SCHED_SLOTS, SCHED_MAX_LEN, SCHED_CHUNK, SCHED_REQS = 4, 2304, 256, 8
SCHED_TIE_RTOL = 1e-3         # a first difference must be a near-tie
# the near-tie bound of bf16 runs: a bf16 logit carries 8 bits (1e-3 of
# max |logit| is a quarter of one ulp), and two paths of one bf16 model
# differ by about 2e-2 of max |logit| on the card (the attention phase's
# bf16 prefill, flash_attention against blockwise_attention); 3e-2 is the
# generate_vs_prefill gate of the attention models
BF16_TIE_RTOL = 3e-2
# score() against the engine path at batch 1: the same chunk and decode
# steps, but the pool decodes 4 rows where the engine path decodes 1, so
# cuBLAS may pick another GEMM and round otherwise (of max |logit|)
SCORE_RTOL = 1e-4
# score(): each prompt alone (its chunks at batch 1), 2 chunks + 7 decode
# steps and 1 chunk + 23. Held to the same prompt fed by hand through the
# engine's chunk and decode steps at batch 1 (generate's path), and, for
# gemma-2b, to one forward's log-softmax, each at generate_vs_prefill's gate.
# RWKV-6's agreement with one forward is printed, not gated: at this random
# init its logits depend on the GEMM shapes that produced the first
# positions (a batch of 4 against 1, or one length against another, moves
# them, and the WKV state carries the move on), the plain scan as much as
# the kernel; the run prints two forwards of the same prompt at lengths L
# and one chunk beside it
SCORE_LENS = (520, 280)
SERVICE_LENS, SERVICE_NEW = (265, 520, 270), 8
# the continuous run's steps under the profiler: past the first admissions,
# arrivals and their chunks among decode ticks (the trace of a whole run
# takes a minute to read back, and each profiled step a second or more:
# the window is 4 steps, down from 12, to make room)
SCHED_PROFILE_STEPS = (6, 10)


def sched_requests(vocab, seed):
    """(prompts, max_new_tokens) of the scheduler sub-phases, from seed."""
    import numpy as np
    rng = np.random.default_rng(seed + 60)
    q = rng.integers(1, 9, SCHED_REQS)
    r = np.where(q == 8, 0, rng.integers(0, 32, SCHED_REQS))
    lens = 1 + SCHED_CHUNK * q + r
    # halved (4 to 12 new tokens; the draw is unchanged, so the prompts
    # are the same) to make room for the sharded arms
    mnts = rng.integers(8, 25, SCHED_REQS) // 2
    prompts = [rng.integers(0, vocab, ln).astype(np.int32) for ln in lens]
    return prompts, [int(n) for n in mnts]


def drive_scheduler(sched, prompts, mnts, window=None, first=SCHED_SLOTS):
    """``first`` requests at once, then one every 3 steps, to the end:
    completions by request index. ``window`` = (first, last) step: those
    steps run under torch.profiler (CUDA activity), whose (wall us, device
    spans) go into ``sched.profile_window``, and the seconds spent reading
    the trace back into ``sched.profile_read_s``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    rid2i = {}
    for i in range(first):
        rid2i[sched.submit([prompts[i]], max_new_tokens=mnts[i])[0]] = i
    sub, steps, done = first, 0, []
    prof = None
    while sched.pending or sched.live or sub < len(prompts):
        if window and steps == window[0]:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            t0 = time.perf_counter()
        done += sched.step()
        steps += 1
        if prof is not None and steps == window[1]:
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
            t_read = time.perf_counter()
            prof.stop()
            sched.profile_window = (wall, device_spans(prof))
            sched.profile_read_s = time.perf_counter() - t_read
            prof = None
        if steps % 3 == 0 and sub < len(prompts):
            rid2i[sched.submit([prompts[sub]],
                               max_new_tokens=mnts[sub])[0]] = sub
            sub += 1
    done += sched.drain()
    torch.cuda.synchronize()
    check(len(done) == len(prompts), f"{len(done)} completions of "
          f"{len(prompts)}")
    return {rid2i[c.rid]: c for c in done}


def sched_config(**kw):
    from repro_torch.serve import SchedulerConfig
    return SchedulerConfig(**{"num_slots": SCHED_SLOTS,
                              "max_len": SCHED_MAX_LEN,
                              "prefill_chunk": SCHED_CHUNK, **kw})


def stream_gate(params, cfg, dev, prompts, mnts, done, want, what,
                rtol=SCHED_TIE_RTOL, prefill=None):
    """Each completion in ``done`` (by request index) against the stream
    ``want[i]``: all ``mnts[i]`` tokens (reason 'length'), equal, or first
    different at a near-tie of the two tokens' logits (within ``rtol`` of
    max |logit|, one prefill of the prompt plus the common prefix in the
    weights' dtype: cuBLAS may take another kernel at another batch width).
    ``prefill(i)``, if given, returns the prefill step to use for request
    i. Returns (streams equal exactly, near-ties)."""
    import numpy as np
    import torch
    from repro_torch.serve import engine
    plain = engine.make_prefill_step(cfg, 0)
    exact, ties = 0, []
    for i, (p, n) in enumerate(zip(prompts, mnts)):
        got = done[i].tokens
        check(len(got) == n and done[i].reason == "length",
              f"{what}, request {i}: {len(got)} tokens ({done[i].reason})")
        if np.array_equal(got, want[i]):
            exact += 1
            continue
        j = int(np.argmax(got != want[i]))
        ctx = np.concatenate([p, got[:j]])
        lg, _ = (prefill(i) if prefill else plain)(params, {
            "tokens": torch.as_tensor(ctx, dtype=torch.int64,
                                      device=dev)[None]})
        lg = lg[0, -1].float()
        gap = float((lg[int(got[j])] - lg[int(want[i][j])]).abs())
        scale = float(lg.abs().max())
        ties.append({"request": i, "at": j, "tokens": [int(got[j]),
                     int(want[i][j])], "logit_gap": gap, "max_abs": scale})
        check(gap <= rtol * scale, f"{what}, request {i}: differs "
              f"at token {j} ({int(got[j])} vs {int(want[i][j])}) with a "
              f"logit gap {gap} > {rtol} * {scale}")
    return exact, ties


def scheduler_fp32(params, cfg, dev, seed, rtol, counter,
                   gate_forward: bool) -> dict:
    """The fp32 weights through serve.Scheduler at full width: every
    stream against per-request engine.generate (same chunk policy) on the
    card, a first difference allowed only at a near-tie of the two tokens'
    logits (within SCHED_TIE_RTOL of max |logit|, one fp32 prefill of the
    prompt plus the common prefix: cuBLAS may take another kernel at batch
    4 than at 1); score() within SCORE_RTOL of max |logit| of the engine
    path at batch 1 and, with ``gate_forward``, within ``rtol`` (the
    generate_vs_prefill gate) of one fp32 forward's log-softmax; one
    KernelService(lm=...) submit of 2 generate and 1 score request equal
    to a direct run of the same requests on a scheduler of its own."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as TT
    from repro_torch.runtime import KernelService, Request
    from repro_torch.serve import Scheduler, engine

    prompts, mnts = sched_requests(cfg.vocab, seed)
    sched = Scheduler(cfg, params, sched_config())
    counter.launches = 0
    t0 = time.perf_counter()
    done = drive_scheduler(sched, prompts, mnts)
    wall = time.perf_counter() - t0
    launches = counter.launches
    want = [engine.generate(params, cfg, p, n, prefill_chunk=SCHED_CHUNK,
                            cache_slots=SCHED_MAX_LEN)[0]
            for p, n in zip(prompts, mnts)]
    exact, ties = stream_gate(params, cfg, dev, prompts, mnts, done, want,
                              "scheduler against generate")
    log(f"[sched] {cfg.name} fp32, {SCHED_REQS} requests (prompts "
        f"{[len(p) for p in prompts]}, new {mnts}) on {SCHED_SLOTS} slots: "
        f"{wall:.2f} s, {sched.counters['decode_steps']} decode ticks, "
        f"{sched.counters['chunk_steps']} chunk steps, {launches} "
        f"{counter.__name__.split('.')[-1]} launches; {exact} of "
        f"{SCHED_REQS} streams equal per-request generate exactly, "
        f"near-ties at the first difference: {ties}")

    g = torch.Generator(device=dev).manual_seed(seed + 61)
    chunk = engine.make_chunk_step(cfg)
    step = engine.make_slot_decode_step(cfg)
    score = []

    def lsm(lg, x):             # log p(x[i+1] | x[:i+1]) from (S, V) logits
        return torch.log_softmax(lg[:len(x) - 1].float(), -1).gather(
            -1, x[1:, None])[:, 0]

    for ln in SCORE_LENS:
        x = torch.randint(0, cfg.vocab, (ln,), generator=g, device=dev)
        (rid,) = sched.score([x.cpu().numpy()])
        sched.drain()
        got = sched.results.pop(rid)
        check(got.reason == "score" and got.logprobs.shape == (ln - 1,),
              f"score() of {ln} tokens returned {got.reason}, "
              f"{got.logprobs.shape}")
        got = torch.as_tensor(got.logprobs, device=dev)
        caches = TT.init_caches(cfg, 1, SCHED_MAX_LEN, per_slot_pos=True,
                                device=dev)
        at = lambda p: torch.tensor([p], device=dev)  # noqa: E731
        lgs, ctx = [], 0
        while ln - 1 - ctx >= SCHED_CHUNK:
            lg, caches = chunk(params, caches,
                               x[None, ctx:ctx + SCHED_CHUNK], at(ctx))
            lgs.append(lg[0])
            ctx += SCHED_CHUNK
        while ctx < ln - 1:
            _, lg, caches = step(params, caches, x[None, ctx:ctx + 1],
                                 at(ctx), torch.zeros(1, device=dev), None)
            lgs.append(lg[0])
            ctx += 1
        path = torch.cat(lgs)
        with torch.inference_mode():
            fwd = TT.apply_model(params, cfg, tokens=x[None])[0][0]
            fwd_c = TT.apply_model(params, cfg,
                                   tokens=x[None, :SCHED_CHUNK])[0][0]
        e_path = float((got - lsm(path, x)).abs().max())
        e_fwd = float((got - lsm(fwd, x)).abs().max())
        two_fwd = float((lsm(fwd_c, x[:SCHED_CHUNK])
                         - lsm(fwd, x)[:SCHED_CHUNK - 1]).abs().max())
        s_path, s_fwd = float(path.abs().max()), float(fwd.abs().max())
        score.append({"len": ln, "vs_engine_path": e_path,
                      "vs_one_forward": e_fwd,
                      "two_forwards_first_chunk": two_fwd,
                      "max_abs_logit": s_fwd})
        check(e_path <= SCORE_RTOL * s_path, f"score() of {ln} tokens: "
              f"logprobs differ from the engine path by {e_path} > "
              f"{SCORE_RTOL} * {s_path}")
        if gate_forward:
            check(e_fwd <= rtol * s_fwd, f"score() of {ln} tokens: logprobs "
                  f"differ from one forward by {e_fwd} > {rtol} * {s_fwd}")
    log(f"[sched] {cfg.name} fp32 score() against the engine path and one "
        f"forward's log-softmax: {score} (engine path gated at "
        f"{SCORE_RTOL} of max |logit|; one forward "
        f"{f'gated at {rtol}' if gate_forward else 'printed, not gated'})")

    sp = [np.random.default_rng(seed + 62 + i).integers(
        0, cfg.vocab, ln).astype(np.int32) for i, ln in
        enumerate(SERVICE_LENS)]
    direct = Scheduler(cfg, params, sched_config())
    gen = direct.submit(sp[:2], max_new_tokens=SERVICE_NEW)
    direct.drain()
    (srid,) = direct.score(sp[2:])
    direct.drain()
    svc = KernelService(lm=Scheduler(cfg, params, sched_config()),
                        device=dev)
    res = svc.submit([Request("generate", {"prompt": sp[0],
                                           "max_new_tokens": SERVICE_NEW}),
                      Request("generate", {"prompt": sp[1],
                                           "max_new_tokens": SERVICE_NEW}),
                      Request("score", {"prompt": sp[2]})])
    for out, rid in zip(res[:2], gen):
        want = direct.results[rid]
        check(np.array_equal(out["tokens"], want.tokens)
              and out["reason"] == want.reason,
              "KernelService generate differs from the scheduler's")
    check(np.array_equal(res[2]["logprobs"], direct.results[srid].logprobs),
          "KernelService score differs from the scheduler's")
    log(f"[sched] {cfg.name} KernelService(lm=Scheduler) submit of 2 "
        f"generate + 1 score request equals the scheduler's direct results")
    del sched, direct, svc
    torch.cuda.empty_cache()
    return {"requests": SCHED_REQS, "prompt_lens": [len(p) for p in prompts],
            "max_new": mnts, "slots": SCHED_SLOTS, "max_len": SCHED_MAX_LEN,
            "chunk": SCHED_CHUNK, "wall_s": wall, "launches": launches,
            "exact_streams": exact, "near_ties": ties, "score": score,
            "streams": [done[i].tokens.tolist() for i in range(SCHED_REQS)],
            "score_rtol": SCORE_RTOL, "score_forward_rtol": rtol,
            "score_forward_gated": gate_forward,
            "service_equal": True}


def scheduler_bf16(params, cfg, dev, seed, counter) -> dict:
    """The bf16 serving weights through serve.Scheduler, the same 8
    requests under admit='continuous' (the launch count at 0 just before
    and read just after) and admit='static': tokens/s of each (host clock
    to a synchronize), then the continuous run again under the profiler
    for the card's busy share. Printed, not gated."""
    import numpy as np
    import torch
    from repro_torch.serve import Scheduler

    prompts, mnts = sched_requests(cfg.vocab, seed)
    out = {}
    streams = {}
    for admit in ("continuous", "static"):
        sched = Scheduler(cfg, params, sched_config(admit=admit,
                                                    cache_requests=False))
        torch.cuda.synchronize()
        counter.launches = 0
        t0 = time.perf_counter()
        done = drive_scheduler(sched, prompts, mnts)
        wall = time.perf_counter() - t0
        launches = counter.launches
        st = sched.stats()
        toks = st["generated_tokens"]
        streams[admit] = [done[i].tokens for i in range(SCHED_REQS)]
        out[admit] = {
            "wall_s": wall, "generated_tokens": toks,
            "tok_s": toks / wall, "decode_steps": st["decode_steps"],
            "chunk_steps": st["chunk_steps"],
            "mean_occupancy": st["mean_occupancy"], "launches": launches,
            "ttft_ms_p50": st["ttft_ms.p50"], "ttft_ms_p95": st["ttft_ms.p95"],
            "itl_ms_p50": st["itl_ms.p50"]}
        log(f"[sched] {cfg.name} bf16 admit={admit}: {toks} tokens in "
            f"{wall:.3f} s ({toks / wall:.1f} tok/s), "
            f"{st['decode_steps']} decode ticks, {st['chunk_steps']} chunk "
            f"steps, mean occupancy {st['mean_occupancy']}, TTFT p50 "
            f"{st['ttft_ms.p50']:.1f} ms, ITL p50 {st['itl_ms.p50']:.2f} ms; "
            f"{launches} {counter.__name__.split('.')[-1]} launches")
        del sched
    same = sum(np.array_equal(a, b) for a, b in
               zip(streams["continuous"], streams["static"]))
    sched = Scheduler(cfg, params, sched_config(cache_requests=False))
    drive_scheduler(sched, prompts, mnts, window=SCHED_PROFILE_STEPS)
    wall, spans = sched.profile_window
    out["busy_share"] = busy_us(spans) / wall if spans else None
    out["profiled_steps"] = list(SCHED_PROFILE_STEPS)
    out["profiled_ms_per_step"] = wall / 1e3 / (SCHED_PROFILE_STEPS[1]
                                                - SCHED_PROFILE_STEPS[0])
    out["continuous_vs_static_equal_streams"] = same
    log(f"[sched] {cfg.name} bf16 continuous, steps "
        f"{SCHED_PROFILE_STEPS[0]}-{SCHED_PROFILE_STEPS[1] - 1} under the "
        f"profiler: {out['profiled_ms_per_step']:.2f} ms per step, card busy "
        f"{out['busy_share']}; {same} of {SCHED_REQS} streams equal between "
        "continuous and static (bf16 rounds otherwise at batch 4 and 1)")
    del sched
    torch.cuda.empty_cache()
    return out


# the paged sub-phases: allocator="paged" with blocks of 16 positions.
# fp32 parity on the scheduler trace above, in arms: equal memory (576
# blocks); a tight pool that the first three prompts fill exactly (their
# 150 blocks for seed 0), under recompute, swap and reserved admission (at
# half the blocks, 288, no decode-time growth on this trace ever finds the
# pool full, since head-of-line blocking leaves the slack; in the tight
# pool the first block crossing preempts); and prefix sharing on 8
# requests whose prompts share one PREFIX_LEN-token prefix. Each arm's
# streams against the contiguous run's, under stream_gate.
PAGED_BLOCK = 16
PREFIX_LEN = 1024
# bf16 occupancy at equal memory, the reference's bench_paged_occupancy
# traffic at the card's scale: contiguous 4 slots x 2,304 = 9,216 global KV
# positions against paged 16 slots over 9,216 / 16 - 1 = 575 blocks (the
# trash block fills the last 16 positions); 24 requests at once, prompts
# 1 + 256 q + r (q in 1..7, r in 0..31), outputs min(2 + int(pareto(1.1) *
# 4), 80). Gate: useful occupancy ratio >= 1.5 (the reference's gate;
# bookkeeping, so the same in every run)
OCC_REQS, OCC_SLOTS, OCC_MAX_NEW, OCC_GATE = 24, 16, 80, 1.5
# gemma3-12b at full width (d_model 3,840, head_dim 256, window 1,024), cut
# to one pattern period (6 layers: five window-1,024 layers and a global
# one, so both page-table groups) so that its fp32 weights fit beside the
# run and the smoke stays within its time (one period, down from two)
RING_ARCH, RING_LAYERS = "gemma3-12b", 6
# score() through the paged scheduler against the contiguous one: every
# position's logprob, where a stream only shows the argmax (at this random
# init gemma-2b's fp32 streams repeat one token). The same values through
# the same steps, so they should agree exactly; gated at 1e-5 absolute.
# gemma3-12b scores a 1,300-token prompt, past its 1,024-token window, so
# the paged rings wrap
PAGED_SCORE_ATOL = 1e-5
RING_SCORE_LENS = (1300, 520)


def prefix_requests(vocab, seed):
    """(prompts, max_new_tokens) sharing one PREFIX_LEN-token prefix: the
    scheduler trace's lengths (1 + 256 q + r) with q >= 4, from seed."""
    import numpy as np
    rng = np.random.default_rng(seed + 80)
    prefix = rng.integers(0, vocab, PREFIX_LEN).astype(np.int32)
    q = rng.integers(4, 9, SCHED_REQS)
    r = np.where(q == 8, 0, rng.integers(0, 32, SCHED_REQS))
    lens = 1 + SCHED_CHUNK * q + r
    mnts = rng.integers(8, 25, SCHED_REQS) // 2     # halved to make room
    prompts = [np.concatenate([prefix, rng.integers(
        0, vocab, ln - PREFIX_LEN).astype(np.int32)]) for ln in lens]
    return prompts, [int(n) for n in mnts]


def occupancy_requests(vocab, seed):
    """(prompts, max_new_tokens) of the bf16 occupancy sub-phase."""
    import numpy as np
    rng = np.random.default_rng(seed + 70)
    q = rng.integers(1, 8, OCC_REQS)
    r = rng.integers(0, 32, OCC_REQS)
    lens = 1 + SCHED_CHUNK * q + r
    mnts = np.minimum(2 + (rng.pareto(1.1, OCC_REQS) * 4).astype(int),
                      OCC_MAX_NEW)
    prompts = [rng.integers(0, vocab, ln).astype(np.int32) for ln in lens]
    return prompts, [int(n) for n in mnts]


def paged_stats(st) -> dict:
    """The paging keys of a scheduler's stats() worth printing."""
    keys = ("preempted", "recomputed_decode_steps", "swapped_out",
            "swapped_in", "prefix_shared_tokens", "decode_steps",
            "chunk_steps", "mean_occupancy", "page_groups", "blocks_total",
            "blocks_used", "shared_blocks", "cow_copies",
            "prefix_shared_chunks", "prefix_hit_chunks", "prefix_published",
            "swap_bytes_out", "swap_bytes_in", "swap_rejected",
            "position_capacity", "total_rows")
    return {k: st[k] for k in keys + tuple(k for k in st
                                           if k.startswith("ring"))}


def paged_score_gate(params, cfg, seed, lens, what, **kw) -> float:
    """score() of prompts of ``lens`` tokens (from seed) through the
    contiguous scheduler and the paged one (``kw`` over sched_config):
    the largest logprob difference, gated at PAGED_SCORE_ATOL."""
    import numpy as np
    from repro_torch.serve import Scheduler
    rng = np.random.default_rng(seed + 85)
    prompts = [rng.integers(0, cfg.vocab, ln).astype(np.int32)
               for ln in lens]
    lps = []
    for sc in (sched_config(), sched_config(
            allocator="paged", block_size=PAGED_BLOCK, **kw)):
        sched = Scheduler(cfg, params, sc)
        rids = sched.score(prompts)
        sched.drain()
        lps.append([sched.results[r].logprobs for r in rids])
        del sched
    err = max(float(np.abs(a - b).max()) for a, b in zip(*lps))
    log(f"[paged] {cfg.name} {what}: score() of {list(lens)} tokens, paged "
        f"against contiguous, max abs logprob difference {err}")
    check(err <= PAGED_SCORE_ATOL, f"{what}: paged score() differs from "
          f"the contiguous one by {err} > {PAGED_SCORE_ATOL}")
    return err


def paged_run(params, cfg, prompts, mnts, counter, **kw):
    """One drive_scheduler run of a paged scheduler (``kw`` over
    sched_config), the launch count at 0 just before and read just after:
    (completions, stats, wall s, launches)."""
    import torch
    from repro_torch.serve import Scheduler
    sched = Scheduler(cfg, params, sched_config(
        allocator="paged", block_size=PAGED_BLOCK, **kw))
    torch.cuda.synchronize()
    counter.launches = 0
    t0 = time.perf_counter()
    done = drive_scheduler(sched, prompts, mnts)
    wall = time.perf_counter() - t0
    launches = counter.launches
    st = sched.stats()
    check(st["blocks_used"] == st["shared_blocks"] == 0
          or kw.get("prefix_sharing"), f"paged {kw}: {st['blocks_used']} "
          "blocks still used after the trace")
    del sched
    return done, st, wall, launches


def paged_fp32(params, cfg, dev, seed, streams, counter):
    """The fp32 gemma-2b weights through the paged scheduler in the five
    arms above, each against the contiguous run (``streams``, and for the
    prefix arm a contiguous run of its own): equal streams under
    stream_gate, preemption in the tight arms, none recomputed under swap
    or when reserved, shared chunks mapped under prefix sharing, and no
    flash_attention launch (chunks and decode attend over the views).
    Returns the numbers and the equal-memory arm's (completions, stats),
    the sharded arms' oracle."""
    import numpy as np
    import torch
    from repro_torch.serve import Scheduler
    prompts, mnts = sched_requests(cfg.vocab, seed)
    want = [np.asarray(x, np.int32) for x in streams]
    tight = sum(-(-len(p) // PAGED_BLOCK) for p in prompts[:3])
    arms = (("equal", {}),
            ("recompute", dict(num_blocks=tight)),
            ("swap", dict(num_blocks=tight, preempt="swap")),
            ("reserved", dict(num_blocks=tight, admission="reserved")))
    out = {"block_size": PAGED_BLOCK, "tight_blocks": tight}
    for name, kw in arms:
        done, st, wall, launches = paged_run(params, cfg, prompts, mnts,
                                             counter, **kw)
        if name == "equal":
            equal = (done, st)
        exact, ties = stream_gate(params, cfg, dev, prompts, mnts, done,
                                  want, f"paged {name} against contiguous")
        out[name] = {"wall_s": wall, "exact_streams": exact,
                     "near_ties": ties, "launches": launches,
                     **paged_stats(st)}
        log(f"[paged] {cfg.name} fp32 {name} ({kw or 'equal memory'}): "
            f"{wall:.2f} s, {exact} of {SCHED_REQS} streams equal the "
            f"contiguous run's, near-ties {ties}; {launches} "
            f"{counter.__name__.split('.')[-1]} launches; {paged_stats(st)}")
        check(launches == 0, f"paged {name}: {launches} launches, expected "
              "0 (chunks and decode attend over the views)")
        if name in ("recompute", "swap"):
            check(st["preempted"] >= 1, f"paged {name}: no preemption")
        if name == "recompute":
            check(st["recomputed_decode_steps"] >= 1,
                  "paged recompute: no decode step recomputed")
        if name == "swap":
            check(st["recomputed_decode_steps"] == 0
                  and st["swapped_in"] == st["swapped_out"] >= 1
                  and st["swap_bytes_in"] == st["swap_bytes_out"] > 0,
                  f"paged swap: {paged_stats(st)}")
        if name in ("equal", "reserved"):
            check(st["preempted"] == 0, f"paged {name}: preempted "
                  f"{st['preempted']} times")

    pp, pm = prefix_requests(cfg.vocab, seed)
    base = drive_scheduler(Scheduler(cfg, params, sched_config()), pp, pm)
    done, st, wall, launches = paged_run(params, cfg, pp, pm, counter,
                                         prefix_sharing=True)
    exact, ties = stream_gate(params, cfg, dev, pp, pm, done,
                              [base[i].tokens for i in range(SCHED_REQS)],
                              "paged prefix sharing against contiguous")
    out["prefix"] = {"prefix_len": PREFIX_LEN,
                     "prompt_lens": [len(p) for p in pp], "max_new": pm,
                     "wall_s": wall, "exact_streams": exact,
                     "near_ties": ties, **paged_stats(st)}
    log(f"[paged] {cfg.name} fp32 prefix sharing ({SCHED_REQS} prompts "
        f"{[len(p) for p in pp]} sharing {PREFIX_LEN} tokens): {wall:.2f} s, "
        f"{exact} of {SCHED_REQS} streams equal the contiguous run's, "
        f"near-ties {ties}; {paged_stats(st)}")
    check(st["prefix_shared_chunks"] > 0, "prefix sharing mapped no chunk")
    out["score_max_abs_diff"] = paged_score_gate(
        params, cfg, seed, SCORE_LENS, "fp32 equal memory")
    torch.cuda.empty_cache()
    return out, equal


def paged_occupancy_bf16(params, cfg, seed, counter) -> dict:
    """The bf16 gemma-2b weights: OCC_REQS requests at once through the
    contiguous scheduler and through the paged one at equal memory, each
    driven to the end with the launch count at 0 just before and read
    just after. Per arm: useful occupancy (decode-ramp plus generated
    tokens of the completions per decode tick, so recomputed ticks do not
    count; the reference's measure), mean live slots, tok/s (host clock to
    a synchronize), TTFT and ITL p50, preemptions and, paged, the mean
    block utilisation over the ticks. Gate: the useful occupancy ratio."""
    import torch
    from repro_torch.serve import Scheduler
    prompts, mnts = occupancy_requests(cfg.vocab, seed)
    budget = SCHED_SLOTS * SCHED_MAX_LEN
    arms = {"contiguous": sched_config(cache_requests=False),
            "paged": sched_config(cache_requests=False, num_slots=OCC_SLOTS,
                                  allocator="paged", block_size=PAGED_BLOCK,
                                  num_blocks=budget // PAGED_BLOCK - 1)}
    out = {"requests": OCC_REQS, "prompt_lens": [len(p) for p in prompts],
           "max_new": mnts, "budget_positions": budget}
    for name, sc in arms.items():
        sched = Scheduler(cfg, params, sc)
        torch.cuda.synchronize()
        counter.launches = 0
        t0 = time.perf_counter()
        for p, n in zip(prompts, mnts):
            sched.submit([p], max_new_tokens=n)
        done, util = [], []
        while sched.pending or sched.live:
            done += sched.step()
            if sched.slots.paged:
                util.append(sched.slots.stats()["block_utilization"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counter.launches
        st = sched.stats()
        check(len(done) == OCC_REQS and all(
            len(c.tokens) == n for c, n in zip(
                sorted(done, key=lambda c: c.rid), mnts)),
            f"occupancy {name}: {len(done)} completions")
        useful = sum((c.prompt_len - 1) % SCHED_CHUNK + len(c.tokens)
                     for c in done) / st["decode_steps"]
        toks = st["generated_tokens"]
        out[name] = {
            "slots": sc.num_slots, "position_capacity":
                sched.slots.position_capacity,
            "useful_occupancy": useful,
            "mean_occupancy": st["mean_occupancy"], "wall_s": wall,
            "generated_tokens": toks, "tok_s": toks / wall,
            "ttft_ms_p50": st["ttft_ms.p50"], "itl_ms_p50": st["itl_ms.p50"],
            "decode_steps": st["decode_steps"],
            "chunk_steps": st["chunk_steps"], "preempted": st["preempted"],
            "recomputed_decode_steps": st["recomputed_decode_steps"],
            "mean_block_utilization":
                sum(util) / len(util) if util else None,
            "launches": launches}
        log(f"[paged] {cfg.name} bf16 occupancy, {name} ({sc.num_slots} "
            f"slots, {sched.slots.position_capacity} global KV positions): "
            f"useful occupancy {useful:.4f}, mean live "
            f"{st['mean_occupancy']}, {toks} tokens in {wall:.3f} s "
            f"({toks / wall:.1f} tok/s), TTFT p50 {st['ttft_ms.p50']:.1f} "
            f"ms, ITL p50 {st['itl_ms.p50']:.2f} ms, {st['decode_steps']} "
            f"decode ticks, {st['chunk_steps']} chunk steps, preempted "
            f"{st['preempted']}, mean block utilisation "
            f"{out[name]['mean_block_utilization']}; {launches} "
            f"{counter.__name__.split('.')[-1]} launches")
        check(launches == 0, f"occupancy {name}: {launches} launches")
        del sched
    check(out["paged"]["position_capacity"] + PAGED_BLOCK <= budget,
          "the paged pool outgrew the contiguous budget")
    ratio = (out["paged"]["useful_occupancy"]
             / out["contiguous"]["useful_occupancy"])
    out["occupancy_ratio"] = ratio
    log(f"[paged] {cfg.name} bf16 useful occupancy paged / contiguous at "
        f"equal memory: {ratio:.4f} (gate >= {OCC_GATE})")
    check(ratio >= OCC_GATE, f"occupancy ratio {ratio} < {OCC_GATE}")
    torch.cuda.empty_cache()
    return out


def ring_phase(dev, seed) -> dict:
    """gemma3-12b at full width, RING_LAYERS deep, fp32: the scheduler
    trace through the contiguous scheduler and the paged one, whose
    sliding-window layers page their rings through a ring-mode group
    (ring1024) beside the global group; streams under stream_gate, no
    flash_attention launch in either."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.models import transformer as TT
    from repro_torch.serve import Scheduler

    cfg = dataclasses.replace(configs.get_config(RING_ARCH),
                              num_layers=RING_LAYERS, dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(seed + 90)
    t0 = time.perf_counter()
    params = TT.init_model(cfg, g, dev)
    torch.cuda.synchronize()
    n = TT.param_count(params)
    log(f"[ring] {cfg.name} fp32, {cfg.num_layers} of 48 layers (d_model "
        f"{cfg.d_model}, head_dim {cfg.head_dim}, windows "
        f"{sorted({s.window for s in cfg.pattern})}): {n} parameters drawn "
        f"on the card in {time.perf_counter() - t0:.2f} s")
    prompts, mnts = sched_requests(cfg.vocab, seed)
    sched = Scheduler(cfg, params, sched_config())
    KF.launches = 0
    t0 = time.perf_counter()
    base = drive_scheduler(sched, prompts, mnts)
    wall_c = time.perf_counter() - t0
    launches_c = KF.launches
    del sched
    done, st, wall, launches = paged_run(params, cfg, prompts, mnts, KF)
    exact, ties = stream_gate(params, cfg, dev, prompts, mnts, done,
                              [base[i].tokens for i in range(SCHED_REQS)],
                              "ring groups against contiguous")
    log(f"[ring] {cfg.name}: contiguous {wall_c:.2f} s, paged {wall:.2f} s; "
        f"{exact} of {SCHED_REQS} streams equal, near-ties {ties}; "
        f"flash_attention launches {launches_c} / {launches}; paged stats "
        f"{paged_stats(st)}")
    check("ring1024_blocks_total" in st and st["page_groups"] == 2,
          f"no ring1024 group in the paged stats: {paged_stats(st)}")
    check(launches_c == launches == 0, "flash_attention launched in the "
          "ring scheduler runs")
    score_err = paged_score_gate(params, cfg, seed, RING_SCORE_LENS,
                                 "fp32 ring groups")
    del params
    torch.cuda.empty_cache()
    return {"arch": RING_ARCH, "layers": cfg.num_layers, "params": n,
            "d_model": cfg.d_model, "head_dim": cfg.head_dim,
            "contiguous_wall_s": wall_c, "paged_wall_s": wall,
            "exact_streams": exact, "near_ties": ties,
            "distinct_tokens": sorted({len(set(base[i].tokens.tolist()))
                                       for i in range(SCHED_REQS)}),
            "score_max_abs_diff": score_err, **paged_stats(st)}


# the speculative phases: the scheduler trace above with speculate=SPEC_K
# (prompt-lookup self-drafts) against speculate=0 in bf16, on contiguous
# slots and on the paged pool at equal memory (576 blocks of 16). Gate:
# each speculative stream equals the plain run's or first differs at a
# bf16 near-tie (stream_gate at BF16_TIE_RTOL): verify runs the chunk path,
# whose logits are not bitwise a decode step's (other GEMM and attention
# shapes). At this random init the greedy streams repeat one token, so
# prompt-lookup drafts are nearly always right: the acceptance rate
# printed is an upper bound that says nothing about real text. Host syncs
# are counted with torch.cuda.set_sync_debug_mode per decode tick and
# chunk step.
SPEC_K = 3
SPEC_BLOCKS = SCHED_SLOTS * SCHED_MAX_LEN // PAGED_BLOCK
# score() of RING_SCORE_LENS through the paged gemma3-12b scheduler with
# and without speculation. The positions that chunks consume go through
# the same chunk steps in both runs: gated at 1e-5 absolute (as the paged
# score() gate above). The last (L-1) mod 256 positions come from verify
# chunks of 4 in one run and decode steps in the other, whose bf16 GEMMs
# and attention round otherwise: gated at SPEC_SCORE_ULPS bf16 ulps of the
# largest |logit| over those positions (one forward of the prompt): 1e-5
# cannot hold there in bf16, where one ulp of a logit near 16 is 0.0625.
SPEC_SCORE_ATOL = 1e-5
SPEC_SCORE_ULPS = 2
# the obs loop's forced overload: the 8 requests at once on the paged
# sub-phases' tight pool (what the first three prompts fill) under
# preempt="swap"; a queue-wait rule at 0.1 ms (fire after 2 samples, clear
# after 2) drives a BackpressureController with admit_cap=1
OBS_QUEUE_WAIT_S = 1e-4
# the online autotune: dtw.tile over tiles the DTW path takes, thunks that
# submit 4 DTW pairs of each of DTW_LENGTHS through a KernelService of
# their own; the incumbent is the service phase's tile (SERVICE_SEQ)
RESWEEP_TILES = (32, 64, 128)


class count_syncs:
    """Context manager: the number of synchronizing CUDA operations (device
    to host copies, synchronizes, .item()) torch reports while it is open,
    through ``torch.cuda.set_sync_debug_mode("warn")``."""

    def __enter__(self):
        import torch
        import warnings
        self._catch = warnings.catch_warnings(record=True)
        self._seen = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        self.count = 0
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode(0)
        self.count = sum("synchroniz" in str(w.message) for w in self._seen)
        self._catch.__exit__(*exc)


def count_tick_syncs(sched) -> dict:
    """Wrap ``sched``'s decode (or verify) tick and chunk rounds so that
    each counts its host syncs into the returned dict ("decode",
    "chunk"), for the scheduler's lifetime."""
    tally = {"decode": 0, "chunk": 0}

    def counted(fn, key):
        def run():
            with count_syncs() as c:
                fn()
            tally[key] += c.count
        return run

    sched._decode_once = counted(sched._decode_once, "decode")
    sched._prefill_chunks = counted(sched._prefill_chunks, "chunk")
    return tally


def spec_arm(params, cfg, prompts, mnts, counter, k, window=None,
             **kw) -> dict:
    """One drive_scheduler run with speculate=k (``kw`` over sched_config,
    no request cache), the launch count at 0 just before and read just
    after, host syncs counted per decode tick and per chunk step, and with
    ``window`` the card's busy share over those steps (profiler; the
    trace's read-back time is taken out of the wall time):
    (completions, numbers)."""
    import torch
    from repro_torch.serve import Scheduler
    sched = Scheduler(cfg, params, sched_config(
        cache_requests=False, speculate=k, **kw))
    syncs = count_tick_syncs(sched)
    torch.cuda.synchronize()
    counter.launches = 0
    t0 = time.perf_counter()
    done = drive_scheduler(sched, prompts, mnts, window=window)
    wall = time.perf_counter() - t0
    launches = counter.launches
    st = sched.stats()
    busy = None
    if window:
        pwall, spans = sched.profile_window
        busy = busy_us(spans) / pwall if spans else None
        wall -= sched.profile_read_s
    toks = st["generated_tokens"]
    ticks = st["decode_steps"]
    out = {"speculate": k, "wall_s": wall, "generated_tokens": toks,
           "tok_s": toks / wall, "decode_steps": ticks,
           "chunk_steps": st["chunk_steps"], "steps": st["steps"],
           "ttft_ms_p50": st["ttft_ms.p50"], "itl_ms_p50": st["itl_ms.p50"],
           "host_syncs_decode": syncs["decode"],
           "host_syncs_chunk": syncs["chunk"],
           "host_syncs_per_decode_tick": syncs["decode"] / ticks,
           "launches": launches, "busy_share": busy,
           **{key: st[key] for key in (
               "spec.drafted_tokens", "spec.accepted_tokens",
               "spec.rejected_tokens", "spec.rollbacks",
               "spec.accept_len.count", "spec.accept_len.sum")}}
    out["acceptance"] = (st["spec.accepted_tokens"]
                         / st["spec.drafted_tokens"]
                         if st["spec.drafted_tokens"] else None)
    out["mean_accept_len"] = (st["spec.accept_len.sum"]
                              / st["spec.accept_len.count"]
                              if st["spec.accept_len.count"] else None)
    if kw.get("allocator") == "paged":
        out.update(paged_stats(st))
    del sched
    return done, out


def spec_compare(params, cfg, dev, prompts, mnts, counter, what,
                 **kw) -> dict:
    """speculate=0 against speculate=SPEC_K on one backing (``kw``): both
    runs' numbers, the stream gate, no flash_attention launch."""
    plain_done, plain = spec_arm(params, cfg, prompts, mnts, counter, 0,
                                 **kw)
    done, spec = spec_arm(params, cfg, prompts, mnts, counter, SPEC_K, **kw)
    exact, ties = stream_gate(params, cfg, dev, prompts, mnts, done,
                              [plain_done[i].tokens
                               for i in range(len(prompts))],
                              f"{what} speculate={SPEC_K} against 0",
                              rtol=BF16_TIE_RTOL)
    name = counter.__name__.split('.')[-1]
    for r in (plain, spec):
        log(f"[spec] {cfg.name} bf16 {what} speculate={r['speculate']}: "
            f"{r['generated_tokens']} tokens in {r['wall_s']:.3f} s "
            f"({r['tok_s']:.1f} tok/s), TTFT p50 {r['ttft_ms_p50']:.1f} ms, "
            f"ITL p50 {r['itl_ms_p50']:.2f} ms, {r['decode_steps']} decode "
            f"ticks, {r['chunk_steps']} chunk steps; drafted "
            f"{r['spec.drafted_tokens']}, accepted "
            f"{r['spec.accepted_tokens']}, rejected "
            f"{r['spec.rejected_tokens']}, rollbacks {r['spec.rollbacks']}, "
            f"acceptance {r['acceptance']}, mean accept length "
            f"{r['mean_accept_len']}; host syncs "
            f"{r['host_syncs_per_decode_tick']:.2f} per decode tick, "
            f"{r['host_syncs_chunk']} in chunk steps; "
            f"{r['launches']} {name} launches")
        check(r["launches"] == 0, f"{what} speculate={r['speculate']}: "
              f"{r['launches']} {name} launches, expected 0")
    log(f"[spec] {cfg.name} bf16 {what}: {exact} of {len(prompts)} "
        f"speculative streams equal the plain run's exactly, near-ties at "
        f"the first difference: {ties}; tok/s speculative / plain "
        f"{spec['tok_s'] / plain['tok_s']:.3f}")
    check(spec["spec.drafted_tokens"] > 0, f"{what}: no draft proposed")
    return {"plain": plain, "spec": spec, "exact_streams": exact,
            "near_ties": ties,
            "tok_s_ratio": spec["tok_s"] / plain["tok_s"],
            "streams": [done[i].tokens.tolist()
                        for i in range(len(prompts))]}


def spec_gemma2b(params, cfg, dev, seed, counter) -> dict:
    """The bf16 gemma-2b weights: the scheduler trace with and without
    speculation, on contiguous slots and on the paged pool."""
    import torch
    prompts, mnts = sched_requests(cfg.vocab, seed)
    t0 = time.perf_counter()
    out = {"k": SPEC_K,
           "contiguous": spec_compare(params, cfg, dev, prompts, mnts,
                                      counter, "contiguous"),
           "paged": spec_compare(params, cfg, dev, prompts, mnts, counter,
                                 "paged", allocator="paged",
                                 block_size=PAGED_BLOCK,
                                 num_blocks=SPEC_BLOCKS)}
    out["wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return out


def spec_ring(dev, seed) -> dict:
    """gemma3-12b at full width, RING_LAYERS deep, bf16, on the paged pool
    with a ring1024 group: the scheduler trace with and without
    speculation, then score() of RING_SCORE_LENS (the 1,300-token prompt
    wraps the rings) with and without it, gated at SPEC_SCORE_ATOL."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.models import transformer as TT
    from repro_torch.serve import Scheduler

    cfg = dataclasses.replace(configs.get_config(RING_ARCH),
                              num_layers=RING_LAYERS, dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(seed + 95)
    params = TT.init_model(cfg, g, dev)
    torch.cuda.synchronize()
    prompts, mnts = sched_requests(cfg.vocab, seed)
    kw = dict(allocator="paged", block_size=PAGED_BLOCK)
    out = spec_compare(params, cfg, dev, prompts, mnts, KF, "ring1024",
                       **kw)
    check(out["spec"]["page_groups"] == 2
          and "ring1024_blocks_total" in out["spec"],
          f"no ring1024 group: {out['spec']}")
    rng = np.random.default_rng(seed + 85)
    sp = [rng.integers(0, cfg.vocab, ln).astype(np.int32)
          for ln in RING_SCORE_LENS]
    lps = []
    for k in (0, SPEC_K):
        sched = Scheduler(cfg, params, sched_config(speculate=k, **kw))
        rids = sched.score(sp)
        sched.drain()
        lps.append([sched.results[r].logprobs for r in rids])
        del sched
    out["score"] = score_split(params, cfg, dev, sp, *lps)
    err = max(r["max_abs_diff"] for r in out["score"])
    check(all(np.isfinite(x).all() for x in lps[1]), "non-finite scores")
    for r in out["score"]:
        ulp = 2.0 ** (math.floor(math.log2(r["ramp_max_abs_logit"])) - 7)
        r["ramp_gate"] = SPEC_SCORE_ULPS * ulp
        check(r["chunk_max_abs_diff"] <= SPEC_SCORE_ATOL
              and r["ramp_max_abs_diff"] <= r["ramp_gate"],
              f"speculative score() differs from the plain one: {r}")
    out["score_max_abs_diff"] = err
    out.update({"arch": RING_ARCH, "layers": cfg.num_layers,
                "params": TT.param_count(params)})
    del params
    torch.cuda.empty_cache()
    return out


def score_split(params, cfg, dev, prompts, plain, spec) -> list:
    """Per prompt, the largest |plain - speculative| logprob difference
    over the chunk-consumed positions (the same chunk steps in both runs)
    and over the ramp (decode steps against verify chunks), beside the
    largest |logit| over the ramp positions from one forward of the
    prompt."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as TT
    out = []
    for p, a, b in zip(prompts, plain, spec):
        nc = SCHED_CHUNK * ((len(p) - 1) // SCHED_CHUNK)
        with torch.inference_mode():
            lg, _, _ = TT.apply_model(params, cfg, tokens=torch.as_tensor(
                p[None, :-1].astype(np.int64), device=dev), mode="train")
        d = np.abs(a - b)
        r = {"prompt_len": len(p), "chunk_positions": nc,
             "chunk_max_abs_diff": float(d[:nc].max()),
             "ramp_max_abs_diff": float(d[nc:].max()),
             "max_abs_diff": float(d.max()),
             "ramp_max_abs_logit": float(lg[0, nc:].float().abs().max())}
        out.append(r)
        log(f"[spec] {cfg.name} {str(cfg.dtype).replace('torch.', '')} "
            f"score() speculative against plain: {r}")
    return out


def obs_overload(params, cfg, dev, seed, counter) -> dict:
    """The closed loop on the bf16 gemma-2b weights: the scheduler trace's
    8 requests at once on the tight paged pool under preempt="swap",
    uncontrolled and then with a Sampler -> SLOManager (queue wait) ->
    BackpressureController(admit_cap=1) loop. Gate: the SLO fired and
    cleared, the knobs were restored, and every controlled stream equals
    the uncontrolled one or first differs at a near-tie."""
    import torch
    from repro_torch.obs import (REGISTRY, BackpressureController, Rule,
                                 Sampler, SLOManager, Tracer, set_sampler)
    from repro_torch.serve import Scheduler
    prompts, mnts = sched_requests(cfg.vocab, seed)
    tight = sum(-(-len(p) // PAGED_BLOCK) for p in prompts[:3])
    runs = {}
    for controlled in (False, True):
        sched = Scheduler(cfg, params, sched_config(
            cache_requests=False, allocator="paged", block_size=PAGED_BLOCK,
            num_blocks=tight, preempt="swap"))
        prev = None
        if controlled:
            smp = Sampler()
            slo = SLOManager([Rule("queue_wait",
                                   key="serve.queue_head_wait_s", op="<",
                                   threshold=OBS_QUEUE_WAIT_S, fire_after=2,
                                   clear_after=2)],
                             tracer=Tracer(enabled=False))
            ctrl = BackpressureController(sched, admit_cap=1,
                                          preempt="swap",
                                          tracer=Tracer(enabled=False))
            smp.add_listener(slo.on_sample)
            slo.subscribe(ctrl)
            prev = set_sampler(smp)
            fired0 = REGISTRY.counter("obs.slo.queue_wait.fired").value
            cleared0 = REGISTRY.counter("obs.slo.queue_wait.cleared").value
            engaged0 = REGISTRY.counter(
                "obs.control.backpressure.engaged").value
        torch.cuda.synchronize()
        counter.launches = 0
        t0 = time.perf_counter()
        try:
            rids = {sched.submit([p], max_new_tokens=n)[0]: i
                    for i, (p, n) in enumerate(zip(prompts, mnts))}
            done = {rids[c.rid]: c for c in sched.drain()}
        finally:
            if controlled:
                set_sampler(prev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = sched.stats()
        runs[controlled] = (done, {
            "wall_s": wall, "decode_steps": st["decode_steps"],
            "chunk_steps": st["chunk_steps"], "preempted": st["preempted"],
            "swapped_out": st["swapped_out"],
            "recomputed_decode_steps": st["recomputed_decode_steps"],
            "ttft_ms_p50": st["ttft_ms.p50"],
            "queue_wait_ms_p50": st["queue_wait_ms.p50"],
            "itl_ms_p50": st["itl_ms.p50"], "launches": counter.launches})
        if controlled:
            fired = REGISTRY.counter("obs.slo.queue_wait.fired").value \
                - fired0
            cleared = REGISTRY.counter("obs.slo.queue_wait.cleared").value \
                - cleared0
            runs[True][1].update({
                "slo_fired": fired, "slo_cleared": cleared,
                "engaged": REGISTRY.counter(
                    "obs.control.backpressure.engaged").value - engaged0,
                "samples": smp.sample_count})
            check(fired >= 1 and cleared == fired, f"queue-wait SLO fired "
                  f"{fired} and cleared {cleared} times")
            check(not slo.monitors["queue_wait"].firing
                  and not ctrl.engaged and sched.admit_cap is None
                  and sched.preempt_override is None,
                  "the backpressure knobs were not restored")
        del sched
    exact, ties = stream_gate(params, cfg, dev, prompts, mnts, runs[True][0],
                              [runs[False][0][i].tokens
                               for i in range(len(prompts))],
                              "backpressure against uncontrolled",
                              rtol=BF16_TIE_RTOL)
    out = {"tight_blocks": tight, "uncontrolled": runs[False][1],
           "controlled": runs[True][1], "exact_streams": exact,
           "near_ties": ties}
    for name, r in (("uncontrolled", runs[False][1]),
                    ("controlled", runs[True][1])):
        log(f"[obs] {cfg.name} bf16 overload, {tight}-block pool, swap, "
            f"{name}: {r}")
        check(r["launches"] == 0, f"obs {name}: {r['launches']} launches")
    log(f"[obs] backpressure: {exact} of {len(prompts)} streams equal the "
        f"uncontrolled run's exactly, near-ties {ties}")
    torch.cuda.empty_cache()
    return out


def obs_autotune(dev, seed) -> dict:
    """An AutotuneController on ``dtw.tile``: an incumbent measured at
    SERVICE_SEQ, then one re-sweep over RESWEEP_TILES whose thunks submit
    DTW requests through a KernelService at each tile (each submit launches
    dp_wavefront once per bucket). The DTW adapter dispatches through no
    Dispatcher bucket in either package, so the smoke feeds the
    dispatch_imbalance rule the DTW submit's own first-use and steady host
    ms under the rule's key names, at ratio 0 (any first-use cost breaches)
    and fire_after 1: the rule fires on the first sample, and a second
    sample finds the alert still firing and sweeps nothing. Gate:
    one re-sweep; the value applied only on a measured improvement; the
    results of the service with the chosen tile equal ops.dtw_tiled."""
    import numpy as np
    import torch
    from repro_torch.kernels import dtw_wavefront as KT
    from repro_torch.kernels import ops
    from repro_torch.obs import (AutotuneController, Registry, SLOManager,
                                 Tracer, dispatch_imbalance_rule)
    from repro_torch.runtime import KernelService, Request, ServiceConfig
    from repro_torch.runtime.autotune import Autotuner

    rng = np.random.default_rng(seed + 97)
    reqs = []
    for n in DTW_LENGTHS:
        for _ in range(4):
            walk = np.cumsum(rng.normal(size=(2, n)), axis=1)
            reqs.append(Request("dtw", {"s": walk[0].astype(np.float32),
                                        "r": walk[1].astype(np.float32)}))
    times = {}

    def make_thunk(tile):
        svc = KernelService(ServiceConfig(seq_bucket=SERVICE_SEQ,
                                          dtw_tile=int(tile),
                                          sw_tile=int(tile)), device=dev)

        def thunk():
            t0 = time.perf_counter()
            got = svc.submit(reqs)
            times.setdefault(int(tile), []).append(
                (time.perf_counter() - t0) * 1e6)
            return got
        return thunk

    path = ROOT / "build" / "chip_smoke" / "autotune.json"
    path.unlink(missing_ok=True)
    tuner = Autotuner(str(path))
    tuner.tune("dtw.tile", [SERVICE_SEQ], make_thunk, force=True)
    first_us, steady = times[SERVICE_SEQ][0], times[SERVICE_SEQ][1:]
    incumbent_us = tuner._cache["dtw.tile"]["us"]
    times.clear()
    applied = []
    reg = Registry()
    ctrl = AutotuneController(tuner, "dtw.tile", list(RESWEEP_TILES),
                              make_thunk, apply=applied.append,
                              cooldown_s=3600.0, registry=reg,
                              tracer=Tracer(enabled=False))
    rule = dispatch_imbalance_rule("dtw", ratio=0.0, min_execute_ms=0.0,
                                   fire_after=1)
    slo = SLOManager([rule], registry=reg, tracer=Tracer(enabled=False))
    slo.subscribe(ctrl)
    sample = {"runtime.dispatch.bucket.dtw.compile_ms": first_us / 1e3,
              "runtime.dispatch.bucket.dtw.execute_ms": sum(steady) / 1e3}
    w0 = KT.wavefront_launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events = slo.evaluate(sample, {})
    slo.evaluate(sample, {})            # inside the cooldown: no sweep
    wall = time.perf_counter() - t0
    launches = KT.wavefront_launches - w0
    cand_us = {t: float(np.median(v[1:])) for t, v in times.items()}
    chosen = tuner.get("dtw.tile")
    improved = bool(applied)
    log(f"[obs] autotune dtw.tile: incumbent {SERVICE_SEQ} at "
        f"{incumbent_us:.1f} us per submit (first use {first_us:.1f} us); "
        f"rule events {events}; {ctrl.resweeps} re-sweep in {wall:.3f} s, "
        f"candidates (median us per submit of {len(reqs)} DTW requests) "
        f"{ {t: round(u, 1) for t, u in cand_us.items()} }; applied "
        f"{applied}; {launches} dp_wavefront launches in the re-sweep")
    check(ctrl.resweeps == 1 and events == ["dispatch_imbalance:fire"],
          f"{ctrl.resweeps} re-sweeps, events {events}")
    check(set(cand_us) == set(RESWEEP_TILES), f"candidates {cand_us}")
    if improved:
        check(applied == [chosen]
              and tuner._cache["dtw.tile"]["us"] < 0.98 * incumbent_us,
              f"applied {applied} without a measured improvement")
    else:
        check(chosen == SERVICE_SEQ, f"the knob moved to {chosen} without "
              "an improvement")
    # per candidate a warm-up submit and 3 timed ones, each one launch per
    # bucket (one bucket per DTW length)
    check(launches == len(RESWEEP_TILES) * (1 + 3) * len(DTW_LENGTHS),
          f"{launches} dp_wavefront launches in the re-sweep")
    svc = KernelService(ServiceConfig(seq_bucket=SERVICE_SEQ,
                                      dtw_tile=int(chosen),
                                      sw_tile=int(chosen)), device=dev)
    err = 0.0
    for req, res in zip(reqs, svc.submit(reqs)):
        _, d = ops.dtw_tiled(torch.as_tensor(req.payload["s"], device=dev),
                             torch.as_tensor(req.payload["r"], device=dev),
                             int(chosen), int(chosen))
        d = float(d)
        err = max(err, abs(float(res["distance"]) - d))
        check(abs(float(res["distance"]) - d) <= 1e-5 * abs(d),
              f"dtw at tile {chosen}: {float(res['distance'])} != {d}")
    log(f"[obs] service DTW at tile {chosen} against ops.dtw_tiled: max "
        f"abs diff {err}")
    return {"incumbent_tile": SERVICE_SEQ, "incumbent_us": incumbent_us,
            "first_use_us": first_us, "candidates_us": cand_us,
            "chosen": int(chosen), "improved": improved,
            "resweeps": ctrl.resweeps, "resweep_wall_s": wall,
            "dp_wavefront_launches": launches, "max_abs_err": err}


def paged_rwkv(params, cfg, dev, seed, streams, counter) -> dict:
    """RWKV-6 in fp32 through the paged scheduler: no KV, so zero
    page-table groups and every leaf dense; the streams against the
    contiguous run's under stream_gate, and ssm_scan launched once per
    layer per chunk step."""
    import numpy as np
    prompts, mnts = sched_requests(cfg.vocab, seed)
    done, st, wall, launches = paged_run(params, cfg, prompts, mnts,
                                         counter)
    exact, ties = stream_gate(params, cfg, dev, prompts, mnts, done,
                              [np.asarray(x, np.int32) for x in streams],
                              "paged RWKV against contiguous")
    log(f"[paged] {cfg.name} fp32 paged (zero groups): {wall:.2f} s, "
        f"{exact} of {SCHED_REQS} streams equal the contiguous run's, "
        f"near-ties {ties}; {launches} ssm_scan launches over "
        f"{st['chunk_steps']} chunk steps; {paged_stats(st)}")
    check(st["page_groups"] == 0, "RWKV paged with page-table groups")
    check(launches == cfg.num_layers * st["chunk_steps"] > 0,
          f"ssm_scan launched {launches} times in the paged run, expected "
          f"{cfg.num_layers} per chunk step x {st['chunk_steps']}")
    return {"wall_s": wall, "exact_streams": exact, "near_ties": ties,
            "launches": launches, **paged_stats(st)}


# --------------------------------------------------------------------------
# phase 7b: the sharded paged pool (SchedulerConfig(mesh_shards=n)) on the
# paged sub-phases' trace: gemma-2b's fp32 weights at 1 shard (with and
# without a worker mesh of the one card, bitwise the unsharded equal-memory
# run), 2 and 4 shards (the equal-memory pool of SHARD_BLOCKS blocks split
# evenly), a skewed arm (every request placed on shard 0: steals) and a
# swap arm (the first two requests on shard 0, whose pool they fill
# exactly: decode growth swaps the younger out, and the steal pass
# migrates its swap entry to idle shard 1); the bf16 weights at 2 shards
# with speculate=3 and in one pair (2 shards against the unsharded pool);
# RWKV-6 in fp32 at 2 shards. With no EOS the bookkeeping (placements,
# steals, swaps, migrations) does not depend on the model, so the counts
# were planned on the CPU with a reduced model.
# --------------------------------------------------------------------------

SHARD_BLOCKS = SCHED_SLOTS * SCHED_MAX_LEN // PAGED_BLOCK     # 576
SHARD_COUNTS = (2, 4)
SHARD_CONTROL = ("admitted", "preempted", "chunk_steps", "decode_steps",
                 "prefill_tokens", "generated_tokens", "steps")


def shard_run(params, cfg, prompts, mnts, counter, n, mesh=None,
              placement=None, first=SCHED_SLOTS, **kw):
    """One drive_scheduler run of an n-shard paged pool (``kw`` over
    sched_config; per-shard blocks SHARD_BLOCKS / n unless given),
    ``placement`` as its placement_fn, the launch count at 0 just before
    and read just after: (completions, numbers). The ``serve.shard``
    snapshot must pass validate_shard_metrics."""
    import torch
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import schema
    from repro_torch.serve import Scheduler
    kw.setdefault("num_blocks", SHARD_BLOCKS // n)
    sched = Scheduler(cfg, params, sched_config(
        allocator="paged", block_size=PAGED_BLOCK, mesh_shards=n, **kw),
        mesh=mesh)
    sched.placement_fn = placement
    torch.cuda.synchronize()
    counter.launches = 0
    t0 = time.perf_counter()
    done = drive_scheduler(sched, prompts, mnts, first=first)
    wall = time.perf_counter() - t0
    launches = counter.launches
    st = sched.stats()
    shard = sched._shard_obs.metrics()
    problems = schema.validate_shard_metrics(shard, n)
    check(problems == [], f"serve.shard at {n} shards: {problems}")
    snap = obs_metrics.REGISTRY.snapshot()
    check(snap.get("serve.shard.num_shards") == n,
          f"serve.shard is not the registry's provider at {n} shards")
    check(st["blocks_used"] == 0, f"{n} shards: {st['blocks_used']} blocks "
          "still used after the trace")
    out = {"shards": n, "mesh": mesh is not None, "wall_s": wall,
           "launches": launches, "placed": list(sched._shard_placed),
           "shard_steals": list(sched._shard_steals),
           **{k: int(st[k]) for k in SHARD_CONTROL + ("steals",)},
           **paged_stats(st), "swap_migrated_out": st["swap_migrated_out"],
           "swap_migrated_in": st["swap_migrated_in"], "serve_shard": shard}
    del sched
    return done, out


def sharded_fp32(params, cfg, dev, seed, equal, counter) -> dict:
    """The fp32 gemma-2b weights through the sharded pool, against the
    unsharded equal-memory paged run ``equal`` = (completions, stats) of
    paged_fp32: 1 shard bitwise (streams, reasons, control counters),
    without and with make_worker_mesh(1); 2 and 4 shards, the skewed and
    the swap arm under stream_gate; no flash_attention launch anywhere."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_worker_mesh
    t_all = time.perf_counter()
    prompts, mnts = sched_requests(cfg.vocab, seed)
    base_done, base_st = equal
    want = [base_done[i].tokens for i in range(SCHED_REQS)]
    out = {"blocks": SHARD_BLOCKS}

    def note(name, r, exact=None, ties=None):
        log(f"[shard] {cfg.name} fp32 {name}: {r['wall_s']:.2f} s, "
            f"placed {r['placed']}, steals to {r['shard_steals']}, "
            f"{r['decode_steps']} decode ticks, {r['chunk_steps']} chunk "
            f"steps, preempted {r['preempted']}, swapped out "
            f"{r['swapped_out']}, migrated {r['swap_migrated_out']}/"
            f"{r['swap_migrated_in']}, {r['launches']} "
            f"{counter.__name__.split('.')[-1]} launches"
            + ("" if exact is None else
               f"; {exact} streams equal the unsharded run's, near-ties "
               f"{ties}"))
        check(r["launches"] == 0, f"{name}: {r['launches']} launches, "
              "expected 0 (chunks and decode attend over the views)")

    for name, mesh in (("1 shard", None),
                       ("1 shard on make_worker_mesh(1)",
                        make_worker_mesh(1, axis="slots"))):
        done, r = shard_run(params, cfg, prompts, mnts, counter, 1,
                            mesh=mesh)
        same = all(np.array_equal(done[i].tokens, want[i])
                   and done[i].reason == base_done[i].reason
                   for i in range(SCHED_REQS))
        control = {k: (r[k], int(base_st[k])) for k in SHARD_CONTROL}
        r["bitwise"] = same
        note(name, r)
        log(f"[shard] {name}: streams bitwise the unsharded run's: {same}; "
            f"control counters (sharded, unsharded) {control}")
        check(same, f"{name}: streams differ from the unsharded paged run")
        check(all(a == b for a, b in control.values()),
              f"{name}: control counters differ {control}")
        out["mesh1" if mesh else "shard1"] = r
    for n in SHARD_COUNTS:
        done, r = shard_run(params, cfg, prompts, mnts, counter, n)
        r["exact_streams"], r["near_ties"] = stream_gate(
            params, cfg, dev, prompts, mnts, done, want,
            f"{n} shards against unsharded")
        note(f"{n} shards", r, r["exact_streams"], r["near_ties"])
        out[f"shards{n}"] = r
    pin = lambda sched, st: 0       # noqa: E731 (every arrival on shard 0)
    done, r = shard_run(params, cfg, prompts, mnts, counter, 2,
                        placement=pin)
    r["exact_streams"], r["near_ties"] = stream_gate(
        params, cfg, dev, prompts, mnts, done, want, "skewed 2 shards")
    note("2 shards, skewed onto shard 0", r, r["exact_streams"],
         r["near_ties"])
    check(r["shard_steals"][1] >= 1,
          f"skewed arm: no steal to shard 1 ({r['shard_steals']})")
    out["skewed"] = r
    tight = sum(-(-len(p) // PAGED_BLOCK) for p in prompts[:2])
    done, r = shard_run(params, cfg, prompts[:2], mnts[:2], counter, 2,
                        placement=pin, first=2, num_blocks=tight,
                        preempt="swap")
    r["exact_streams"], r["near_ties"] = stream_gate(
        params, cfg, dev, prompts[:2], mnts[:2], done, want[:2],
        "swap arm, 2 shards")
    note(f"2 shards, {tight} blocks each, swap, skewed", r,
         r["exact_streams"], r["near_ties"])
    check(r["swapped_out"] >= 1 and r["swapped_in"] == r["swapped_out"]
          and r["recomputed_decode_steps"] == 0,
          f"swap arm: swapped out {r['swapped_out']}, in {r['swapped_in']}, "
          f"recomputed {r['recomputed_decode_steps']}")
    check(r["swap_migrated_in"] == r["swap_migrated_out"] >= 1,
          f"swap arm: migrations out {r['swap_migrated_out']}, in "
          f"{r['swap_migrated_in']}")
    out["swap"] = r
    out["wall_s"] = time.perf_counter() - t_all
    log(f"[shard] gemma-2b fp32 sharded arms took {out['wall_s']:.1f} s")
    torch.cuda.empty_cache()
    return out


def sharded_bf16(params, cfg, dev, seed, spec, counter) -> dict:
    """The bf16 gemma-2b weights: speculate=SPEC_K over 2 shards against
    spec_gemma2b's unsharded paged speculative streams (``spec``), and one
    pair, the unsharded paged pool and 2 shards at speculate=0 (tok/s, ITL
    p50, decode ticks, host syncs a tick, the card's busy share over
    SCHED_PROFILE_STEPS), the 2-shard streams gated against the unsharded
    ones."""
    import torch
    t_all = time.perf_counter()
    prompts, mnts = sched_requests(cfg.vocab, seed)
    kw = dict(allocator="paged", block_size=PAGED_BLOCK)
    out = {}
    done, r = spec_arm(params, cfg, prompts, mnts, counter, SPEC_K,
                       mesh_shards=2, num_blocks=SPEC_BLOCKS // 2, **kw)
    r["exact_streams"], r["near_ties"] = stream_gate(
        params, cfg, dev, prompts, mnts, done, spec["paged"]["streams"],
        f"2 shards speculate={SPEC_K} against unsharded",
        rtol=BF16_TIE_RTOL)
    check(r["launches"] == 0, f"2-shard speculation: {r['launches']} "
          "launches, expected 0")
    log(f"[shard] {cfg.name} bf16 speculate={SPEC_K} over 2 shards: "
        f"{r['tok_s']:.1f} tok/s, {r['decode_steps']} verify ticks, "
        f"acceptance {r['acceptance']}; {r['exact_streams']} of "
        f"{len(prompts)} streams equal the unsharded speculative run's, "
        f"near-ties {r['near_ties']}")
    out["spec2"] = r
    runs = {}
    for name, extra in (("unsharded", dict(num_blocks=SPEC_BLOCKS)),
                        ("shards2", dict(mesh_shards=2,
                                         num_blocks=SPEC_BLOCKS // 2))):
        runs[name] = spec_arm(params, cfg, prompts, mnts, counter, 0,
                              window=SCHED_PROFILE_STEPS, **kw, **extra)
        r = runs[name][1]
        log(f"[shard] {cfg.name} bf16 pair, {name}: {r['tok_s']:.2f} tok/s, "
            f"ITL p50 {r['itl_ms_p50']:.2f} ms, TTFT p50 "
            f"{r['ttft_ms_p50']:.1f} ms, {r['decode_steps']} decode ticks, "
            f"{r['host_syncs_per_decode_tick']:.2f} host syncs a tick, "
            f"busy share {r['busy_share']} over steps "
            f"{SCHED_PROFILE_STEPS}")
        check(r["launches"] == 0, f"bf16 pair {name}: {r['launches']} "
              "launches, expected 0")
        out[name] = r
    exact, ties = stream_gate(
        params, cfg, dev, prompts, mnts, runs["shards2"][0],
        [runs["unsharded"][0][i].tokens for i in range(len(prompts))],
        "bf16 2 shards against unsharded", rtol=BF16_TIE_RTOL)
    out["pair_exact_streams"], out["pair_near_ties"] = exact, ties
    out["pair_tok_s_ratio"] = (out["shards2"]["tok_s"]
                               / out["unsharded"]["tok_s"])
    out["wall_s"] = time.perf_counter() - t_all
    log(f"[shard] gemma-2b bf16 pair: {exact} of {len(prompts)} streams "
        f"equal, near-ties {ties}; tok/s 2 shards / unsharded "
        f"{out['pair_tok_s_ratio']:.4f}; the bf16 sharded arms took "
        f"{out['wall_s']:.1f} s")
    torch.cuda.empty_cache()
    return out


def sharded_rwkv(params, cfg, dev, seed, streams, counter) -> dict:
    """RWKV-6 in fp32 over 2 shards (zero page-table groups: every leaf
    dense, stacked), against the contiguous streams under stream_gate,
    ssm_scan launched once per layer per chunk step as unsharded."""
    import numpy as np
    prompts, mnts = sched_requests(cfg.vocab, seed)
    done, r = shard_run(params, cfg, prompts, mnts, counter, 2)
    r["exact_streams"], r["near_ties"] = stream_gate(
        params, cfg, dev, prompts, mnts, done,
        [np.asarray(x, np.int32) for x in streams],
        "RWKV 2 shards against contiguous")
    log(f"[shard] {cfg.name} fp32 2 shards (zero groups): "
        f"{r['wall_s']:.2f} s, placed {r['placed']}, steals to "
        f"{r['shard_steals']}; "
        f"{r['exact_streams']} of {SCHED_REQS} streams equal the contiguous "
        f"run's, near-ties {r['near_ties']}; {r['launches']} ssm_scan "
        f"launches over {r['chunk_steps']} chunk steps")
    check(r["page_groups"] == 0, "sharded RWKV with page-table groups")
    check(r["launches"] == cfg.num_layers * r["chunk_steps"] > 0,
          f"ssm_scan launched {r['launches']} times over 2 shards, "
          f"expected {cfg.num_layers} per chunk step x {r['chunk_steps']}")
    return r


def lm_kernel_vs_plain(dev, seed) -> dict:
    """The full-width model in fp32, one prefill of 4 prompts of 2,048
    tokens with the WKV-scan kernel and with its plain version: last
    logits and every cache leaf within ON_OFF_RTOL of the tensor's largest
    magnitude, and the same greedy first tokens."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ssm_scan as KS
    from repro_torch.models import transformer as TT
    from repro_torch.serve import engine

    cfg = dataclasses.replace(configs.get_config(LM_ARCH),
                              dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    t0 = time.perf_counter()
    params = TT.init_model(cfg, g, dev)
    perturb_decay(params, g)
    torch.cuda.synchronize()
    n = TT.param_count(params)
    log(f"[lm] {cfg.name} fp32: {n} parameters drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    check(n == LM_PARAMS, f"{cfg.name} has {n} parameters, not {LM_PARAMS}")
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=g,
                           device=dev)
    share = decay_share_below_clamp(params, cfg, tokens)
    log(f"[lm] share of layer 0's decays below e^-1: {share:.4f}")
    check(0.0 < share < 1.0, "the decays do not reach both sides of e^-1")

    runs = {}
    for use in (True, False):
        KS.launches = 0
        step = engine.make_prefill_step(cfg, 0, use_kernels=use)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        runs[use] = (logits, caches, (time.perf_counter() - t0) * 1e3,
                     KS.launches)
    (lg_on, c_on, ms_on, n_on), (lg_off, c_off, ms_off, n_off) = \
        runs[True], runs[False]
    check(n_on == cfg.num_layers and n_off == 0,
          f"ssm_scan launched {n_on} (kernels on) and {n_off} (off) times, "
          f"expected {cfg.num_layers} and 0")
    check(bool(torch.isfinite(lg_on).all()), "non-finite fp32 logits")
    scale = float(lg_off.abs().max())
    err = float((lg_on - lg_off).abs().max())
    log(f"[lm] fp32 prefill {tuple(tokens.shape)}: kernels on {ms_on:.1f} ms "
        f"({n_on} ssm_scan launches), off {ms_off:.1f} ms; last logits "
        f"max_abs_err {err} of max |logit| {scale:.4f}")
    check(err <= ON_OFF_RTOL * scale,
          f"fp32 logits kernels on/off differ by {err} > {ON_OFF_RTOL} * "
          f"{scale}")
    cache_rel = 0.0
    for (path, a), (_, b) in zip(tree_leaves(c_on), tree_leaves(c_off)):
        e, m = float((a - b).abs().max()), float(b.abs().max())
        cache_rel = max(cache_rel, e / m if m else e)
        log(f"[lm] cache {path} {tuple(a.shape)}: max_abs_err {e} of max "
            f"{m:.4f}")
        check(e <= ON_OFF_RTOL * m, f"cache leaf {path} kernels on/off "
              f"differs by {e} > {ON_OFF_RTOL} * {m}")
    first_on = torch.argmax(lg_on[:, -1], dim=-1)
    first_off = torch.argmax(lg_off[:, -1], dim=-1)
    check(torch.equal(first_on, first_off),
          f"greedy first tokens differ: {first_on.tolist()} vs "
          f"{first_off.tolist()}")
    log(f"[lm] greedy first tokens equal: {first_on.tolist()}")
    del runs, lg_on, c_on, lg_off, c_off
    gvp = generate_vs_prefill(params, cfg, dev, seed, GVP_RTOL["rwkv"])
    sched = scheduler_fp32(params, cfg, dev, seed, GVP_RTOL["rwkv"], KS,
                           gate_forward=False)
    paged = paged_rwkv(params, cfg, dev, seed, sched["streams"], KS)
    sharded = sharded_rwkv(params, cfg, dev, seed, sched["streams"], KS)
    del params
    torch.cuda.empty_cache()
    return {"logits_max_abs_err": err, "logits_max_abs": scale,
            "cache_max_rel_err": cache_rel, "decay_share_below_clamp": share,
            "prefill_ms_kernel": ms_on, "prefill_ms_plain": ms_off,
            "generate_vs_prefill": gvp, "scheduler": sched, "paged": paged,
            "sharded": sharded}


def profiled(fn):
    """fn() under torch.profiler (CUDA activity), ended by a synchronize:
    (wall us, device spans)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    return wall, device_spans(prof)


def lm_serving(dev, seed) -> dict:
    """bf16 serving at full width through the entry points: launch.serve's
    main path, then engine.generate for two ragged prompts with chunked
    prefill. Each path is driven with the launch count at 0 and read just
    after; then warm timings and profiles of a prefill and a decode loop."""
    import numpy as np
    import torch
    from repro_torch.kernels import ssm_scan as KS
    from repro_torch.launch import serve
    from repro_torch.models import transformer as TT
    from repro_torch.serve import engine

    argv = ["--arch", LM_ARCH, "--full", "--batch", str(LM_BATCH),
            "--prompt-len", str(LM_PROMPT), "--gen", str(LM_GEN),
            "--seed", str(seed)]
    torch.cuda.synchronize()
    KS.launches = 0
    res = serve.run(argv)
    serve_launches = KS.launches
    cfg, params = res["cfg"], res["params"]
    n = TT.param_count(params)
    log(f"[lm] launch.serve {' '.join(argv)}: {n} parameters, dtype "
        f"{cfg.dtype}, {serve_launches} ssm_scan launches")
    check(n == LM_PARAMS, f"launch.serve's model has {n} parameters")
    check(serve_launches == cfg.num_layers,
          f"ssm_scan launched {serve_launches} times in one prefill, "
          f"expected {cfg.num_layers}")
    gen = res["generated"]
    check(tuple(gen.shape) == (LM_BATCH, LM_GEN)
          and bool(((gen >= 0) & (gen < cfg.vocab)).all()),
          f"generated tokens {tuple(gen.shape)} out of shape or range")
    check(bool(torch.isfinite(res["logits"]).all()), "non-finite logits")
    steps = res["decode_steps"]
    out = {"arch": LM_ARCH, "params": n,
           "dtype": str(cfg.dtype).replace("torch.", ""),
           "batch": LM_BATCH, "prompt_len": LM_PROMPT, "gen": LM_GEN,
           "prefill_ms_first_call": res["prefill_ms"],
           "decode_ms_per_step": res["decode_ms"] / steps,
           "decode_tok_s": LM_BATCH * steps / (res["decode_ms"] / 1e3)}

    g = torch.Generator(device=dev).manual_seed(seed + 20)
    prompts = [torch.randint(0, cfg.vocab, (ln,), generator=g, device=dev)
               for ln in GEN_PROMPTS]
    chunks = sum((ln - 1) // GEN_CHUNK for ln in GEN_PROMPTS)
    torch.cuda.synchronize()
    KS.launches = 0
    gen_ms, streams = [], []
    for p in prompts:
        t0 = time.perf_counter()
        toks, reason = engine.generate(params, cfg, p.cpu().numpy(), GEN_NEW,
                                       prefill_chunk=GEN_CHUNK)
        torch.cuda.synchronize()
        gen_ms.append((time.perf_counter() - t0) * 1e3)
        streams.append(toks)
        check(toks.shape == (GEN_NEW,) and reason == "length"
              and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"generate returned {toks} ({reason})")
    gen_launches = KS.launches
    log(f"[lm] generate prompts {GEN_PROMPTS}, prefill_chunk {GEN_CHUNK}, "
        f"{GEN_NEW} new tokens: {[round(x, 3) for x in gen_ms]} ms per "
        f"request; {gen_launches} ssm_scan launches ({chunks} chunks)")
    check(gen_launches == cfg.num_layers * chunks,
          f"ssm_scan launched {gen_launches} times in generate, expected "
          f"{cfg.num_layers} per chunk x {chunks}")
    out.update({"generate_prompts": list(GEN_PROMPTS),
                "generate_chunk": GEN_CHUNK, "generate_new": GEN_NEW,
                "generate_ms": gen_ms,
                "launches": {"serve": serve_launches,
                             "generate": gen_launches}})

    # a whole-prompt prefill + decode per request: another chunk policy,
    # so agreement is reported, not required (fp32 sums reassociate)
    prefill1 = engine.make_prefill_step(cfg, 0)
    decode = engine.make_decode_step(cfg)
    agree = []
    for p, got in zip(prompts, streams):
        lg, c = prefill1(params, {"tokens": p[None]})
        tok = engine.sample_token(lg)
        seq = [tok]
        for i in range(GEN_NEW - 1):
            tok, lg, c = decode(params, c, {"tokens": tok[:, None]},
                                len(p) + i)
            seq.append(tok)
        agree.append(int(np.sum(torch.cat(seq).cpu().numpy() == got)))
    log(f"[lm] generate vs one prefill + decode per request: {agree} of "
        f"{GEN_NEW} tokens agree (not gated)")
    out["generate_vs_prefill_decode_agree"] = agree

    # warm timings and the card's busy share
    prefill = engine.make_prefill_step(cfg, 0)
    batch = {"tokens": res["prompts"]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, caches = prefill(params, batch)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    wall, spans = profiled(lambda: prefill(params, batch))
    scans = [e - s for s, e, name in spans if "ssm_scan_kernel" in name]
    tok = res["generated"][:, -1]

    def decode_loop():
        nonlocal caches, tok
        for i in range(DECODE_PROFILE_STEPS):
            tok, _, caches = decode(params, caches, {"tokens": tok[:, None]},
                                    LM_PROMPT + i)
    dwall, dspans = profiled(decode_loop)
    out.update({
        "prefill_ms": warm_ms,
        "prefill_tok_s": LM_BATCH * LM_PROMPT / (warm_ms / 1e3),
        "prefill_busy_share": busy_us(spans) / wall if spans else None,
        "ssm_scan_device_us": statistics.mean(scans) if scans else None,
        "ssm_scan_device_us_per_prefill": sum(scans) if scans else None,
        "decode_busy_share": busy_us(dspans) / dwall if dspans else None,
        "decode_profiled_ms_per_step": dwall / 1e3 / DECODE_PROFILE_STEPS})
    sched = scheduler_bf16(params, cfg, dev, seed, KS)
    for admit in ("continuous", "static"):
        n_chunks = sched[admit]["chunk_steps"]
        check(sched[admit]["launches"] == cfg.num_layers * n_chunks > 0,
              f"ssm_scan launched {sched[admit]['launches']} times in the "
              f"{admit} scheduler run, expected {cfg.num_layers} per chunk "
              f"step x {n_chunks}")
    out["scheduler"] = sched
    out["launches"]["scheduler"] = sched["continuous"]["launches"]
    log(f"[lm] bf16 prefill {LM_BATCH}x{LM_PROMPT}: first call "
        f"{res['prefill_ms']:.1f} ms, warm {warm_ms:.1f} ms "
        f"({out['prefill_tok_s']:.0f} tok/s); under the profiler "
        f"{wall / 1e3:.1f} ms, card busy {out['prefill_busy_share']}, "
        f"{len(scans)} ssm_scan launches of {out['ssm_scan_device_us']} us "
        f"device time")
    log(f"[lm] bf16 decode batch {LM_BATCH}: {out['decode_ms_per_step']:.3f} "
        f"ms per step ({out['decode_tok_s']:.1f} tok/s) in launch.serve; "
        f"{DECODE_PROFILE_STEPS} steps under the profiler "
        f"{out['decode_profiled_ms_per_step']:.3f} ms per step, card busy "
        f"{out['decode_busy_share']}")
    del params, caches, res
    torch.cuda.empty_cache()
    return out


def ssm_scan_entry(dev, errs, lm) -> dict:
    """Times of ssm_scan at the prefill shape beside its bound, its plain
    version and the chunked torch form (core.linear_attn.wkv_chunked)."""
    import torch
    from repro_torch.core import linear_attn as TLA
    from repro_torch.kernels import ssm_scan as KS

    b, t, dk, dv = SCAN_SHAPES[0]
    g = torch.Generator(device=dev).manual_seed(8)
    r, w, k, v, _, _ = wkv_inputs(b, t, dk, dv, g, dev, False)
    ms = time_cuda(lambda: KS.ssm_scan(r, w, k, v), reps=20)
    plain = time_cuda(lambda: KS.ssm_scan_plain(r, w, k, v), reps=1,
                      rounds=3)
    chunked = time_cuda(lambda: TLA.wkv_chunked(r, w, k, v, None), reps=5)
    # r, w, k, v read once; y and the final state written once; per step
    # and state element a multiply-add for the decay and the k v product,
    # and a multiply-add for the readout
    n_bytes = 4 * (b * t * (3 * dk + dv) + b * t * dv + b * dk * dv)
    b_ms, b_by = bound(n_bytes, 5 * b * t * dk * dv)
    log(f"[time] ssm_scan {SCAN_SHAPES[0]}: kernel {ms:.4f} ms, plain "
        f"{plain:.3f} ms, wkv_chunked {chunked:.4f} ms, bound {b_ms:.6f} ms "
        f"({b_by}); {ms / t * 1e6:.1f} ns per serial step; share of the "
        f"bound {b_ms / ms:.4f}")
    launches = sum(lm["launches"].values())
    return {"name": "ssm_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:58",
            "launches": launches, "max_abs_err": errs["ssm_scan"], "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": list(SCAN_SHAPES[0]),
            "ns_per_step": ms / t * 1e6, "bound_share": b_ms / ms,
            "chunked_torch_ms": chunked,
            "device_us": lm["ssm_scan_device_us"]}


# --------------------------------------------------------------------------
# phase 7: the attention LM, gemma-2b at full width
# --------------------------------------------------------------------------

ATTN_ARCH = "gemma-2b"
ATTN_PARAMS = 2_506_172_416   # jax.eval_shape of the reference's init_model


def bf16_ulp(x):
    """One bf16 ulp at each value's magnitude (8 significant bits)."""
    import torch
    mag = torch.clamp_min(x.abs(), 1e-30)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def attn_kernel_vs_plain(dev, seed) -> dict:
    """gemma-2b at full width in fp32: one prefill of 4 prompts of 2,048
    tokens with flash_attention and with the plain blockwise_attention
    (use_kernels=False). Last logits within ON_OFF_RTOL of the largest, the
    same greedy first tokens, cache positions equal, and every bf16 cache
    value within one bf16 ulp plus ON_OFF_RTOL of the leaf's largest value
    (the fp32 k and v before rounding agree to about 1e-5 after 18 layers,
    so a value on a rounding boundary may round the other way). Then the
    same weights through generate's chunk path against one prefill."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.models import transformer as TT
    from repro_torch.serve import engine

    cfg = dataclasses.replace(configs.get_config(ATTN_ARCH),
                              dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(seed + 40)
    t0 = time.perf_counter()
    params = TT.init_model(cfg, g, dev)
    torch.cuda.synchronize()
    n = TT.param_count(params)
    log(f"[attn] {cfg.name} fp32: {n} parameters drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    check(n == ATTN_PARAMS, f"{cfg.name} has {n} parameters, not "
          f"{ATTN_PARAMS}")
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=g,
                           device=dev)
    runs = {}
    for use in (True, False):
        step = engine.make_prefill_step(cfg, LM_PROMPT + LM_GEN,
                                        use_kernels=use)
        torch.cuda.synchronize()
        KF.launches = 0
        t0 = time.perf_counter()
        logits, caches = step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        runs[use] = (logits, caches, (time.perf_counter() - t0) * 1e3,
                     KF.launches)
    (lg_on, c_on, ms_on, n_on), (lg_off, c_off, ms_off, n_off) = \
        runs[True], runs[False]
    check(n_on == cfg.num_layers and n_off == 0,
          f"flash_attention launched {n_on} (kernels on) and {n_off} (off) "
          f"times, expected {cfg.num_layers} and 0")
    check(bool(torch.isfinite(lg_on).all()), "non-finite fp32 logits")
    scale = float(lg_off.abs().max())
    err = float((lg_on - lg_off).abs().max())
    log(f"[attn] fp32 prefill {tuple(tokens.shape)}: kernel {ms_on:.1f} ms "
        f"({n_on} flash_attention launches), blockwise {ms_off:.1f} ms; last "
        f"logits max_abs_err {err} of max |logit| {scale:.4f}")
    check(err <= ON_OFF_RTOL * scale, f"fp32 logits kernel/blockwise differ "
          f"by {err} > {ON_OFF_RTOL} * {scale}")
    a, b = c_on["p0"]["attn"], c_off["p0"]["attn"]
    check(torch.equal(a.pos, b.pos), "cache positions differ")
    cache = {}
    for name in ("k", "v"):
        x, y = getattr(a, name).float(), getattr(b, name).float()
        m = float(y.abs().max())
        diff = (x - y).abs()
        ok = bool((diff <= bf16_ulp(torch.maximum(x.abs(), y.abs()))
                   + ON_OFF_RTOL * m).all())
        share = float((diff > 0).float().mean())
        cache[name] = {"max_abs_err": float(diff.max()), "max_abs": m,
                       "share_differing": share}
        log(f"[attn] cache {name} {tuple(x.shape)} bf16: max_abs_err "
            f"{float(diff.max())} of max {m:.4f}, {share:.6f} of the values "
            f"differ; within one bf16 ulp + {ON_OFF_RTOL} * max: {ok}")
        check(ok, f"cache leaf {name} kernel/blockwise differs beyond one "
              f"bf16 ulp + {ON_OFF_RTOL} * {m}")
    first_on = torch.argmax(lg_on[:, -1], dim=-1)
    first_off = torch.argmax(lg_off[:, -1], dim=-1)
    check(torch.equal(first_on, first_off),
          f"greedy first tokens differ: {first_on.tolist()} vs "
          f"{first_off.tolist()}")
    log(f"[attn] greedy first tokens equal: {first_on.tolist()}")
    del runs, lg_on, c_on, lg_off, c_off, a, b
    torch.cuda.empty_cache()
    gvp = generate_vs_prefill(params, cfg, dev, seed, GVP_RTOL["attn"])
    with timed("gemma-2b fp32 scheduler"):
        sched = scheduler_fp32(params, cfg, dev, seed, GVP_RTOL["attn"], KF,
                               gate_forward=True)
    with timed("gemma-2b fp32 paged arms"):
        paged, equal = paged_fp32(params, cfg, dev, seed, sched["streams"],
                                  KF)
    sharded = sharded_fp32(params, cfg, dev, seed, equal, KF)
    del params, equal
    torch.cuda.empty_cache()
    return {"logits_max_abs_err": err, "logits_max_abs": scale,
            "cache": cache, "launches": {"kernel": n_on, "blockwise": n_off},
            "prefill_ms_kernel": ms_on, "prefill_ms_blockwise": ms_off,
            "generate_vs_prefill": gvp, "scheduler": sched, "paged": paged,
            "sharded": sharded}


def attn_serving(dev, seed) -> dict:
    """bf16 serving of gemma-2b at full width through the entry points:
    launch.serve's main path, then engine.generate for two ragged prompts
    with chunked prefill, each driven with the flash_attention count at 0
    and read just after; then a warm prefill and a decode loop under the
    profiler."""
    import torch
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.launch import serve
    from repro_torch.models import transformer as TT
    from repro_torch.serve import engine

    argv = ["--arch", ATTN_ARCH, "--full", "--batch", str(LM_BATCH),
            "--prompt-len", str(LM_PROMPT), "--gen", str(LM_GEN),
            "--seed", str(seed)]
    torch.cuda.synchronize()
    KF.launches = 0
    res = serve.run(argv)
    serve_launches = KF.launches
    cfg, params = res["cfg"], res["params"]
    n = TT.param_count(params)
    log(f"[attn] launch.serve {' '.join(argv)}: {n} parameters, dtype "
        f"{cfg.dtype}, {serve_launches} flash_attention launches")
    check(n == ATTN_PARAMS, f"launch.serve's model has {n} parameters")
    check(serve_launches == cfg.num_layers,
          f"flash_attention launched {serve_launches} times in one prefill, "
          f"expected {cfg.num_layers}")
    gen = res["generated"]
    check(tuple(gen.shape) == (LM_BATCH, LM_GEN)
          and bool(((gen >= 0) & (gen < cfg.vocab)).all()),
          f"generated tokens {tuple(gen.shape)} out of shape or range")
    check(bool(torch.isfinite(res["logits"]).all()), "non-finite logits")
    steps = res["decode_steps"]
    out = {"arch": ATTN_ARCH, "params": n,
           "dtype": str(cfg.dtype).replace("torch.", ""),
           "batch": LM_BATCH, "prompt_len": LM_PROMPT, "gen": LM_GEN,
           "prefill_ms_first_call": res["prefill_ms"],
           "decode_ms_per_step": res["decode_ms"] / steps,
           "decode_tok_s": LM_BATCH * steps / (res["decode_ms"] / 1e3)}

    g = torch.Generator(device=dev).manual_seed(seed + 50)
    prompts = [torch.randint(0, cfg.vocab, (ln,), generator=g, device=dev)
               for ln in GEN_PROMPTS]
    torch.cuda.synchronize()
    KF.launches = 0
    gen_ms = []
    for p in prompts:
        t0 = time.perf_counter()
        toks, reason = engine.generate(params, cfg, p.cpu().numpy(), GEN_NEW,
                                       prefill_chunk=GEN_CHUNK)
        torch.cuda.synchronize()
        gen_ms.append((time.perf_counter() - t0) * 1e3)
        check(toks.shape == (GEN_NEW,) and reason == "length"
              and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"generate returned {toks} ({reason})")
    gen_launches = KF.launches
    log(f"[attn] generate prompts {GEN_PROMPTS}, prefill_chunk {GEN_CHUNK}, "
        f"{GEN_NEW} new tokens: {[round(x, 3) for x in gen_ms]} ms per "
        f"request; {gen_launches} flash_attention launches (chunks and "
        f"decode steps attend over the cache with blockwise_attention)")
    check(gen_launches == 0, f"flash_attention launched {gen_launches} "
          "times in generate, expected 0")
    out.update({"generate_prompts": list(GEN_PROMPTS),
                "generate_chunk": GEN_CHUNK, "generate_new": GEN_NEW,
                "generate_ms": gen_ms,
                "launches": {"serve": serve_launches,
                             "generate": gen_launches}})

    prefill = engine.make_prefill_step(cfg, LM_PROMPT + LM_GEN)
    decode = engine.make_decode_step(cfg)
    batch = {"tokens": res["prompts"]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg_on, caches = prefill(params, batch)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    wall, spans = profiled(lambda: prefill(params, batch))
    flash = [e - s for s, e, name in spans
             if "flash_attention_tc_kernel" in name]

    # the same bf16 prefill with the plain blockwise_attention: reported,
    # not gated (in bf16 the two round p and the attention output at other
    # places, and 18 layers carry that on)
    lg_off, _ = engine.make_prefill_step(
        cfg, LM_PROMPT + LM_GEN, use_kernels=False)(params, batch)
    last_on, last_off = lg_on[:, -1].float(), lg_off[:, -1].float()
    scale = float(last_off.abs().max())
    err = float((last_on - last_off).abs().max())
    same_first = torch.equal(torch.argmax(last_on, -1),
                             torch.argmax(last_off, -1))
    out["bf16_kernel_vs_blockwise"] = {
        "last_logits_max_abs_err": err, "max_abs_logit": scale,
        "rel_err": err / scale, "first_tokens_equal": same_first}
    log(f"[attn] bf16 prefill, flash_attention against blockwise_attention "
        f"(not gated): last logits max_abs_err {err} of max |logit| "
        f"{scale:.4f} ({err / scale:.3e} relative); greedy first tokens "
        f"equal: {same_first}")
    del lg_on, lg_off, last_on, last_off
    tok = res["generated"][:, -1]

    def decode_loop():
        nonlocal caches, tok
        for i in range(DECODE_PROFILE_STEPS):
            tok, _, caches = decode(params, caches, {"tokens": tok[:, None]},
                                    LM_PROMPT + i)
    dwall, dspans = profiled(decode_loop)
    out.update({
        "prefill_ms": warm_ms,
        "prefill_tok_s": LM_BATCH * LM_PROMPT / (warm_ms / 1e3),
        "prefill_busy_share": busy_us(spans) / wall if spans else None,
        "flash_device_us": statistics.mean(flash) if flash else None,
        "flash_device_us_per_prefill": sum(flash) if flash else None,
        "decode_busy_share": busy_us(dspans) / dwall if dspans else None,
        "decode_profiled_ms_per_step": dwall / 1e3 / DECODE_PROFILE_STEPS})
    log(f"[attn] bf16 prefill {LM_BATCH}x{LM_PROMPT}: first call "
        f"{res['prefill_ms']:.1f} ms, warm {warm_ms:.1f} ms "
        f"({out['prefill_tok_s']:.0f} tok/s); under the profiler "
        f"{wall / 1e3:.1f} ms, card busy {out['prefill_busy_share']}, "
        f"{len(flash)} flash_attention launches of {out['flash_device_us']} "
        f"us device time")
    log(f"[attn] bf16 decode batch {LM_BATCH}: "
        f"{out['decode_ms_per_step']:.3f} ms per step "
        f"({out['decode_tok_s']:.1f} tok/s) in launch.serve; "
        f"{DECODE_PROFILE_STEPS} steps under the profiler "
        f"{out['decode_profiled_ms_per_step']:.3f} ms per step, card busy "
        f"{out['decode_busy_share']}")
    del caches
    with timed("gemma-2b bf16 scheduler"):
        sched = scheduler_bf16(params, cfg, dev, seed, KF)
    for admit in ("continuous", "static"):
        check(sched[admit]["launches"] == 0, f"flash_attention launched "
              f"{sched[admit]['launches']} times in the {admit} scheduler "
              "run, expected 0 (chunks and decode attend over the cache)")
    out["scheduler"] = sched
    out["launches"]["scheduler"] = sched["continuous"]["launches"]
    with timed("gemma-2b bf16 occupancy"):
        out["paged_occupancy"] = paged_occupancy_bf16(params, cfg, seed, KF)
    t_spec = time.perf_counter()
    out["spec"] = spec_gemma2b(params, cfg, dev, seed, KF)
    out["sharded"] = sharded_bf16(params, cfg, dev, seed, out["spec"], KF)
    with timed("gemma-2b overload"):
        out["obs_overload"] = obs_overload(params, cfg, dev, seed, KF)
    log(f"[spec] gemma-2b speculation and overload sub-phases took "
        f"{time.perf_counter() - t_spec:.1f} s")
    del params, res
    torch.cuda.empty_cache()
    return out


def flash_attention_entry(dev, errs, attn) -> dict:
    """Times of flash_attention at gemma-2b's prefill shape, in bf16 (the
    serving path's type) and fp32, beside its bound, its plain version and
    scaled_dot_product_attention (timed here only, never called by the
    port)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as KF

    shape = FLASH_SHAPES[-1]
    b, h, kvh, s, _, hd, win = shape
    g = torch.Generator(device=dev).manual_seed(11)
    pairs = b * h * s * (s + 1) // 2           # causal (q, kv) pairs
    flops = 4 * hd * pairs                     # q.k and p.v, 2 per multiply-add
    out = {}
    for name, ops_s in (("bfloat16", BF16_OPS_PER_S),
                        ("float32", FP32_OPS_PER_S)):
        dt = getattr(torch, name)
        q, k, v = attn_inputs(shape, dt, g, dev)
        ms = time_cuda(lambda: KF.flash_attention(q, k, v, win), reps=20)
        plain = time_cuda(lambda: KF.flash_attention_plain(q, k, v, win),
                          reps=2, rounds=3)
        lib = time_cuda(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps=20)
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        b_ms, b_by = bound(n_bytes, flops, ops_s)
        out[name] = (ms, plain, lib, b_ms, b_by, flops / ms / 1e9)
        log(f"[time] flash_attention {shape} {name}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.3f} ms, "
            f"scaled_dot_product_attention {lib:.4f} ms, bound {b_ms:.6f} "
            f"ms ({b_by}: {n_bytes} bytes, {flops} FLOP)")
        del q, k, v
    ms, plain, lib, b_ms, b_by, tflops = out["bfloat16"]
    f32 = out["float32"]
    launches = sum(attn["launches"].values())
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:83",
            "launches": launches, "max_abs_err": errs["flash_attention"],
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib,
            "library": "torch.nn.functional.scaled_dot_product_attention("
                       "is_causal=True, enable_gqa=True)",
            "shape": list(shape), "dtype": "bfloat16", "tflops": tflops,
            "kernel": "flash_attention_tc_kernel (wgmma, TMA)",
            "ms_fp32": f32[0], "tflops_fp32": f32[5], "plain_ms_fp32": f32[1],
            "library_ms_fp32": f32[2], "bound_ms_fp32": f32[3],
            "bound_by_fp32": f32[4],
            "device_us": attn["flash_device_us"],
            "launches_fp32_prefill":
                attn["fp32_kernel_vs_blockwise"]["launches"]["kernel"],
            "shapes": errs["flash_shapes"]}


# --------------------------------------------------------------------------
# phase 10: the MoE, hybrid and embeds LMs. olmoe-1b-7b at full width and
# depth; jamba-v0.1-52b at full width, cut to one period (8 of 32 layers:
# its fp32 masters of 51.5 B parameters would take 206 GB, one period takes
# 53.2 GB); musicgen-large at full width and depth on prompt embeddings
# --------------------------------------------------------------------------

MOE_ARCH, MOE_PARAMS = "olmoe-1b-7b", 6_919_096_320
HYBRID_ARCH, HYBRID_LAYERS = "jamba-v0.1-52b", 8
HYBRID_PARAMS = 13_295_235_072     # jax.eval_shape at num_layers=8
EMBEDS_ARCH, EMBEDS_PARAMS = "musicgen-large", 3_225_618_432
MOE_ON_OFF_PROMPT = 512       # the fp32 kernel-vs-plain prefill, batch 1
# capacity 16 is drop-free for both (k * 16 / E >= 1, so every expert can
# take every token of a call): capacity is computed from the tokens of one
# call, so at the published 1.25 a chunk, a decode step of the pool and a
# whole prefill drop different entries and their streams legitimately
# differ; the exact-stream gates run drop-free, as the reference's own test
DROP_FREE = 16.0
# routing is discrete: a top-k set may flip between two fp32 runs only at a
# near-tie of the k-th and (k+1)-th router probabilities
ROUTER_FLIP_MARGIN = 1e-4
# the scheduler arm: 4 requests on 2 slots, prompts of 1 + 256 q + r
# tokens (q in 1..3), 8-16 new tokens
MOE_SLOTS, MOE_MAX_LEN, MOE_REQS = 2, 1024, 4
HYBRID_BATCH = 1              # jamba's bf16 serving batch (1 x 2,048)
# the bf16 prefill's device time by part of the model: each part is the
# port's function named here, wrapped in a torch.profiler record_function
# for the profiled prefill only
SPLIT_PARTS = (("moe.router", "repro_torch.models.moe", "_router"),
               ("moe.dispatch", "repro_torch.models.moe", "_local_dispatch"),
               ("moe.experts", "repro_torch.models.moe", "_experts"),
               ("moe.combine", "repro_torch.models.moe", "_combine"),
               ("mamba.block", "repro_torch.models.ssm", "mamba_block"),
               ("mamba.scan", "repro_torch.core.linear_attn",
                "mamba_chunked"))


@contextlib.contextmanager
def patched(module, name, make):
    """``module.name`` replaced by ``make(original)`` inside the block."""
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def routed(fn):
    """moe._router hooked inside the block: each call's probabilities (N,
    E) and top-k experts (N, k) go to ``fn``. Where fn returns other
    experts (N, k), those are pinned in the call's place, weighted by the
    call's own probabilities over them, renormalised."""
    import torch
    from repro_torch.models import moe as M

    def make(orig):
        def run(params, cfg, xt):
            probs, top_p, top_e = orig(params, cfg, xt)
            pin = fn(probs, top_e)
            if pin is None:
                return probs, top_p, top_e
            top_p = torch.gather(probs, 1, pin)
            return probs, top_p / top_p.sum(-1, keepdim=True), pin
        return run
    with patched(M, "_router", make):
        yield


def recorder(calls: list):
    """An fn for routed that appends each call's (probs, top_e)."""
    def fn(probs, top_e):
        calls.append((probs, top_e))
    return fn


def pin_spans(top_e, spans, n_moe):
    """An fn for routed over one batch-1 run: call i is MoE layer i % n_moe
    of the step over positions spans[i // n_moe] = (a, b), and takes the
    experts top_e[layer, a:b] of an (n_moe, positions, k) table."""
    count = [0]

    def fn(probs, own):
        f, layer = divmod(count[0], n_moe)
        count[0] += 1
        a, b = spans[f]
        return top_e[layer, a:b]
    return fn


def route_tables(calls, n_moe, spans):
    """A batch-1 run's recorded routing (``calls``, one per MoE layer per
    step, step f over positions spans[f]) as (probs (n_moe, P, E), top_e
    (n_moe, P, k)) tables, MoE layer by position."""
    import torch
    return tuple(torch.stack([torch.cat([calls[f * n_moe + layer][j]
                                         for f in range(len(spans))])
                              for layer in range(n_moe)]) for j in (0, 1))


def routing_flips(got_e, want_p, want_e, k) -> dict:
    """The top-k sets of one run (got_e (layers, P, k)) that differ from
    another's (want_e, its probabilities want_p (layers, P, E)), each with
    its router margin in the other run (k-th minus (k+1)-th probability).
    A first flip has no flip upstream of it, at an earlier layer of the
    same or an earlier position: it is no cascade of another flip, so its
    margin is the one the difference between the runs alone had to cross."""
    import torch
    diff = (torch.sort(got_e, -1).values
            != torch.sort(want_e, -1).values).any(-1)
    srt = torch.sort(want_p, -1, descending=True).values
    margin = srt[..., k - 1] - srt[..., k]
    below = (diff.int().cumsum(0) - diff.int()) > 0
    first = diff & ~(below.int().cumsum(1) > 0)

    def span(mask):
        m = margin[mask]
        return (float(m.min()), float(m.max())) if m.numel() else (None, None)
    lo, hi = span(diff)
    first_lo, first_hi = span(first)
    return {"sets": diff.numel(), "flipped_sets": int(diff.sum()),
            "min_margin": lo, "max_margin": hi,
            "first_flips": int(first.sum()),
            "first_flip_min_margin": first_lo,
            "first_flip_max_margin": first_hi}


def n_layers_of(cfg, pred) -> int:
    return cfg.num_periods * sum(1 for s in cfg.pattern if pred(s))


def kernel_vs_plain_prefill(params, cfg, dev, seed, tag) -> dict:
    """One fp32 prefill of 1 x MOE_ON_OFF_PROMPT (tokens, or embeddings
    for an embeds model) with flash_attention and with the plain
    blockwise_attention: last logits within ON_OFF_RTOL of the largest,
    flash_attention launched once per attention layer (0 plain), and, for
    an MoE model at the config's capacity factor, every top-k set equal
    between the runs or flipped at a router margin <= ROUTER_FLIP_MARGIN."""
    import torch
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.serve import engine

    n_attn = n_layers_of(cfg, lambda s: s.mixer == "attn")
    n_moe = n_layers_of(cfg, lambda s: s.mlp == "moe")
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    if cfg.input_mode == "embeds":
        inp = {"embeds": torch.randn((1, MOE_ON_OFF_PROMPT, cfg.d_model),
                                     generator=g, device=dev)}
    else:
        inp = {"tokens": torch.randint(0, cfg.vocab, (1, MOE_ON_OFF_PROMPT),
                                       generator=g, device=dev)}
    runs = {}
    for use in (True, False):       # warm-up: first-call costs untimed
        engine.make_prefill_step(cfg, 0, use_kernels=use)(
            params, {k: v[:, :64] for k, v in inp.items()})
    for use in (True, False):
        step = engine.make_prefill_step(cfg, 0, use_kernels=use)
        calls = []
        with routed(recorder(calls)):
            torch.cuda.synchronize()
            KF.launches = 0
            t0 = time.perf_counter()
            logits, _ = step(params, inp)
            torch.cuda.synchronize()
            runs[use] = (logits, (time.perf_counter() - t0) * 1e3,
                         KF.launches, calls)
    (lg_on, ms_on, n_on, c_on), (lg_off, ms_off, n_off, c_off) = \
        runs[True], runs[False]
    check(n_on == n_attn and n_off == 0, f"{tag}: flash_attention launched "
          f"{n_on} (kernels on) and {n_off} (off) times, expected {n_attn} "
          "and 0")
    check(len(c_on) == len(c_off) == n_moe, f"{tag}: {len(c_on)} and "
          f"{len(c_off)} router calls, expected {n_moe}")
    check(bool(torch.isfinite(lg_on).all()), f"{tag}: non-finite logits")
    scale = float(lg_off.abs().max())
    err = float((lg_on - lg_off).abs().max())
    routing = None
    if n_moe:
        whole = [(0, MOE_ON_OFF_PROMPT)]
        routing = routing_flips(route_tables(c_on, n_moe, whole)[1],
                                *route_tables(c_off, n_moe, whole),
                                cfg.experts_per_token)
    log(f"[{tag}] fp32 prefill 1x{MOE_ON_OFF_PROMPT} (capacity factor "
        f"{getattr(cfg, 'capacity_factor', None)}): kernel {ms_on:.1f} ms "
        f"({n_on} flash_attention launches), blockwise {ms_off:.1f} ms; "
        f"last logits max_abs_err {err} of max |logit| {scale:.4f}; "
        f"routing {routing}")
    check(err <= ON_OFF_RTOL * scale, f"{tag}: fp32 logits kernel/blockwise "
          f"differ by {err} > {ON_OFF_RTOL} * {scale}")
    check(routing is None or routing["max_margin"] is None
          or routing["max_margin"] <= ROUTER_FLIP_MARGIN,
          f"{tag}: a top-k set flipped at router margin "
          f"{routing and routing['max_margin']} > {ROUTER_FLIP_MARGIN}")
    same_first = torch.equal(torch.argmax(lg_on[:, -1], -1),
                             torch.argmax(lg_off[:, -1], -1))
    return {"prompt": MOE_ON_OFF_PROMPT, "logits_max_abs_err": err,
            "logits_max_abs": scale, "first_token_equal": same_first,
            "launches": {"kernel": n_on, "blockwise": n_off},
            "prefill_ms_kernel": ms_on, "prefill_ms_blockwise": ms_off,
            "routing": routing}


def moe_requests(vocab, seed):
    """(prompts, max_new_tokens) of the MoE scheduler arm, from seed."""
    import numpy as np
    rng = np.random.default_rng(seed + 110)
    q = rng.integers(1, 4, MOE_REQS)
    r = rng.integers(0, 32, MOE_REQS)
    lens = 1 + SCHED_CHUNK * q + r
    mnts = rng.integers(8, 17, MOE_REQS) // 2       # halved to make room
    prompts = [rng.integers(0, vocab, ln).astype(np.int32) for ln in lens]
    return prompts, [int(n) for n in mnts]


def generate_spans(ln, mnt, chunk):
    """The positions each step of engine.generate covers: full chunks over
    the first L-1 tokens, then one decode step per position up to the one
    that yields the last new token (L + mnt - 2)."""
    n = (ln - 1) // chunk
    return ([(f * chunk, (f + 1) * chunk) for f in range(n)]
            + [(p, p + 1) for p in range(n * chunk, ln + mnt - 1)])


@contextlib.contextmanager
def scheduler_routing(sched, prompts, mnts, n_moe, k, pin=None):
    """Inside the block each scheduler step's live rows are mapped to a
    request and its positions: a chunk row by its tokens, found in the
    prompts at its position; a decode row by the request that last chunked
    into its slot (every prompt starts with a chunk). Each live row's own
    top-k experts are recorded into the (n_moe, L + mnt - 1, k) table of
    its request (-1 where no step routed), which the block yields; with
    ``pin`` (one such table per request) a live row's experts are pinned to
    its request's at the same layer and positions. Free rows keep their
    own routing."""
    import torch
    slots = sched.slots
    seen = [torch.full((n_moe, len(p) + n - 1, k), -1, dtype=torch.int64,
                       device=sched.device) for p, n in zip(prompts, mnts)]
    owner, rows, count = {}, [], [0]

    def chunk(params, idx, tokens, pos):
        n = tokens.shape[1]
        for s, row, p in zip(idx, tokens.tolist(), pos.tolist()):
            owner[s] = next(i for i, q in enumerate(prompts)
                            if q[p:p + n].tolist() == row)
        rows[:] = [(owner[s], p, n) for s, p in zip(idx, pos.tolist())]
        count[0] = 0
        return run_chunk(params, idx, tokens, pos)

    def decode(params, tokens, pos, *a, **kw):
        live = set(slots.live)
        rows[:] = [(owner[s], p, 1) if s in live else None
                   for s, p in enumerate(pos.tolist())]
        count[0] = 0
        return run_decode(params, tokens, pos, *a, **kw)

    def fn(probs, top_e):
        layer = count[0] % n_moe
        count[0] += 1
        out = top_e.clone() if pin else None
        for r, row in enumerate(rows):
            if row is not None:
                i, p, n = row
                seen[i][layer, p:p + n] = top_e[r * n:(r + 1) * n]
                if pin:
                    out[r * n:(r + 1) * n] = pin[i][layer, p:p + n]
        return out

    run_chunk, run_decode = slots.run_chunk, slots.run_decode
    slots.run_chunk, slots.run_decode = chunk, decode
    try:
        with routed(fn):
            yield seen
    finally:
        del slots.run_chunk, slots.run_decode


def moe_scheduler(params, cfg, dev, seed, tag, gate) -> dict:
    """The MoE arm's requests through serve.Scheduler on MOE_SLOTS slots
    against per-request engine.generate at the same capacity factor.

    Free runs, contiguous (and with ``gate`` paged): the equal streams are
    counted, not gated, and each request's routing is held against
    generate's (flips and first flips with their margins). Routing is
    discrete: the pool decodes 2 rows where generate decodes 1, cuBLAS may
    then round the fp32 projections in other last bits, a k or v value on
    a bf16 rounding boundary of the cache then rounds the other way, and a
    top-k set with a margin of that order flips, which moves its token's
    output by a part of its magnitude. Drop-free, only such rounding
    separates the two paths, so every first flip of a free run is gated at
    a margin <= ROUTER_FLIP_MARGIN (at the published factor the pool and
    generate drop other entries, so flips there are reported only). With
    ``gate`` (drop-free) each
    backing runs again with every live row's top-k sets pinned to
    generate's for the same request and positions (scheduler_routing), and
    those streams go through stream_gate, whose near-tie prefill is pinned
    the same way; no flash_attention launch in any scheduler run."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.serve import Scheduler, engine

    n_moe = n_layers_of(cfg, lambda s: s.mlp == "moe")
    k = cfg.experts_per_token
    prompts, mnts = moe_requests(cfg.vocab, seed)
    want, tables = [], []
    for p, n in zip(prompts, mnts):
        calls = []
        with routed(recorder(calls)):
            want.append(engine.generate(params, cfg, p, n,
                                        prefill_chunk=SCHED_CHUNK,
                                        cache_slots=MOE_MAX_LEN)[0])
        spans = generate_spans(len(p), n, SCHED_CHUNK)
        check(len(calls) == n_moe * len(spans), f"{tag}: {len(calls)} "
              f"router calls in generate, expected {n_moe * len(spans)}")
        tables.append(route_tables(calls, n_moe, spans))

    def pinned_prefill(i):
        step = engine.make_prefill_step(cfg, 0)

        def run(params, batch):
            n = batch["tokens"].shape[1]
            with routed(pin_spans(tables[i][1], [(0, n)], n_moe)):
                return step(params, batch)
        return run

    backings = [("contiguous", {})]
    if gate:
        backings.append(("paged", dict(allocator="paged",
                                       block_size=PAGED_BLOCK)))
    out = {"capacity_factor": cfg.capacity_factor,
           "prompt_lens": [len(p) for p in prompts], "max_new": mnts,
           "slots": MOE_SLOTS}
    for name, kw in backings:
        for pin in ((False, True) if gate else (False,)):
            sched = Scheduler(cfg, params, sched_config(
                num_slots=MOE_SLOTS, max_len=MOE_MAX_LEN, **kw))
            torch.cuda.synchronize()
            KF.launches = 0
            t0 = time.perf_counter()
            with scheduler_routing(sched, prompts, mnts, n_moe, k, [
                    e for _, e in tables] if pin else None) as seen:
                done = drive_scheduler(sched, prompts, mnts,
                                       first=MOE_SLOTS)
            wall = time.perf_counter() - t0
            launches = KF.launches
            arm = f"{name}{' pinned' if pin else ''}"
            check(all(bool((s >= 0).all()) for s in seen), f"{tag} {arm} "
                  "scheduler: a position no step routed")
            routing = None
            if pin:
                exact, ties = stream_gate(
                    params, cfg, dev, prompts, mnts, done, want,
                    f"{tag} {arm} scheduler against generate",
                    prefill=pinned_prefill)
            else:
                exact = sum(np.array_equal(done[i].tokens, want[i])
                            for i in range(MOE_REQS))
                ties = None
                routing = [routing_flips(s, *t, k)
                           for s, t in zip(seen, tables)]
                worst = max((r["first_flip_max_margin"] or 0.0
                             for r in routing), default=0.0)
                check(not gate or worst <= ROUTER_FLIP_MARGIN, f"{tag} "
                      f"{arm} scheduler: a first flip at router margin "
                      f"{worst} > {ROUTER_FLIP_MARGIN} against generate")
            check(launches == 0, f"{tag} {arm} scheduler: {launches} "
                  "flash_attention launches, expected 0")
            out[arm] = {"wall_s": wall, "exact_streams": exact,
                        "near_ties": ties, "launches": launches,
                        "decode_steps": sched.counters["decode_steps"],
                        "chunk_steps": sched.counters["chunk_steps"],
                        "routing": routing}
            log(f"[{tag}] fp32 scheduler, capacity factor "
                f"{cfg.capacity_factor}, {arm}: {MOE_REQS} requests "
                f"(prompts {[len(p) for p in prompts]}, new {mnts}) on "
                f"{MOE_SLOTS} slots in {wall:.2f} s; {exact} of {MOE_REQS} "
                f"streams equal per-request generate"
                f"{', gated' if pin else ' (not gated)'}, near-ties {ties}; "
                f"{launches} flash_attention launches; routing against "
                f"generate's by request {routing}")
            del sched
    torch.cuda.empty_cache()
    return out


def moe_generate_vs_prefill(params, cfg, dev, seed, tag) -> dict:
    """generate_vs_prefill for an MoE model (drop-free ``cfg``): three
    walks against one prefill. Routing is discrete, and the chunk path
    attends over the bf16 KV cache where the prefill attends over
    unrounded fp32 k and v: router inputs move by about a bf16 rounding,
    which flips top-k sets whose margin is of that order, and a flipped
    set moves its token's output by a part of its magnitude. So the walk
    runs free (error, flips and first flips with their margins reported);
    free on an fp32 KV cache, where only the fp32 rounding of the chunk
    path differs from the prefill (gated: every first flip at a margin <=
    ROUTER_FLIP_MARGIN, last logits within GVP_RTOL["attn"]); and on the
    bf16 cache with every top-k set pinned to the prefill's (gated at
    GVP_RTOL["attn"])."""
    import torch
    from repro_torch.serve import engine

    n_moe = n_layers_of(cfg, lambda s: s.mlp == "moe")
    k = cfg.experts_per_token
    g = torch.Generator(device=dev).manual_seed(seed + 30)
    prompt = torch.randint(0, cfg.vocab, (GVP_PROMPT,), generator=g,
                           device=dev)
    spans = generate_spans(GVP_PROMPT, 1, GVP_CHUNK)
    t0 = time.perf_counter()
    ref = []
    with routed(recorder(ref)):
        want, _ = engine.make_prefill_step(cfg, 0)(params,
                                                   {"tokens": prompt[None]})
    want = want[0, -1]
    scale = float(want.abs().max())
    check(len(ref) == n_moe, f"{tag}: {len(ref)} router calls in the "
          "prefill")
    p_ref, e_ref = route_tables(ref, n_moe, [(0, GVP_PROMPT)])
    rtol = GVP_RTOL["attn"]
    walks = {}
    for name, kv, pin in (("free", None, False),
                          ("fp32_kv", torch.float32, False),
                          ("pinned", None, True)):
        calls = []
        with routed(pin_spans(e_ref, spans, n_moe) if pin
                    else recorder(calls)):
            lg, got = chunk_walk(params, cfg, dev, prompt, kv_dtype=kv)
        check(got == spans, f"{tag}: the walk took steps {got}")
        err = float((lg - want).abs().max())
        walks[name] = {"max_abs_err": err, "rel_err": err / scale}
        if not pin:
            check(len(calls) == n_moe * len(spans), f"{tag}: {len(calls)} "
                  f"router calls in the {name} walk")
            walks[name]["routing"] = routing_flips(
                route_tables(calls, n_moe, spans)[1], p_ref, e_ref, k)
    torch.cuda.synchronize()
    log(f"[gen-vs-prefill] {cfg.name} fp32 drop-free, prompt {GVP_PROMPT}, "
        f"{len(spans)} steps, max |logit| {scale:.4f}, gate {rtol} "
        f"relative; walks against one prefill {walks}; "
        f"{time.perf_counter() - t0:.1f} s")
    fp32 = walks["fp32_kv"]
    check(fp32["routing"]["first_flip_max_margin"] is None
          or fp32["routing"]["first_flip_max_margin"] <= ROUTER_FLIP_MARGIN,
          f"{tag}: on an fp32 KV cache a first flip at router margin "
          f"{fp32['routing']['first_flip_max_margin']} > "
          f"{ROUTER_FLIP_MARGIN}")
    for name in ("fp32_kv", "pinned"):
        check(walks[name]["max_abs_err"] <= rtol * scale, f"{tag}: "
              f"generate's chunk path ({name}) and one prefill differ by "
              f"{walks[name]['max_abs_err']} > {rtol} * {scale}")
    return {"prompt": GVP_PROMPT, "chunk": GVP_CHUNK, "steps": len(spans),
            "max_abs_logit": scale, "rtol": rtol, "walks": walks}


def moe_fp32_arms(params, cfg, dev, seed, tag) -> dict:
    """The three fp32 arms of an MoE model: kernel against plain at the
    published capacity factor; generate's chunk path against one prefill
    and the scheduler on both backings, drop-free; and the scheduler at the
    published factor, its equal streams counted."""
    import dataclasses
    on_off = kernel_vs_plain_prefill(params, cfg, dev, seed, tag)
    on_off["capacity_factor"] = cfg.capacity_factor
    free = dataclasses.replace(cfg, capacity_factor=DROP_FREE)
    gvp = moe_generate_vs_prefill(params, free, dev, seed, tag)
    sched = moe_scheduler(params, free, dev, seed, tag, gate=True)
    sched["published"] = moe_scheduler(params, cfg, dev, seed, tag,
                                       gate=False)
    return {"fp32_kernel_vs_plain": on_off, "generate_vs_prefill": gvp,
            "scheduler": sched}


def split_prefill(prefill, params, batch) -> dict:
    """One bf16 prefill under torch.profiler (CPU and CUDA activity) with
    SPLIT_PARTS wrapped in record_function: the device time of each part
    (the kernels of the ops inside it), of flash_attention (by kernel
    name), of everything else, and the card's idle share of the wall."""
    import importlib
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def annotate(label):
        def make(orig):
            def run(*a, **kw):
                with record_function(label):
                    return orig(*a, **kw)
            return run
        return make

    labels = [label for label, _, _ in SPLIT_PARTS]
    with contextlib.ExitStack() as stack:
        for label, mod, fn in SPLIT_PARTS:
            stack.enter_context(patched(importlib.import_module(mod), fn,
                                        annotate(label)))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prefill(params, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
    spans = [s for s in device_spans(prof) if s[2] not in labels]
    parts = dict.fromkeys(labels, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in parts:
            parts[e.name] += e.device_time_total
    busy = busy_us(spans)
    flash = sum(e - s for s, e, name in spans if "flash_attention" in name)
    kernels = sum(e - s for s, e, _ in spans)
    inner = parts["mamba.scan"]     # nested inside mamba.block
    named = (flash + parts["moe.router"] + parts["moe.dispatch"]
             + parts["moe.experts"] + parts["moe.combine"]
             + parts["mamba.block"])
    out = {"wall_us": wall, "busy_us": busy, "idle_share": 1 - busy / wall,
           "kernel_us": kernels, "flash_attention_us": flash,
           **{f"{k}_us": v for k, v in parts.items()},
           "mamba.block_outside_scan_us": parts["mamba.block"] - inner,
           "other_us": kernels - named}
    out["shares_of_kernel_time"] = {
        k[:-3]: v / kernels for k, v in out.items()
        if k.endswith("_us") and k not in ("wall_us", "busy_us",
                                           "kernel_us") and kernels}
    return out


def bf16_timings(params, cfg, batch, step_inp, tag) -> dict:
    """Warm timings of launch.serve's path on bf16 weights: a prefill
    (host clock to a synchronize), then the same prefill split by part
    (split_prefill), and DECODE_PROFILE_STEPS decode steps under the
    profiler for the card's busy share."""
    import torch
    from repro_torch.serve import engine
    b, s = next(iter(batch.values())).shape[:2]
    prefill = engine.make_prefill_step(cfg, s + LM_GEN)
    decode = engine.make_decode_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    split = split_prefill(prefill, params, batch)
    tok = engine.sample_token(logits)

    def decode_loop():
        nonlocal caches, tok
        for i in range(DECODE_PROFILE_STEPS):
            tok, _, caches = decode(params, caches, step_inp(tok), s + i)
    dwall, dspans = profiled(decode_loop)
    out = {"prefill_ms": warm_ms, "prefill_tok_s": b * s / (warm_ms / 1e3),
           "prefill_busy_share": split["busy_us"] / split["wall_us"],
           "prefill_split": split,
           "decode_busy_share": busy_us(dspans) / dwall if dspans else None,
           "decode_profiled_ms_per_step": dwall / 1e3 / DECODE_PROFILE_STEPS}
    sh = {k: round(v, 4) for k, v in split["shares_of_kernel_time"].items()}
    log(f"[{tag}] bf16 prefill {b}x{s}: warm {warm_ms:.1f} ms "
        f"({out['prefill_tok_s']:.0f} tok/s); profiled "
        f"{split['wall_us'] / 1e3:.1f} ms, card idle {split['idle_share']:.4f}, kernel time "
        f"{split['kernel_us'] / 1e3:.2f} ms by part {sh}")
    log(f"[{tag}] bf16 decode batch {b}: {DECODE_PROFILE_STEPS} steps under "
        f"the profiler {out['decode_profiled_ms_per_step']:.3f} ms per "
        f"step, card busy {out['decode_busy_share']}")
    del caches
    return out


def serve_report(res, n_attn, params_want, tag) -> dict:
    """launch.serve's (or its loop's) result: shapes, finiteness, one
    flash_attention launch per attention layer, its timings."""
    import torch
    from repro_torch.models import transformer as TT
    cfg, params = res["cfg"], res["params"]
    n = TT.param_count(params)
    check(n == params_want, f"{tag}: {n} parameters, not {params_want}")
    gen = res["generated"]
    b = gen.shape[0]
    check(tuple(gen.shape) == (b, LM_GEN)
          and bool(((gen >= 0) & (gen < cfg.vocab)).all()),
          f"{tag}: generated tokens {tuple(gen.shape)} out of shape or range")
    check(bool(torch.isfinite(res["logits"]).all()), f"{tag}: non-finite "
          "logits")
    check(res["launches"] == n_attn, f"{tag}: flash_attention launched "
          f"{res['launches']} times in one prefill + decode, expected "
          f"{n_attn}")
    steps = res["decode_steps"]
    out = {"arch": cfg.name, "layers": cfg.num_layers, "params": n,
           "active_params": TT.active_param_count(params, cfg),
           "dtype": str(cfg.dtype).replace("torch.", ""), "batch": b,
           "prompt_len": int(res["prompts"].shape[1]), "gen": LM_GEN,
           "prefill_ms_first_call": res["prefill_ms"],
           "decode_ms_per_step": res["decode_ms"] / steps,
           "decode_tok_s": b * steps / (res["decode_ms"] / 1e3),
           "launches": {"serve": res["launches"]}}
    log(f"[{tag}] bf16 serving {cfg.name} ({cfg.num_layers} layers, {n} "
        f"parameters, {out['active_params']} active) batch {b} x "
        f"{out['prompt_len']}: first prefill {res['prefill_ms']:.1f} ms, "
        f"decode {out['decode_ms_per_step']:.3f} ms per step "
        f"({out['decode_tok_s']:.1f} tok/s); {res['launches']} "
        "flash_attention launches")
    return out


def serve_launch(argv) -> dict:
    """launch.serve.run(argv) with the flash_attention count at 0 just
    before and read just after."""
    import torch
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.launch import serve
    torch.cuda.synchronize()
    KF.launches = 0
    res = serve.run(argv)
    res["launches"] = KF.launches
    return res


def serve_loop(params, cfg, batch, gen) -> dict:
    """launch.serve's loop for a model built here (jamba, cut to one
    period): make_prefill_step, then gen - 1 greedy make_decode_step
    steps, timed on the host clock to a synchronize, the flash_attention
    count at 0 just before and read just after."""
    import torch
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.serve import engine
    b, s = batch["tokens"].shape
    prefill = engine.make_prefill_step(cfg, cache_slots=s + gen)
    decode = engine.make_decode_step(cfg)
    torch.cuda.synchronize()
    KF.launches = 0
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    tok = engine.sample_token(logits)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        tok, logits, caches = decode(params, caches,
                                     {"tokens": tok[:, None]}, s + i)
        out.append(tok)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    return {"cfg": cfg, "params": params, "prompts": batch["tokens"],
            "generated": torch.stack(out, dim=1), "logits": logits,
            "prefill_ms": t_prefill * 1e3, "decode_ms": t_decode * 1e3,
            "decode_steps": gen - 1, "launches": KF.launches}


def memory_reset() -> int:
    """Collect what earlier phases or arms left for the garbage collector,
    reset the peak and return the bytes still allocated: at a phase's start
    its baseline, what earlier phases still hold."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_gb(base: int) -> float:
    """Peak device memory allocated since the last memory_reset, above the
    phase's baseline ``base``, in GB."""
    import torch
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def moe_phase(dev, seed) -> dict:
    """olmoe-1b-7b at full width and depth: the fp32 arms on weights drawn
    here, then bf16 serving through launch.serve (batch 4 x 2,048, 16
    greedy tokens) and its warm timings and split."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as TT

    base = memory_reset()
    cfg = dataclasses.replace(configs.get_config(MOE_ARCH),
                              dtype=torch.float32)
    t0 = time.perf_counter()
    params = TT.init_model(cfg, torch.Generator(device=dev).manual_seed(
        seed + 120), dev)
    torch.cuda.synchronize()
    n = TT.param_count(params)
    log(f"[moe] {cfg.name} fp32: {n} parameters drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    check(n == MOE_PARAMS, f"{cfg.name} has {n} parameters, not {MOE_PARAMS}")
    out = moe_fp32_arms(params, cfg, dev, seed, "moe")
    out["fp32_peak_gb"] = peak_gb(base)
    del params
    memory_reset()
    n_attn = n_layers_of(cfg, lambda s: s.mixer == "attn")
    res = serve_launch(["--arch", MOE_ARCH, "--full", "--batch",
                        str(LM_BATCH), "--prompt-len", str(LM_PROMPT),
                        "--gen", str(LM_GEN), "--seed", str(seed)])
    out["serve"] = serve_report(res, n_attn, MOE_PARAMS, "moe")
    out["serve"].update(bf16_timings(
        res["params"], res["cfg"], {"tokens": res["prompts"]},
        lambda tok: {"tokens": tok[:, None]}, "moe"))
    out["serve"]["peak_gb"] = peak_gb(base)
    log(f"[moe] peak device memory: fp32 arms {out['fp32_peak_gb']:.2f} GB, "
        f"bf16 serving {out['serve']['peak_gb']:.2f} GB")
    del res
    torch.cuda.empty_cache()
    return out


def hybrid_phase(dev, seed) -> dict:
    """jamba-v0.1-52b at full width, HYBRID_LAYERS deep: the fp32 arms,
    then the same fp32 masters served in bf16 (batch 1 x 2,048, 16 greedy
    tokens) through make_prefill_step / make_decode_step as launch.serve
    drives them, and the warm timings and split."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as TT

    base = memory_reset()
    full = configs.get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, num_layers=HYBRID_LAYERS,
                              dtype=torch.float32)
    t0 = time.perf_counter()
    params = TT.init_model(cfg, torch.Generator(device=dev).manual_seed(
        seed + 130), dev)
    torch.cuda.synchronize()
    n = TT.param_count(params)
    log(f"[hybrid] {cfg.name} fp32, {cfg.num_layers} of {full.num_layers} "
        f"layers (pattern {[(s.mixer, s.mlp) for s in cfg.pattern]}): {n} "
        f"parameters drawn on the card in {time.perf_counter() - t0:.2f} s")
    check(n == HYBRID_PARAMS, f"{cfg.name} at {cfg.num_layers} layers has "
          f"{n} parameters, not {HYBRID_PARAMS}")
    out = moe_fp32_arms(params, cfg, dev, seed, "hybrid")
    out["fp32_peak_gb"] = peak_gb(base)
    memory_reset()
    bf16 = dataclasses.replace(cfg, dtype=full.dtype)
    tokens = torch.randint(0, cfg.vocab, (HYBRID_BATCH, LM_PROMPT),
                           generator=torch.Generator(device=dev).manual_seed(
                               seed + 1), device=dev)
    res = serve_loop(params, bf16, {"tokens": tokens}, LM_GEN)
    n_attn = n_layers_of(cfg, lambda s: s.mixer == "attn")
    out["serve"] = serve_report(res, n_attn, HYBRID_PARAMS, "hybrid")
    out["serve"].update(bf16_timings(
        params, bf16, {"tokens": tokens},
        lambda tok: {"tokens": tok[:, None]}, "hybrid"))
    out["serve"]["peak_gb"] = peak_gb(base)
    log(f"[hybrid] peak device memory: fp32 arms {out['fp32_peak_gb']:.2f} "
        f"GB, bf16 serving {out['serve']['peak_gb']:.2f} GB")
    del params, res
    torch.cuda.empty_cache()
    return out


def embeds_phase(dev, seed) -> dict:
    """musicgen-large at full width and depth through launch.serve on
    random bf16 prompt embeddings (batch 4 x 2,048, 32 steps, each step
    fed the launcher's one step embedding), its fp32 kernel-vs-plain
    prefill on the same weights, and its warm timings."""
    import dataclasses
    import torch
    base = memory_reset()
    res = serve_launch(["--arch", EMBEDS_ARCH, "--full", "--batch",
                        str(LM_BATCH), "--prompt-len", str(LM_PROMPT),
                        "--gen", str(LM_GEN), "--seed", str(seed)])
    cfg = res["cfg"]
    emb = res["prompts"]
    check(cfg.input_mode == "embeds" and emb.dtype == torch.bfloat16
          and tuple(emb.shape) == (LM_BATCH, LM_PROMPT, cfg.d_model),
          f"embeds: prompts {emb.dtype} {tuple(emb.shape)}")
    out = serve_report(res, cfg.num_layers, EMBEDS_PARAMS, "embeds")
    out["fp32_kernel_vs_plain"] = kernel_vs_plain_prefill(
        res["params"], dataclasses.replace(cfg, dtype=torch.float32), dev,
        seed, "embeds")
    step = torch.randn((LM_BATCH, 1, cfg.d_model), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(
                           seed + 2)).to(torch.bfloat16)
    out.update(bf16_timings(res["params"], cfg, {"embeds": emb},
                            lambda tok: {"embeds": step}, "embeds"))
    out["peak_gb"] = peak_gb(base)
    log(f"[embeds] peak device memory {out['peak_gb']:.2f} GB")
    del res
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 11: training. The two backward kernels against their plain
# backwards (and bitwise across two launches), an fp32 train step with the
# kernels on against off, gemma-2b (batch 2 x 2,048) and rwkv6-1.6b (4 x
# 2,048) trained in bf16 through launch.train at full width and depth, and
# an exact resume after an injected failure on a 2-layer cut of rwkv6-1.6b
# --------------------------------------------------------------------------

TRAIN_STEPS = 3
TRAIN_BATCH = {"gemma-2b": 2, "rwkv6-1.6b": 4}
TRAIN_SEQ = 2048
# (B, H, KV, Sq, Skv, hd, window) of the flash_attention backward checks
FLASH_BWD_SHAPES = (
    (2, 8, 1, 2048, 2048, 256, 0),   # gemma-2b's train step (batch 2)
    (2, 4, 4, 128, 128, 64, 0),      # MHA
    (1, 8, 2, 256, 256, 32, 0),      # GQA 4:1
    (1, 4, 2, 256, 256, 64, 96),     # window 96
    (2, 4, 2, 300, 300, 16, 0),      # ragged, hd 16
    (1, 8, 1, 1537, 1537, 256, 0),   # ragged at gemma-2b's heads
    (1, 40, 8, 1000, 1000, 128, 0),  # hd 128, GQA 5:1, ragged
    (1, 4, 2, 200, 333, 64, 0),      # Skv > Sq
    (1, 4, 2, 333, 200, 64, 50))     # Sq > Skv, window: rows that see nothing
# (B, T, dk, dv, with u, s0 and the final state's gradient) of the ssm_scan
# backward checks
SCAN_BWD_SHAPES = ((128, 2048, 64, 64, False),   # rwkv6-1.6b: 4 x 32 heads
                   (1, 1000, 16, 16, True),
                   (3, 96, 8, 24, True),
                   (2, 33, 5, 7, True),          # dk, dv not multiples of 4
                   (2, 50, 64, 128, True),       # dv at its largest
                   (4, 17, 1, 1, True))
# fp32: kernel and plain backward sum in other orders (the scan's over 2,048
# steps, attention's over up to 16,384 (q, head) terms of dK and dV), so
# they differ far below 1e-4 of the largest gradient; bf16 attention as the
# forward's FLASH_TOL (the tensor-core kernels split P and dS into two bf16
# parts, sum in fp32 and round the outputs once; a single bf16 rounding of
# P or dS would not meet it: tests/test_torch_flash_bwd_rounding.py)
SCAN_BWD_TOL = 1e-4                 # of max(1, max |plain|), per gradient
TRAIN_ON_OFF_RTOL = {"loss": 1e-5, "grad_norm": 1e-4}
# gemma-2b's fp32 on/off step at 6 of its 18 layers (cut to make room)
TRAIN_ON_OFF_LAYERS = 6
RESUME_LAYERS = 2
RESUME_STEPS, RESUME_FAIL_AT, RESUME_CKPT_EVERY = 4, 3, 2


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|), in fp32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def check_flash_bwd(dev) -> dict:
    """The forward kernels' row log-sum-exp against the plain one, then the
    backward kernels against flash_attention_bwd_plain on the same (q, k,
    v, o, lse, dO), fp32 and bf16, at FLASH_BWD_SHAPES within FLASH_TOL,
    each twice (bitwise equal); then the autograd Function on the card
    against autograd through the plain version."""
    import torch
    from repro_torch.kernels import flash_attention as KF

    g = torch.Generator(device=dev).manual_seed(21)
    err, rows = 0.0, []
    for shape in FLASH_BWD_SHAPES:
        win = shape[-1]
        for name, tol in FLASH_TOL.items():
            dt = getattr(torch, name)
            q, k, v = attn_inputs(shape, dt, g, dev)
            do = torch.randn(q.shape, generator=g, device=dev).to(dt)
            out, lse = KF._forward(q, k, v, win, with_lse=True)
            _, want_lse = KF.flash_attention_fwd_plain(q, k, v, win)
            fin = torch.isfinite(want_lse)
            lse_ok = bool(torch.equal(fin, torch.isfinite(lse))) and bool(
                torch.allclose(lse[fin], want_lse[fin], rtol=1e-5, atol=1e-4))
            lse_err = float((lse[fin] - want_lse[fin]).abs().max()) \
                if bool(fin.any()) else 0.0
            got = KF._backward(q, k, v, out, lse, do, win)
            again = KF._backward(q, k, v, out, lse, do, win)
            want = KF.flash_attention_bwd_plain(q, k, v, out, lse, do, win)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            errs = [float((a.float() - b.float()).abs().max())
                    for a, b in zip(got, want)]
            close = all(a.dtype == b.dtype and torch.allclose(
                a.float(), b.float(), rtol=tol, atol=tol)
                for a, b in zip(got, want))
            err = max(err, *errs)
            rows.append({"shape": list(shape), "dtype": name, "ok": close,
                         "bitwise_twice": same, "max_abs_err": errs,
                         "lse_err": lse_err})
            log(f"[train] flash_attention bwd {shape} {name}: allclose(rtol="
                f"atol={tol})={close} max_abs_err dq/dk/dv={errs} max|grad|="
                f"{[round(float(w.float().abs().max()), 3) for w in want]}; "
                f"two launches bitwise equal={same}; lse ok={lse_ok} "
                f"(max err {lse_err})")
            check(lse_ok, f"flash_attention lse {shape} {name} differs from "
                  "the plain one")
            check(close, f"flash_attention backward {shape} {name} differs "
                  "from its plain version")
            check(same, f"flash_attention backward {shape} {name}: two "
                  "launches differ")
            del q, k, v, do, out, lse, got, again, want
    # the Function on the card: the forward kernel with lse, the backward
    # kernels, against autograd through the plain version
    shape = (2, 4, 2, 300, 300, 64, 0)
    q, k, v = (x.requires_grad_() for x in attn_inputs(shape, torch.float32,
                                                       g, dev))
    do = torch.randn(q.shape, generator=g, device=dev)
    f0, b0 = KF.launches, KF.bwd_launches
    got = torch.autograd.grad(KF.flash_attention(q, k, v), (q, k, v), do)
    f1, b1 = KF.launches - f0, KF.bwd_launches - b0
    want = torch.autograd.grad(KF.flash_attention_plain(q, k, v), (q, k, v),
                               do)
    fn_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    log(f"[train] FlashAttention (autograd) on the card: {f1} forward and "
        f"{b1} backward launches; against autograd of the plain version "
        f"max_abs_err {fn_err}")
    check(f1 == 1 and b1 == 1 and fn_err <= 1e-4,
          "FlashAttention's gradient on the card differs from autograd")
    return {"max_abs_err": err, "shapes": rows, "function_err": fn_err}


def check_ssm_bwd(dev) -> dict:
    """The ssm_scan backward kernel against ssm_scan_bwd_plain at
    SCAN_BWD_SHAPES (rel_err within SCAN_BWD_TOL per gradient), twice
    (bitwise equal); then the autograd Function against autograd through
    the plain scan."""
    import torch
    from repro_torch.kernels import ssm_scan as KS

    g = torch.Generator(device=dev).manual_seed(22)
    err, rows = 0.0, []
    names = ("dr", "dw", "dk", "dv", "du", "ds0")
    for b, t, dk, dv, full in SCAN_BWD_SHAPES:
        r, w, k, v, u, s0 = wkv_inputs(b, t, dk, dv, g, dev, full)
        if not full:
            u = None
        dy = torch.randn((b, t, dv), generator=g, device=dev)
        dsf = (torch.randn((b, dk, dv), generator=g, device=dev) if full
               else None)
        got = KS._backward(r, w, k, v, u, s0, dy, dsf)
        again = KS._backward(r, w, k, v, u, s0, dy, dsf)
        want = KS.ssm_scan_bwd_plain(r, w, k, v, u, s0, dy, dsf)
        torch.cuda.synchronize()
        same = all((a is None and c is None) or torch.equal(a, c)
                   for a, c in zip(got, again))
        errs = {n: rel_err(a, c) for n, a, c in zip(names, got, want)
                if c is not None}
        ok = all(e <= SCAN_BWD_TOL for e in errs.values())
        err = max(err, *errs.values())
        rows.append({"shape": [b, t, dk, dv], "u_s0_dsfinal": full,
                     "ok": ok, "bitwise_twice": same, "rel_err": errs})
        log(f"[train] ssm_scan bwd {(b, t, dk, dv)} u/s0/ds_final="
            f"{full}: rel_err {errs} (tol {SCAN_BWD_TOL}); two launches "
            f"bitwise equal={same}")
        check(ok, f"ssm_scan backward {(b, t, dk, dv)} differs from its "
              "plain version")
        check(same, f"ssm_scan backward {(b, t, dk, dv)}: two launches "
              "differ")
    r, w, k, v, u, s0 = (x.requires_grad_() for x in
                         wkv_inputs(2, 300, 16, 24, g, dev, True))
    dy = torch.randn((2, 300, 24), generator=g, device=dev)
    f0, b0 = KS.launches, KS.bwd_launches
    y, _ = KS.ssm_scan(r, w, k, v, u, s0)
    got = torch.autograd.grad(y, (r, w, k, v, u, s0), dy)
    f1, b1 = KS.launches - f0, KS.bwd_launches - b0
    y2, _ = KS.ssm_scan_plain(r, w, k, v, u, s0)
    want = torch.autograd.grad(y2, (r, w, k, v, u, s0), dy)
    fn_err = max(rel_err(a, c) for a, c in zip(got, want))
    log(f"[train] SSMScan (autograd) on the card: {f1} forward and {b1} "
        f"backward launches; against autograd of the plain scan rel_err "
        f"{fn_err}")
    check(f1 == 1 and b1 == 1 and fn_err <= SCAN_BWD_TOL,
          "SSMScan's gradient on the card differs from autograd")
    return {"max_rel_err": err, "shapes": rows, "function_err": fn_err}


def flash_bwd_entry(dev, errs, launches) -> dict:
    """Times of the flash_attention backward at gemma-2b's train shape,
    bf16 (the train path's type) and fp32, beside its bound (2.5x the
    forward's operations), its plain version and the backward of
    scaled_dot_product_attention under autograd (timed here only)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as KF

    shape = FLASH_BWD_SHAPES[0]
    b, h, kvh, s, _, hd, win = shape
    g = torch.Generator(device=dev).manual_seed(23)
    pairs = b * h * s * (s + 1) // 2
    flops = 10 * hd * pairs                    # 2.5 x the forward's 4 hd
    out = {}
    for name, ops_s in (("bfloat16", BF16_OPS_PER_S),
                        ("float32", FP32_OPS_PER_S)):
        dt = getattr(torch, name)
        q, k, v = attn_inputs(shape, dt, g, dev)
        do = torch.randn(q.shape, generator=g, device=dev).to(dt)
        o, lse = KF._forward(q, k, v, win, with_lse=True)
        ms = time_cuda(lambda: KF._backward(q, k, v, o, lse, do, win),
                       reps=5)
        plain = time_cuda(lambda: KF.flash_attention_bwd_plain(
            q, k, v, o, lse, do, win), reps=1, rounds=3)
        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                            enable_gqa=True)
        lib = time_cuda(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True), reps=5)
        n_bytes = (2 * (q.numel() + k.numel() + v.numel())
                   + o.numel() + do.numel()) * q.element_size() \
            + lse.numel() * 4
        b_ms, b_by = bound(n_bytes, flops, ops_s)
        out[name] = (ms, plain, lib, b_ms, b_by, flops / ms / 1e9)
        log(f"[time] flash_attention bwd {shape} {name}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.3f} ms, SDPA "
            f"backward (autograd) {lib:.4f} ms, bound {b_ms:.6f} ms ({b_by}: "
            f"{n_bytes} bytes, {flops} FLOP)")
        del q, k, v, do, o, lse, ql, kl, vl, ol
    ms, plain, lib, b_ms, b_by, tflops = out["bfloat16"]
    f32 = out["float32"]
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:83 (its "
                        "gradient; the TPU kernel has no backward)",
            "launches": launches, "max_abs_err": errs["max_abs_err"],
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib,
            "library": "backward of torch.nn.functional.scaled_dot_product_"
                       "attention(is_causal=True, enable_gqa=True) under "
                       "autograd",
            "shape": list(shape), "dtype": "bfloat16", "tflops": tflops,
            "ms_fp32": f32[0], "plain_ms_fp32": f32[1],
            "library_ms_fp32": f32[2], "bound_ms_fp32": f32[3],
            "bound_by_fp32": f32[4], "shapes": errs["shapes"]}


def ssm_bwd_entry(dev, errs, launches) -> dict:
    """Times of the ssm_scan backward at rwkv6-1.6b's train shape beside
    its bound, its plain version and the autograd backward of the chunked
    torch form (core.linear_attn.wkv_chunked; no library call computes the
    scan)."""
    import torch
    from repro_torch.core import linear_attn as TLA
    from repro_torch.kernels import ssm_scan as KS

    b, t, dk, dv, _ = SCAN_BWD_SHAPES[0]
    g = torch.Generator(device=dev).manual_seed(24)
    r, w, k, v, _, _ = wkv_inputs(b, t, dk, dv, g, dev, False)
    dy = torch.randn((b, t, dv), generator=g, device=dev)
    # the cluster launch: every CTA resident at once at this shape
    occ = KS.bwd_occupancy(b, dv, dev)
    log(f"[train] ssm_scan bwd launch {(b, t, dk, dv)}: grid {occ['grid']} "
        f"CTAs in clusters of {occ['cluster']}, {occ['smem_bytes']} bytes "
        f"of shared memory a CTA; the card holds "
        f"{occ['max_active_clusters']} clusters at once, "
        f"{occ['ctas_per_sm']:.3f} CTAs per SM: one wave {occ['one_wave']}")
    check(occ["one_wave"], "ssm_scan backward: the train shape's CTAs are "
          "not all resident at once")
    # what one call allocates: its outputs and checkpoints, no partial plane
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    KS._backward(r, w, k, v, None, None, dy, None)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    want_bytes = 4 * (3 * b * t * dk + b * t * dv
                      + KS.bwd_scratch_floats(b, t, dv))
    log(f"[train] ssm_scan bwd one call: {extra} bytes allocated beyond the "
        f"inputs (outputs and checkpoints {want_bytes})")
    check(extra <= want_bytes + (4 << 20),
          "ssm_scan backward allocates more than its outputs and checkpoints")
    ms = time_cuda(lambda: KS._backward(r, w, k, v, None, None, dy, None),
                   reps=5)
    plain = time_cuda(lambda: KS.ssm_scan_bwd_plain(r, w, k, v, None, None,
                                                    dy, None),
                      reps=1, rounds=3)
    xs = [x.detach().requires_grad_() for x in (r, w, k, v)]
    yc, _ = TLA.wkv_chunked(*xs, None)
    chunked = time_cuda(lambda: torch.autograd.grad(yc, xs, dy,
                                                    retain_graph=True),
                        reps=5)
    # r, w, k, v and dy read once; dr, dw, dk, dv written once; per step and
    # state element six multiply-adds: the state's recompute, G's two
    # terms, and the dr, dk, dv and dw products
    n_bytes = 4 * b * t * (3 * dk + 2 * dv + 3 * dk + dv)
    b_ms, b_by = bound(n_bytes, 12 * b * t * dk * dv)
    log(f"[time] ssm_scan bwd {(b, t, dk, dv)}: kernel {ms:.4f} ms, plain "
        f"{plain:.3f} ms, wkv_chunked backward (autograd) {chunked:.4f} ms, "
        f"bound {b_ms:.6f} ms ({b_by}); {ms / t * 1e6:.1f} ns per serial "
        f"step")
    return {"name": "ssm_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:58 (its gradient; the "
                        "TPU kernel has no backward)",
            "launches": launches, "max_abs_err": errs["max_rel_err"],
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "chunked_torch_bwd_ms": chunked,
            "shape": [b, t, dk, dv], "ns_per_step": ms / t * 1e6,
            "occupancy": occ, "call_extra_bytes": extra,
            "checkpoint_bytes": 4 * KS.bwd_scratch_floats(b, t, dv),
            "shapes": errs["shapes"]}


def train_on_vs_off(dev, seed, arch, layers, batch) -> dict:
    """One fp32 train step's loss and gradients at full width with the
    kernels on (their backward kernels too) against off (the plain
    versions under autograd), on the same weights and batch."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.data.lm import DataConfig, TokenStream
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.kernels import ssm_scan as KS
    from repro_torch.models import transformer as TT
    from repro_torch.optim import clip_by_global_norm
    from repro_torch.train import step as TS

    full = configs.get_config(arch)
    cfg = dataclasses.replace(full, dtype=torch.float32,
                              num_layers=layers or full.num_layers)
    params = TT.init_model(cfg, torch.Generator(device=dev).manual_seed(
        seed + 200), dev)
    params.requires_grad_(True)
    data = TokenStream(DataConfig(vocab=cfg.vocab, batch=batch,
                                  seq_len=TRAIN_SEQ, seed=seed), device=dev)
    mb = data.batch(0)
    res = {}
    for on in (True, False):
        counts = (KF.launches, KF.bwd_launches, KS.launches, KS.bwd_launches)
        loss, _, _, grads = TS.loss_and_grads(params, cfg, mb,
                                              use_kernels=on)
        torch.cuda.synchronize()
        n = [a - b for a, b in zip((KF.launches, KF.bwd_launches,
                                    KS.launches, KS.bwd_launches), counts)]
        _, gnorm = clip_by_global_norm(dict(grads), float("inf"))
        res[on] = (float(loss), float(gnorm), grads, n)
    worst = max(((name, rel_err(res[True][2][name], res[False][2][name]))
                 for name in res[True][2]), key=lambda x: x[1])
    d_loss = abs(res[True][0] - res[False][0]) / abs(res[False][0])
    d_norm = abs(res[True][1] - res[False][1]) / res[False][1]
    out = {"arch": arch, "layers": cfg.num_layers, "batch": batch,
           "loss": [res[True][0], res[False][0]],
           "grad_norm": [res[True][1], res[False][1]],
           "loss_rel": d_loss, "grad_norm_rel": d_norm,
           "worst_leaf": worst[0], "worst_leaf_rel_err": worst[1],
           "launches_on": res[True][3], "launches_off": res[False][3]}
    log(f"[train] fp32 step {arch} ({cfg.num_layers} layers, {batch} x "
        f"{TRAIN_SEQ}) kernels on/off: loss {res[True][0]} / {res[False][0]}"
        f" (rel {d_loss:.3e}), grad norm {res[True][1]} / {res[False][1]} "
        f"(rel {d_norm:.3e}); worst leaf {worst[0]} {worst[1]:.3e} of its "
        f"max |g|; launches (flash fwd, bwd, scan fwd, bwd) on "
        f"{res[True][3]}, off {res[False][3]}")
    check(d_loss <= TRAIN_ON_OFF_RTOL["loss"]
          and d_norm <= TRAIN_ON_OFF_RTOL["grad_norm"],
          f"{arch} fp32 train step: kernels on and off disagree")
    check(sum(res[False][3]) == 0 and any(res[True][3]),
          f"{arch} fp32 train step: kernel launches on {res[True][3]}, off "
          f"{res[False][3]}")
    del params, res
    return out


def train_launch(dev, seed, arch) -> dict:
    """launch.train at full width and depth in the config's bf16 for
    TRAIN_STEPS steps (remat as the config has it), with the kernels'
    launch counts at 0 just before and read just after; then one more step
    timed, and one under the profiler for each kernel's share."""
    import torch
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.kernels import ssm_scan as KS
    from repro_torch.launch import train as LT
    from repro_torch.models import transformer as TT
    from repro_torch.train import step as TS

    base = memory_reset()
    b = TRAIN_BATCH[arch]
    KF.launches = KF.bwd_launches = KS.launches = KS.bwd_launches = 0
    t0 = time.perf_counter()
    run = LT.run(["--arch", arch, "--steps", str(TRAIN_STEPS), "--batch",
                  str(b), "--seq", str(TRAIN_SEQ), "--log-every", "1",
                  "--warmup", "1", "--seed", str(seed)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": KF.launches,
                "flash_attention_bwd": KF.bwd_launches,
                "ssm_scan": KS.launches, "ssm_scan_bwd": KS.bwd_launches}
    peak = peak_gb(base)
    cfg, res = run["cfg"], run["result"]
    state = res.state
    n_attn = n_layers_of(cfg, lambda sp: sp.mixer == "attn")
    n_rwkv = n_layers_of(cfg, lambda sp: sp.mixer == "rwkv")
    fwd = 2 if cfg.remat else 1
    want = {"flash_attention": fwd * n_attn * TRAIN_STEPS,
            "flash_attention_bwd": n_attn * TRAIN_STEPS,
            "ssm_scan": fwd * n_rwkv * TRAIN_STEPS,
            "ssm_scan_bwd": n_rwkv * TRAIN_STEPS}
    losses = res.losses
    log(f"[train] {arch} bf16 launch.train {b} x {TRAIN_SEQ}, "
        f"{TRAIN_STEPS} steps in {wall:.1f} s (init included): losses "
        f"{losses}; launches {launches} (want {want}); peak device memory "
        f"{peak:.2f} GB")
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x)
                                             for x in losses),
          f"{arch} train losses {losses}")
    check(launches == want, f"{arch} train launches {launches}, want {want}")
    # every parameter moved away from its initial value
    init = TT.init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    moved = {n: float((p.detach() != q).float().mean())
             for (n, p), (_, q) in zip(state.params.named_parameters(),
                                       init.named_parameters())}
    del init
    least = min(moved.items(), key=lambda x: x[1])
    log(f"[train] {arch}: {len(moved)} parameter leaves, each changed in "
        f">= {least[1]:.4f} of its elements ({least[0]} least)")
    check(least[1] > 0.5, f"{arch}: parameter {least[0]} barely changed")

    step = TS.make_train_step(cfg, run["opt_cfg"])
    batch = run["stream"].batch(TRAIN_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3

    def one_step():
        nonlocal state, m
        state, m = step(state, run["stream"].batch(TRAIN_STEPS + 1))
    prof_wall, spans = profiled_again(one_step)
    kernel_us = sum(e - s_ for s_, e, _ in spans)
    parts = {"flash_attention fwd": ("flash_attention_tc_kernel",
                                     "flash_attention_kernel"),
             "flash_attention bwd": ("delta_kernel", "dkdv_kernel",
                                     "dkdv_tc_kernel", "group_sum_kernel",
                                     "dq_kernel", "dq_tc_kernel"),
             "ssm_scan fwd": ("ssm_scan_kernel",),
             "ssm_scan bwd": ("ssm_scan_bwd_kernel", "ssm_bwd_du_kernel")}
    shares = {}
    for part, names in parts.items():
        us = sum(e - s_ for s_, e, nm in spans
                 if any(x in nm for x in names))
        shares[part] = us / kernel_us if kernel_us else 0.0
    tok_s = b * TRAIN_SEQ / (step_ms / 1e3)
    out = {"arch": arch, "batch": b, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "losses": losses, "launches": launches, "wall_s": wall,
           "step_ms": step_ms, "tokens_per_s": tok_s, "peak_gb": peak,
           "profiled_step_ms": prof_wall / 1e3,
           "idle_share": (1 - busy_us(spans) / prof_wall) if spans
                         else None,
           "kernel_shares": shares, "min_changed_share": least[1],
           "params": TT.param_count(state.params)}
    log(f"[train] {arch} bf16 step {b} x {TRAIN_SEQ}: {step_ms:.1f} ms "
        f"({tok_s:.0f} tok/s); profiled {prof_wall / 1e3:.1f} ms, card idle "
        f"{out['idle_share']}; shares of kernel time "
        f"{ {k: round(v, 4) for k, v in shares.items()} }")
    del run, res, state, batch, m
    return out


def train_resume(dev, seed) -> dict:
    """A failure injected at step RESUME_FAIL_AT of a RESUME_STEPS-step run
    of rwkv6-1.6b at full width cut to RESUME_LAYERS layers, with
    checkpoints under build/: the restart restores the newest checkpoint
    onto the card, and every step's loss equals a straight run's."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.data.lm import DataConfig, TokenStream
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import FailureInjector, LoopConfig, train

    base = memory_reset()
    cfg = dataclasses.replace(configs.get_config("rwkv6-1.6b"),
                              num_layers=RESUME_LAYERS)
    ds = TokenStream(DataConfig(vocab=cfg.vocab,
                                batch=TRAIN_BATCH["rwkv6-1.6b"],
                                seq_len=TRAIN_SEQ, seed=seed), device=dev)
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=100)
    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    straight = train(cfg, ds.batch, LoopConfig(total_steps=RESUME_STEPS,
                                               log_every=1), opt, seed=seed,
                     verbose=False, device=dev)
    straight.state = None
    t0 = time.perf_counter()
    failed = train(cfg, ds.batch,
                   LoopConfig(total_steps=RESUME_STEPS,
                              ckpt_every=RESUME_CKPT_EVERY, log_every=1),
                   opt, ckpt_dir=str(ckdir), seed=seed, verbose=True,
                   device=dev,
                   failure_injector=FailureInjector(
                       fail_at=(RESUME_FAIL_AT,)))
    wall = time.perf_counter() - t0
    want = {int(m["step"]): m["loss"] for m in straight.metrics_history}
    got = {int(m["step"]): m["loss"] for m in failed.metrics_history}
    # the first step logged after the failure: the checkpoint's step, not 0
    steps = [int(m["step"]) for m in failed.metrics_history]
    restored_at = steps[RESUME_FAIL_AT] if len(steps) > RESUME_FAIL_AT \
        else None
    on_card = all(p.device.type == "cuda"
                  for p in failed.state.params.parameters())
    bitwise = got == want
    rel = max(abs(got[s_] - want[s_]) / abs(want[s_]) for s_ in want)
    ck_gb = sum(f.stat().st_size for f in ckdir.rglob("*.npy")) / 1e9
    out = {"layers": RESUME_LAYERS, "steps": RESUME_STEPS,
           "fail_at": RESUME_FAIL_AT, "restarts": failed.restarts,
           "losses_straight": [want[s_] for s_ in sorted(want)],
           "losses_resumed": [got.get(s_) for s_ in sorted(want)],
           "restored_at": restored_at, "bitwise": bitwise,
           "max_rel": rel, "wall_s": wall,
           "ckpt_gb_on_disk": ck_gb, "peak_gb": peak_gb(base)}
    log(f"[train] resume {cfg.name} at {RESUME_LAYERS} layers: failure at "
        f"step {RESUME_FAIL_AT}, {failed.restarts} restart(s) from the "
        f"step-{restored_at} checkpoint, final step "
        f"{failed.final_step}; losses straight {out['losses_straight']}, "
        f"resumed {out['losses_resumed']} (bitwise {bitwise}, max rel "
        f"{rel:.3e}); state on the card {on_card}; {ck_gb:.2f} GB of "
        f"checkpoints; {wall:.1f} s")
    check(failed.restarts == 1 and failed.final_step == RESUME_STEPS
          and restored_at == RESUME_CKPT_EVERY
          and set(got) == set(want) and rel <= 1e-5 and on_card,
          "train resume after an injected failure is not exact")
    del failed
    shutil.rmtree(ckdir, ignore_errors=True)
    return out


def train_phase(dev, seed) -> dict:
    """Phase 11 (see its header); returns the two backward kernels' rows
    of the kernels line and the phase's numbers."""
    with timed("backward kernels against plain"):
        flash_errs = check_flash_bwd(dev)
        scan_errs = check_ssm_bwd(dev)
    with timed("train steps on against off"):
        out = {"on_vs_off": [train_on_vs_off(dev, seed, "gemma-2b",
                                             TRAIN_ON_OFF_LAYERS, 2),
                             train_on_vs_off(dev, seed, "rwkv6-1.6b", 4,
                                             4)]}
    memory_reset()
    with timed("launch.train"):
        out["gemma-2b"] = train_launch(dev, seed, "gemma-2b")
        out["rwkv6-1.6b"] = train_launch(dev, seed, "rwkv6-1.6b")
    with timed("train resume"):
        out["resume"] = train_resume(dev, seed)
    memory_reset()
    flash_launches = out["gemma-2b"]["launches"]["flash_attention_bwd"]
    scan_launches = out["rwkv6-1.6b"]["launches"]["ssm_scan_bwd"]
    entries = [flash_bwd_entry(dev, flash_errs, flash_launches),
               ssm_bwd_entry(dev, scan_errs, scan_launches)]
    return {"entries": entries, "train": out}


# --------------------------------------------------------------------------
# phase 12: the launch tools. (a) The dry-run grid: launch.dryrun.run_cell
# on meta at full width for four archs over the four SHAPES. Meta touches no
# card, so the cells run from the smoke's start in GRID_JOBS spawned
# processes at the lowest CPU priority, beside the card phases, and this
# phase collects them. (b) launch.perf on the card at
# two shapes the phases above use: gemma-2b's bf16 prefill and rwkv6-1.6b's
# bf16 train step, each 4 x 2,048. (c) Checks: the walk's aten FLOPs on the
# card are FlopCounterMode's, and the meta walk's FLOPs the card walk's; the
# walk charged each kernel as often as its wrapper's launch counter moved;
# the meta walk's temp bytes are within 10% of what the call adds to the
# card's memory; kernels.work over launch.roofline's H100 figures gives the
# bound() of each kernel row of the kernels line above.
# --------------------------------------------------------------------------

GRID_ARCHS = ("gemma-2b", "rwkv6-1.6b", "olmoe-1b-7b", "jamba-v0.1-52b")
# few enough that the card phases keep most of the host's 8 cores
GRID_JOBS = 3
# (arch, shape, rows, seq, launches the cell must charge)
PERF_CELLS = (("gemma-2b", "prefill_32k", 4, 2048, {"flash_attention": 18}),
              ("rwkv6-1.6b", "train_4k", 4, 2048,
               {"ssm_scan": 48, "ssm_scan_bwd": 24}))
MEMORY_TOL = 0.10
# the roofline numbers the kernels line keeps (the log has the rest)
ROOFLINE_KEEP = ("hlo_flops_per_device", "hlo_bytes_per_device",
                 "model_flops_global", "compute_s", "memory_s", "dominant",
                 "step_lower_bound_s", "useful_flops_ratio")


def grid_cell(arch, shape_name, out_dir):
    """One dry-run cell, in a worker process: its record and seconds."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, shape_name, out_dir=Path(out_dir),
                          verbose=False)
    return rec, time.perf_counter() - t0


def start_grid():
    """Submit every GRID_ARCHS x SHAPES cell to GRID_JOBS spawned processes
    (sys.path passes to them) at nice 19. Returns (executor, cells,
    futures); ``dryrun_grid`` collects them, and ``main`` shuts the
    executor down whatever happens."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch import configs
    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    cells = [(a, s) for a in GRID_ARCHS for s in configs.SHAPES]
    ex = ProcessPoolExecutor(
        GRID_JOBS, mp_context=multiprocessing.get_context("spawn"),
        initializer=os.nice, initargs=(19,))
    futures = [ex.submit(grid_cell, a, s, str(out_dir)) for a, s in cells]
    return ex, cells, futures


def dryrun_grid(grid, smi) -> dict:
    """(a): the grid's records, one line each."""
    from repro_torch.launch import dryrun
    ex, cells, futures = grid
    t0 = time.perf_counter()
    done = [f.result() for f in futures]
    ex.shutdown()
    waited = time.perf_counter() - t0
    recs = []
    for (arch, shape_name), (rec, sec) in zip(cells, done):
        check(rec["status"] in ("OK", "SKIP"),
              f"dry-run {arch} {shape_name}: {rec['status']} "
              f"{rec.get('error', '')}")
        log(f"[launch] dry-run {dryrun.line(rec)} ({sec:.1f} s; {smi})")
        recs.append({k: rec.get(k) for k in (
            "arch", "shape", "status", "kind", "params", "active_params",
            "tokens_per_step", "memory_analysis", "fits_one_card")}
            | {"roofline": {k: v for k, v in rec.get("roofline", {}).items()
                            if k in ROOFLINE_KEEP}, "seconds": sec})
    log(f"[launch] dry-run grid: {len(cells)} cells "
        f"({sum(r['status'] == 'OK' for r in recs)} OK, "
        f"{sum(bool(r['fits_one_card']) for r in recs)} fit one H100), "
        f"{sum(r['seconds'] for r in recs):.1f} s of cells over {GRID_JOBS} "
        f"processes beside the card phases; {waited:.1f} s waited for here")
    return {"cells": recs, "cell_s": sum(r["seconds"] for r in recs),
            "waited_s": waited}


def perf_cell(arch, shape_name, rows, seq, want, smi) -> dict:
    """(b) and (c) for one cell: launch.perf.run on the card, then the
    FLOP, launch and memory checks."""
    from repro_torch.launch import perf
    rec = perf.run(arch, shape_name, batch=rows, seq=seq, topk=12)
    what = f"perf {arch} {shape_name} {rows} x {seq}"
    walk, charged = rec["walk"], {k: v["calls"]
                                  for k, v in rec["walk"]["kernels"].items()}
    log(f"[launch] {what}: aten FLOP {walk['aten_flops']} on the card, "
        f"FlopCounterMode {rec['flop_counter_flops']}; walk FLOP on the card "
        f"{walk['flops']}, on meta {rec['roofline']['hlo_flops_per_device']}"
        f"; charges {charged}, launches {rec['launches']}")
    check(walk["aten_flops"] == rec["flop_counter_flops"],
          f"{what}: the walk's aten FLOPs are not FlopCounterMode's")
    check(walk["flops"] == rec["roofline"]["hlo_flops_per_device"],
          f"{what}: the card walk's FLOPs are not the meta walk's")
    check(charged == rec["launches"] == want,
          f"{what}: charges {charged}, launches {rec['launches']}, want "
          f"{want}")
    meta_temp = rec["memory_analysis"]["temp_size_in_bytes"]
    card = rec["added_bytes"]
    rel = abs(meta_temp - card) / card
    log(f"[launch] {what}: the meta walk's temp {meta_temp} bytes, the call "
        f"adds {card} bytes on the card (max_memory_allocated): "
        f"{rel:.4f} apart")
    check(rel <= MEMORY_TOL, f"{what}: the meta walk's temp bytes are "
          f"{rel:.4f} from the card's, over {MEMORY_TOL}")
    log(f"[launch] {what}: step {rec['step_ms']:.3f} ms (median of 5; each "
        f"{[round(t, 3) for t in rec['step_ms_each']]}), bound "
        f"{rec['bound_ms']:.3f} ms ({rec['roofline']['dominant']}): "
        f"{rec['bound_share']:.4f} of the step ({smi})")
    keep = ("arch", "shape", "batch", "seq", "kind", "params",
            "tokens_per_step", "memory_analysis", "added_bytes", "launches",
            "walk", "flop_counter_flops", "step_ms", "step_ms_each",
            "bound_ms", "bound_share", "stages_s")
    return {k: rec[k] for k in keep} | {"roofline": {
        k: v for k, v in rec["roofline"].items() if k in ROOFLINE_KEEP},
        "memory_rel_diff": rel}


def work_bounds(kernels) -> list:
    """(c): kernels.work at each kernel row's shape, over the H100 figures
    of launch.roofline, against the bound() the phases above computed."""
    from repro_torch.kernels import work
    from repro_torch.launch import roofline
    by = {k["name"]: k for k in kernels}
    b, h, kvh, sq, skv, hd, win = by["flash_attention"]["shape"]
    fb, fh, fkvh, fsq, fskv, fhd, fwin = by["flash_attention_bwd"]["shape"]
    rows = [
        ("chain_scan", by["chain_scan"], work.chain_scan(
            *by["chain_scan"]["shape"]), False, "bound_ms"),
        ("dp_tile", by["dp_tile"], work.dp_tile(*by["dp_tile"]["shape"]),
         False, "bound_ms"),
        ("dp_wavefront", by["dp_wavefront"], work.dp_wavefront(
            *by["dp_wavefront"]["shape"]), False, "bound_ms"),
        ("radix_rank", by["radix_rank"], work.radix_rank(
            *by["radix_rank"]["shape"]), False, "bound_ms"),
        ("radix_sort_chunks", by["radix_sort_chunks"],
         work.radix_sort_chunks(*by["radix_sort_chunks"]["shape"]), False,
         "bound_ms"),
        ("ssm_scan", by["ssm_scan"], work.ssm_scan(*by["ssm_scan"]["shape"]),
         False, "bound_ms"),
        ("flash_attention", by["flash_attention"], work.flash_attention(
            b, h, kvh, sq, skv, hd, win, 2), True, "bound_ms"),
        ("flash_attention_bwd", by["flash_attention_bwd"],
         work.flash_attention_bwd(fb, fh, fkvh, fsq, fskv, fhd, fwin, 2),
         True, "bound_ms"),
        ("ssm_scan_bwd", by["ssm_scan_bwd"], work.ssm_scan_bwd(
            *by["ssm_scan_bwd"]["shape"]), False, "bound_ms"),
        # the rows' other bounds: 64 radix chunks, fp32 attention
        ("radix_rank at 64 chunks", by["radix_rank"]["at_64_chunks"],
         work.radix_rank(*by["radix_rank"]["at_64_chunks"]["shape"]), False,
         "bound_ms"),
        ("flash_attention fp32", by["flash_attention"], work.flash_attention(
            b, h, kvh, sq, skv, hd, win, 4), False, "bound_ms_fp32"),
        ("flash_attention_bwd fp32", by["flash_attention_bwd"],
         work.flash_attention_bwd(fb, fh, fkvh, fsq, fskv, fhd, fwin, 4),
         False, "bound_ms_fp32"),
    ]
    out = []
    for name, entry, w, tc, key in rows:
        got = roofline.kernel_bound_s(w.flops, w.bytes, tc) * 1e3
        want = entry[key]
        rel = abs(got - want) / want
        log(f"[launch] kernels.work {name} {entry['shape']}: {w.flops} "
            f"FLOP, {w.bytes} bytes, bound {got:.9f} ms; bound() gave "
            f"{want:.9f} ms ({rel:.2e} apart)")
        check(rel <= 1e-9, f"kernels.work's bound of {name} is {got} ms, "
              f"bound() gave {want} ms")
        out.append({"name": name, "flops": w.flops, "bytes": w.bytes,
                    "bound_ms": got, "smoke_bound_ms": want})
    return out


def launch_tools_phase(grid, kernels, smi) -> dict:
    """Phase 12 (see its header); ``grid`` is ``start_grid``'s."""
    out = {"grid": dryrun_grid(grid, smi)}
    memory_reset()
    out["perf"] = [perf_cell(*cell, smi) for cell in PERF_CELLS]
    memory_reset()
    out["work_bounds"] = work_bounds(kernels)
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
    grid = start_grid()
    try:
        return smoke(args, grid)
    finally:
        grid[0].shutdown(cancel_futures=True)


def smoke(args, grid) -> int:
    """Every phase in order; ``grid`` is the dry-run grid already running
    (``start_grid``)."""
    import torch
    from repro_torch.data import genomics
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)

    # a build of its own, every run, so that ptxas reports on every kernel
    build_dir = ROOT / "build" / "chip_smoke"
    shutil.rmtree(build_dir, ignore_errors=True)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build_dir)
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.2f} s")
    ptxas = {name: ptxas_summary(text)
             for name, text in _build.PTXAS_LOG.items()}
    for name, fns in ptxas.items():
        for fn, info in fns.items():
            log(f"[build] {name} {fn}: {info.get('registers')} registers, "
                f"{info.get('spill_bytes')} spill bytes, "
                f"{info.get('static_smem_bytes')} bytes static shared memory")
    for name in ("chain_scan", "ssm_scan", "flash_attention_bwd",
                 "ssm_scan_bwd"):
        check(ptxas[name] and all(info.get("spill_bytes") == 0
                                  for info in ptxas[name].values()),
              f"{name} spills registers (or ptxas did not report)")
    # the WKV backward is one kernel (with u, the du pass after it): no
    # column-partial pass is built
    scan_fns = list(ptxas["ssm_scan_bwd"])
    check(all("ssm_scan_bwd_kernel" in fn or "ssm_bwd_du_kernel" in fn
              for fn in scan_fns),
          f"ssm_scan_bwd builds other kernels: {scan_fns}")
    hgmma = sass_hgmma(_build)
    for lib, fns in hgmma.items():
        for fn, info in fns.items():
            log(f"[build] sass {lib} {fn}: {info['hgmma']} HGMMA, first: "
                f"{info['first']}")
    # five head dims: the forward's kernel, the backward's two
    check(len(hgmma["flash_attention"]) == 5
          and len(hgmma["flash_attention_bwd"]) == 10
          and all(v["hgmma"] for fns in hgmma.values()
                  for v in fns.values()),
          "a bf16 flash_attention kernel (forward or backward) shows no "
          "HGMMA in its SASS")

    with timed("check_kernels"):
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
    with timed("reference and main path"):
        mapper, launches, max_n, max_align, results = map_main_path(
            reference, reads, dev)

    with timed("service and rank path"):
        svc_info = service_phase(mapper, reads[1:], results, dev, args.seed)
        rank_info = rank_path(svc_info.pop("sort"), dev)

    with timed("kernels on against off"):
        kernels_on_vs_off(mapper, reads[1:], dev)

    t_paper = time.perf_counter()
    paper = paper_kernels(dev, args.seed)
    log(f"[paper] phase took {time.perf_counter() - t_paper:.1f} s")

    with timed("kernel timings"):
        line = kernel_line(dev, launches, errs, max_n, max_align)
        line["kernels"].extend(radix_entries(dev, rank_info, errs))
    by_name = {k["name"]: k for k in line["kernels"]}
    for name in ("chain_scan", "dp_wavefront", "dp_tile"):
        by_name[name]["service_launches"] = svc_info["launches"][name]
    by_name["chain_scan"]["ptxas"] = ptxas["chain_scan"]
    line["service"] = svc_info["per_kernel"]
    line["mesh_dispatch"] = svc_info["mesh_dispatch"]
    line["paper_kernels"] = paper
    longest = max((r for _, (r, _) in reads[1:]), key=len)
    with timed("read traces"):
        traces = [device_trace(mapper, reads[1][1][0][:2000]),
                  device_trace(mapper, longest)]
    by_name["dp_wavefront"]["device_ms_longest_read"] = \
        traces[1]["align_device_ms"]
    line["align_trace"] = traces
    del mapper
    torch.cuda.empty_cache()

    t_lm = time.perf_counter()
    with timed("lm fp32 arms"):
        on_off = lm_kernel_vs_plain(dev, args.seed)
    with timed("lm bf16 serving"):
        lm = lm_serving(dev, args.seed)
    lm["fp32_kernel_vs_plain"] = on_off
    lm["launches"]["paged_scheduler"] = on_off["paged"]["launches"]
    lm["launches"]["sharded_scheduler"] = on_off["sharded"]["launches"]
    line["kernels"].append(ssm_scan_entry(dev, errs, lm))
    line["kernels"][-1]["ptxas"] = ptxas["ssm_scan"]
    line["lm"] = lm
    log(f"[lm] phase took {time.perf_counter() - t_lm:.1f} s")

    t_attn = time.perf_counter()
    with timed("attn fp32 arms"):
        attn_on_off = attn_kernel_vs_plain(dev, args.seed)
    with timed("attn bf16 serving"):
        attn = attn_serving(dev, args.seed)
    attn["fp32_kernel_vs_blockwise"] = attn_on_off
    line["kernels"].append(flash_attention_entry(dev, errs, attn))
    line["attn_lm"] = attn
    log(f"[attn] phase took {time.perf_counter() - t_attn:.1f} s")

    t_ring = time.perf_counter()
    line["ring_lm"] = ring_phase(dev, args.seed)
    log(f"[ring] phase took {time.perf_counter() - t_ring:.1f} s")

    t_obs = time.perf_counter()
    line["spec_ring_lm"] = spec_ring(dev, args.seed)
    line["obs_autotune"] = obs_autotune(dev, args.seed)
    by_name["dp_wavefront"]["resweep_launches"] = \
        line["obs_autotune"]["dp_wavefront_launches"]
    log(f"[obs] gemma3-12b speculation and autotune phases took "
        f"{time.perf_counter() - t_obs:.1f} s")

    t_moe = time.perf_counter()
    for key, phase in (("moe_lm", moe_phase), ("hybrid_lm", hybrid_phase),
                       ("embeds_lm", embeds_phase)):
        t0 = time.perf_counter()
        line[key] = phase(dev, args.seed)
        log(f"[{key}] phase took {time.perf_counter() - t0:.1f} s")
    flash = next(k for k in line["kernels"] if k["name"] == "flash_attention")
    flash["path_launches"] = {
        "moe_lm": {"fp32_prefill": line["moe_lm"]["fp32_kernel_vs_plain"][
            "launches"]["kernel"], **line["moe_lm"]["serve"]["launches"]},
        "hybrid_lm": {"fp32_prefill": line["hybrid_lm"][
            "fp32_kernel_vs_plain"]["launches"]["kernel"],
            **line["hybrid_lm"]["serve"]["launches"]},
        "embeds_lm": {"fp32_prefill": line["embeds_lm"][
            "fp32_kernel_vs_plain"]["launches"]["kernel"],
            **line["embeds_lm"]["launches"]}}
    log(f"[moe] the MoE, hybrid and embeds phases took "
        f"{time.perf_counter() - t_moe:.1f} s")

    t_train = time.perf_counter()
    train = train_phase(dev, args.seed)
    line["kernels"].extend(train["entries"])
    line["kernels"][-2]["ptxas"] = ptxas["flash_attention_bwd"]
    line["kernels"][-2]["sass_hgmma"] = {
        fn: v["hgmma"] for fn, v in hgmma["flash_attention_bwd"].items()}
    line["kernels"][-1]["ptxas"] = ptxas["ssm_scan_bwd"]
    line["train_lm"] = train["train"]
    # the forward kernels' launches on the train path (2 a layer a step)
    flash["path_launches"]["train_lm"] = \
        train["train"]["gemma-2b"]["launches"]["flash_attention"]
    next(k for k in line["kernels"] if k["name"] == "ssm_scan")[
        "path_launches"] = {"train_lm": train["train"]["rwkv6-1.6b"][
            "launches"]["ssm_scan"]}
    log(f"[train] phase took {time.perf_counter() - t_train:.1f} s")

    t_launch = time.perf_counter()
    line["launch_tools"] = launch_tools_phase(grid, line["kernels"], smi)
    log(f"[launch] phase took {time.perf_counter() - t_launch:.1f} s")
    log(f"[time] chip_smoke took {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
