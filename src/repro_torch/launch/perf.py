"""One cell's step, measured on the card against its walk and its bound
(port of ``repro.launch.perf``).

Where the reference lowers a cell for its pod and prints the HLO walk's
profile, this walks the cell's step on meta (as ``launch.dryrun`` does),
then runs the same step on the card on random weights from ``--seed`` and
prints:

  * the walk's top-k byte contributors (aten ops by result type, and the
    kernels' charges);
  * the top-k device kernels of a ``torch.profiler`` window over one step;
  * the three roofline terms (``launch.roofline``, H100), and the aten
    FLOPs of one call walked on the device beside ``FlopCounterMode``'s
    count of the same call;
  * the step's time (CUDA events, median of 5 warm calls) and its share of
    the bound, and the bytes the call adds to the card's memory beside the
    walk's temp bytes.

A pod-scale shape does not fit one card, so ``--batch`` and ``--seq``
(default: the shape's own) stand in for the share of the global batch that
one chip holds in the reference's mesh. ``--rules`` and ``--multi`` need
more than one card (``ROADMAP.md`` queue 1 item 4) and raise.

  python -m repro_torch.launch.perf --arch gemma-2b --shape prefill_32k \\
      --batch 4 --seq 2048
  python -m repro_torch.launch.perf --arch rwkv6-1.6b --shape train_4k \\
      --batch 4 --seq 2048 --cfg '{"dtype": "bfloat16"}' --tag bf16
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import time
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import flash_attention as KF
from repro_torch.kernels import ssm_scan as KS
from repro_torch.launch import dryrun, op_analysis, specs
from repro_torch.models import transformer as T
from repro_torch.train import step as train_step_lib

PERF_DIR = Path(__file__).resolve().parents[3] / "experiments" / "perf_torch"


def _launch_counts() -> dict:
    return {"flash_attention": KF.launches,
            "flash_attention_bwd": KF.bwd_launches,
            "ssm_scan": KS.launches, "ssm_scan_bwd": KS.bwd_launches}


def card_cell(cfg: ModelConfig, shape: ShapeConfig, device: DeviceLike,
              seed: int = 0):
    """``dryrun.build_cell`` with real tensors on ``device``: weights (or
    the train state) drawn from ``seed``, random tokens, labels or
    embeddings, zero caches at position 0."""
    dev = resolve_device(device)
    g = torch.Generator(dev).manual_seed(seed)
    fn, tokens, kind = dryrun.step_fn(cfg, shape)
    ins = specs.input_specs(cfg, shape, dev)
    for part in ("batch", "inp"):
        for x in ins.get(part, {}).values():
            if x.is_floating_point():
                x.normal_(generator=g)
            else:
                x.random_(0, cfg.vocab, generator=g)
    if kind == "train":
        state = train_step_lib.init_train_state(cfg, g, device=dev)
        return fn, (state, ins["batch"]), tokens, kind
    params = T.init_model(cfg, g, dev)
    if kind == "prefill":
        return fn, (params, ins["batch"]), tokens, kind
    ins["pos"].zero_()
    return fn, (params, ins["caches"], ins["inp"], ins["pos"]), tokens, kind


def walk_and_count(fn, args):
    """One call walked by ``op_analysis`` inside
    ``torch.utils.flop_counter.FlopCounterMode``: both see the same aten
    ops of the same call. Returns (ModuleCost, FlopCounterMode's FLOPs)."""
    from torch.utils.flop_counter import FlopCounterMode
    mode = FlopCounterMode(display=False)
    with mode:
        cost = op_analysis.analyze(fn, *args)
    cost.result = None
    return cost, int(mode.get_total_flops())


def added_bytes(fn, args) -> int:
    """What one call adds to the card's allocated memory at its peak:
    ``max_memory_allocated`` after a reset, less what was allocated
    before the call."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return int(peak)


def step_ms(fn, args, calls: int = 5) -> list:
    """Milliseconds of each of ``calls`` calls, by CUDA events."""
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def profile_kernels(fn, args, k: int) -> list:
    """The top-k device kernels of one call under ``torch.profiler``:
    [(name, total us, count)] by total device time, read from the raw
    Kineto events (building the profiler's event tree for a train step's
    25,000 kernels takes longer than the step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            rec = by_name.setdefault(e.name(), [0.0, 0])
            rec[0] += e.duration_ns() / 1e3
            rec[1] += 1
    rows = sorted(((n, us, c) for n, (us, c) in by_name.items()),
                  key=lambda r: -r[1])
    return rows[:k]


def run(arch: str, shape_name: str, batch: int | None = None,
        seq: int | None = None, cfg_patch: dict | None = None,
        topk: int = 20, seed: int = 0, device: DeviceLike = None,
        reduced: bool = False, verbose: bool = True) -> dict:
    """Walk the cell on meta, run it on ``device`` (default the card) and
    return the readings (see the module docstring)."""
    dev = resolve_device(device)
    cfg = dryrun.patched_config(arch, cfg_patch, reduced)
    base = configs.SHAPES[shape_name]
    shape = dataclasses.replace(base, seq_len=seq or base.seq_len,
                                global_batch=batch or base.global_batch)
    stages = {}
    t0 = time.perf_counter()
    fn, args, tokens, kind = dryrun.build_cell(cfg, shape)
    meta = op_analysis.analyze(fn, *args)
    params = args[0].params if kind == "train" else args[0]
    rec = dryrun.cell_record(cfg, meta, params, tokens, kind)
    del fn, args, params, meta.result
    rec.update(arch=arch, shape=shape_name, batch=shape.global_batch,
               seq=shape.seq_len, cfg_patch=cfg_patch,
               top_bytes=meta.top_bytes(topk), stages_s=stages)
    stages["meta_walk"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    fn, args, _, _ = card_cell(cfg, shape, dev, seed)
    for _ in range(2):                  # builds, workspaces, autotuning
        fn(*args)
    on_card = dev.type == "cuda"
    if on_card:
        rec["added_bytes"] = added_bytes(fn, args)
    stages["init_warm_memory"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    before = _launch_counts()
    walked, rec["flop_counter_flops"] = walk_and_count(fn, args)
    rec["launches"] = {n: c - before[n] for n, c in _launch_counts().items()
                       if c != before[n]}
    rec["walk"] = {"aten_flops": walked.aten_flops, "flops": walked.flops,
                   "bytes": walked.bytes, "kernels": walked.kernels}
    del walked
    stages["device_walk"] = time.perf_counter() - t0
    if on_card:
        t0 = time.perf_counter()
        times = step_ms(fn, args)
        rec["step_ms_each"] = times
        rec["step_ms"] = statistics.median(times)
        rec["bound_ms"] = rec["roofline"]["step_lower_bound_s"] * 1e3
        rec["bound_share"] = rec["bound_ms"] / rec["step_ms"]
        stages["timed_steps"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["profile_top"] = profile_kernels(fn, args, topk)
        stages["profile"] = time.perf_counter() - t0
    if verbose:
        report(rec)
    return rec


def report(rec: dict) -> None:
    mem, rf = rec["memory_analysis"], rec["roofline"]
    print(f"[perf] {rec['arch']} {rec['shape']} at {rec['batch']} x "
          f"{rec['seq']} ({rec['kind']}): {dryrun.line(rec)}")
    print(f"\n=== top-{len(rec['top_bytes'])} byte contributors (meta "
          "walk) ===")
    for desc, b in rec["top_bytes"]:
        print(f"  {b / 1e9:10.3f} GB  {desc}")
    if "profile_top" in rec:
        print(f"\n=== top-{len(rec['profile_top'])} device kernels "
              "(torch.profiler, one step) ===")
        for name, us, count in rec["profile_top"]:
            print(f"  {us / 1e3:10.3f} ms  x{count:<5d} {name[:100]}")
    print("\n=== roofline (H100) ===")
    print(f"  compute={rf['compute_s'] * 1e3:.3f}ms "
          f"memory={rf['memory_s'] * 1e3:.3f}ms "
          f"collective={rf['collective_s'] * 1e3:.3f}ms "
          f"dominant={rf['dominant']} "
          f"useful_flops_ratio={rf['useful_flops_ratio']:.3f}")
    print(f"  walk of a call on the device: {rec['walk']['aten_flops']} aten "
          f"FLOP (FlopCounterMode on the same call "
          f"{rec['flop_counter_flops']}), kernels "
          f"{ {k: v['calls'] for k, v in rec['walk']['kernels'].items()} }, "
          f"launches {rec['launches']}")
    if "step_ms" in rec:
        print(f"  step {rec['step_ms']:.3f} ms (median of 5), bound "
              f"{rec['bound_ms']:.3f} ms: {rec['bound_share']:.4f} of it; "
              f"the call adds {rec['added_bytes'] / 1e9:.3f} GB on the "
              f"card, the walk's temp {mem['temp_size_in_bytes'] / 1e9:.3f} "
              "GB")
    print(f"  stages (s): "
          f"{ {k: round(v, 2) for k, v in rec['stages_s'].items()} }")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--batch", type=int, default=None,
                    help="rows on the card (default: the shape's global "
                         "batch)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default: the shape's)")
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--rules", default=None, help="JSON rule overrides")
    ap.add_argument("--cfg", default=None, help="JSON ModelConfig patch")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--topk", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default the card; 'cpu' runs the plain versions")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (a CPU check)")
    args = ap.parse_args(argv)
    if args.multi or args.rules:
        raise NotImplementedError(dryrun.MULTI_CARD)
    cfg_patch = json.loads(args.cfg) if args.cfg else None
    rec = run(args.arch, args.shape, args.batch, args.seq, cfg_patch,
              args.topk, args.seed, args.device, args.reduced)
    PERF_DIR.mkdir(parents=True, exist_ok=True)
    out = PERF_DIR / f"{args.arch}__{args.shape}__{args.tag}.json"
    out.write_text(json.dumps(rec, indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
