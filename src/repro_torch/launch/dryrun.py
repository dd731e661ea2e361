"""Dry run of every (arch x shape) cell on one H100, on the meta device
(port of ``repro.launch.dryrun``).

For each cell this builds the port's train, prefill or decode step over
meta stand-ins (``launch.specs``: nothing allocated), walks one call of it
op by op (``launch.op_analysis``, the kernels charged their
``kernels.work``) and records the walk's memory, its FLOPs and bytes and
the H100 roofline terms (``launch.roofline``) into
``<out>/<arch>__<shape>__single.json``. The reference lowers and compiles
each cell for a 256- or 512-chip mesh; here the cell is the whole global
batch on one card, so most cells do not fit it. ``fits_one_card`` says
which do (argument plus temp bytes within the card's 80 GB): a finding to
print, not a failure. More than one card (``--mesh multi``, sharding rule
overrides) waits for ``ROADMAP.md`` queue 1 item 4.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape prefill_32k
  python -m repro_torch.launch.dryrun --all --out /tmp/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig, ShapeConfig, shape_applicable
from repro_torch.device import DeviceLike
from repro_torch.launch import op_analysis, roofline, specs
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig
from repro_torch.serve import engine
from repro_torch.train import step as train_step_lib

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
CARD_BYTES = 80e9            # H100 SXM data sheet: 80 GB of HBM3
MULTI_CARD = ("more than one card (meshes, sharding rules, the collective "
              "term) is ROADMAP.md queue 1 item 4, not ported yet")


def patched_config(arch: str, cfg_patch: dict | None = None,
                   reduced: bool = False) -> ModelConfig:
    """The arch's config (or its reduced one) with ``cfg_patch`` applied;
    a ``dtype`` given by name becomes the torch dtype."""
    cfg = configs.reduced_config(arch) if reduced else configs.get_config(arch)
    patch = dict(cfg_patch or {})
    if isinstance(patch.get("dtype"), str):
        patch["dtype"] = getattr(torch, patch["dtype"])
    return dataclasses.replace(cfg, **patch) if patch else cfg


def step_fn(cfg: ModelConfig, shape: ShapeConfig):
    """The cell's step: (fn, tokens_per_step, kind)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return (train_step_lib.make_train_step(cfg, AdamWConfig()), b * s,
                "train")
    if shape.kind == "prefill":
        return engine.make_prefill_step(cfg, cache_slots=s), b * s, "prefill"
    return engine.make_decode_step(cfg), b, "decode"


def build_cell(cfg: ModelConfig, shape: ShapeConfig,
               device: DeviceLike = specs.META):
    """Returns (fn, example_args, tokens_per_step, kind), the args on
    ``device`` (meta: stand-ins, nothing drawn)."""
    fn, tokens, kind = step_fn(cfg, shape)
    ins = specs.input_specs(cfg, shape, device)
    if kind == "train":
        args = (specs.train_state_specs(cfg, device), ins["batch"])
    elif kind == "prefill":
        args = (specs.params_specs(cfg, device), ins["batch"])
    else:
        args = (specs.params_specs(cfg, device), ins["caches"], ins["inp"],
                ins["pos"])
    return fn, args, tokens, kind


def cell_record(cfg: ModelConfig, cost: op_analysis.ModuleCost, params,
                tokens: int, kind: str) -> dict:
    """A cell's numbers from its walk: the reference's record keys with
    ``chips`` = 1, plus ``fits_one_card`` and the kernels' charges."""
    n_active = T.active_param_count(params, cfg)
    summary = roofline.summarize(cost, n_active, tokens,
                                 "train" if kind == "train" else "inference")
    summary["hlo_flops_global"] = summary["hlo_flops_per_device"]
    summary["useful_flops_ratio"] = (
        summary["model_flops_global"] / summary["hlo_flops_global"]
        if summary["hlo_flops_global"] else 0.0)
    summary["kernels"] = cost.kernels
    mem = cost.memory_analysis()
    need = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    return {"status": "OK", "kind": kind, "chips": 1,
            "params": T.param_count(params), "active_params": n_active,
            "tokens_per_step": tokens, "memory_analysis": mem,
            "fits_one_card": need <= CARD_BYTES, "roofline": summary}


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             out_dir: Path = OUT_DIR, verbose: bool = True,
             rule_overrides: dict | None = None,
             cfg_patch: dict | None = None, tag: str = "") -> dict:
    """Walk one cell on meta and write its record.

    ``cfg_patch``: dataclasses.replace fields on the ModelConfig. ``tag``:
    suffix for the output json. ``multi_pod`` and ``rule_overrides`` need
    more than one card and raise ``NotImplementedError``.
    """
    if multi_pod or rule_overrides:
        raise NotImplementedError(MULTI_CARD)
    cfg = patched_config(arch, cfg_patch)
    shape = configs.SHAPES[shape_name]
    mesh_name = "single" + (f"__{tag}" if tag else "")
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "rule_overrides": None, "cfg_patch": cfg_patch}

    skip = shape_applicable(cfg, shape)
    if skip:
        rec.update(status="SKIP", reason=skip)
        return rec
    try:
        t0 = time.perf_counter()
        fn, args, tokens, kind = build_cell(cfg, shape)
        t_build = time.perf_counter() - t0
        cost = op_analysis.analyze(fn, *args)
        t_walk = time.perf_counter() - t0 - t_build
        params = args[0].params if kind == "train" else args[0]
        rec.update(cell_record(cfg, cost, params, tokens, kind),
                   build_s=round(t_build, 2), walk_s=round(t_walk, 2))
        if verbose:
            print(f"  {line(rec)}")
    except Exception as e:
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])

    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
    out.write_text(json.dumps(rec, indent=2, default=str))
    return rec


def line(rec: dict) -> str:
    """One cell on one line: FLOPs, bytes, argument and temp GB, the
    dominant term and whether it fits one card."""
    if rec["status"] != "OK":
        return f"{rec['arch']} {rec['shape']}: {rec['status']}"
    rf, mem = rec["roofline"], rec["memory_analysis"]
    return (f"{rec['arch']} {rec['shape']}: {rf['hlo_flops_per_device']:.4e} "
            f"FLOP, {rf['hlo_bytes_per_device']:.4e} bytes, arguments "
            f"{mem['argument_size_in_bytes'] / 1e9:.2f} GB, temp "
            f"{mem['temp_size_in_bytes'] / 1e9:.2f} GB; compute "
            f"{rf['compute_s'] * 1e3:.2f} ms, memory "
            f"{rf['memory_s'] * 1e3:.2f} ms, dominant {rf['dominant']}; "
            f"fits one H100: {rec['fits_one_card']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=("single", "multi",
                                                         "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    if args.mesh != "single":
        raise NotImplementedError(MULTI_CARD)
    out_dir = Path(args.out)

    archs = configs.ARCH_NAMES if (args.all or not args.arch) \
        else (args.arch,)
    shapes = tuple(configs.SHAPES) if (args.all or not args.shape) \
        else (args.shape,)

    results = []
    for arch in archs:
        for shape_name in shapes:
            tag = f"{arch}__{shape_name}__single"
            path = out_dir / f"{tag}.json"
            if path.exists() and not args.force:
                rec = json.loads(path.read_text())
                if rec.get("status") in ("OK", "SKIP"):
                    print(f"[cached] {tag}: {rec['status']}")
                    results.append(rec)
                    continue
            print(f"[run] {tag}")
            t0 = time.perf_counter()
            rec = run_cell(arch, shape_name, out_dir=out_dir)
            print(f"  -> {rec['status']} ({time.perf_counter() - t0:.1f}s)"
                  + (f" {rec.get('error', '')}"
                     if rec["status"] == "FAIL" else ""))
            results.append(rec)

    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    n_fit = sum(bool(r.get("fits_one_card")) for r in results)
    print(f"\n=== dry-run: {n_ok} OK ({n_fit} fit one H100), {n_skip} SKIP "
          f"(documented), {n_fail} FAIL of {len(results)} cells ===")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
