"""Render the dry run's tables from its records (port of
``repro.launch.report``), with a "fits one H100" column.

    PYTHONPATH=src python -m repro_torch.launch.report [--out DIR]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import OUT_DIR


def load(out_dir: Path = OUT_DIR, mesh: str = "single"):
    return [json.loads(f.read_text())
            for f in sorted(Path(out_dir).glob(f"*__{mesh}.json"))]


def dryrun_table(out_dir: Path = OUT_DIR, mesh: str = "single") -> str:
    out = ["| arch | shape | status | params | GB arguments | GB temp | "
           "GFLOP | GB moved | GB coll | fits one H100 |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in load(out_dir, mesh):
        if r["status"] != "OK":
            out.append(f"| {r['arch']} | {r['shape']} | {r['status']} | — | "
                       "— | — | — | — | — | — |")
            continue
        mem, rf = r["memory_analysis"], r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | OK | "
            f"{r['params'] / 1e9:.2f}B | "
            f"{mem['argument_size_in_bytes'] / 1e9:.1f} | "
            f"{mem['temp_size_in_bytes'] / 1e9:.1f} | "
            f"{rf['hlo_flops_per_device'] / 1e9:.0f} | "
            f"{rf['hlo_bytes_per_device'] / 1e9:.0f} | "
            f"{rf['collective_bytes_per_device'] / 1e9:.1f} | "
            f"{'yes' if r['fits_one_card'] else 'no'} |")
    return "\n".join(out)


def roofline_table(out_dir: Path = OUT_DIR, mesh: str = "single") -> str:
    out = ["| arch | shape | compute (ms) | memory (ms) | collective (ms) "
           "| dominant | bound (ms) | compute/bound | useful FLOPs "
           "| fits one H100 |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in load(out_dir, mesh):
        if r["status"] != "OK":
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s'] * 1e3:.1f} | "
            f"{rf['memory_s'] * 1e3:.1f} | {rf['collective_s'] * 1e3:.1f} | "
            f"{rf['dominant']} | {rf['step_lower_bound_s'] * 1e3:.1f} | "
            f"{rf['compute_fraction_of_bound']:.3f} | "
            f"{rf['useful_flops_ratio']:.2f} | "
            f"{'yes' if r['fits_one_card'] else 'no'} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="the dry run's record directory")
    ap.add_argument("--what", default="both",
                    choices=("dryrun", "roofline", "both"))
    args = ap.parse_args(argv)
    if args.what in ("dryrun", "both"):
        print(dryrun_table(Path(args.out), args.mesh))
        print()
    if args.what in ("roofline", "both"):
        print(roofline_table(Path(args.out), args.mesh))


if __name__ == "__main__":
    main()
