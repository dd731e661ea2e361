#!/usr/bin/env python3
"""Where the WKV backward kernel's time goes, measured on one NVIDIA GPU.

Builds ``src/repro_torch/kernels/csrc/ssm_scan_bwd.cu`` as committed and
variants of it, each made by replacing one piece of the source. Ablations
(their gradients are wrong; they time what is left without the piece):

- ``no_pass1_steps``: the forward rerun's steps (checkpoints still stored);
- ``no_recompute``: each chunk's recompute of its states into the stash;
- ``no_bwd_steps``: the backward steps (G, dv, and the column sums);
- ``no_cluster_sum``: the cluster's sum of each chunk's column sums (the
  loads from the ranks' shared memory and the stores of dr, dk, dw);
- ``no_cluster_sync``: the same, and the cluster barriers.

Candidates (held to the plain backward, then timed):

- ``cp4``: the inputs staged by 4-byte cp.async, as where dk or dv is
  not a multiple of 4, instead of 16-byte pieces.

For each build, at rwkv6-1.6b's train shape (128, 2048, 64, 64): the
kernel's milliseconds (CUDA events, median of 5 rounds of 5 launches),
the builds timed in turns twice. Prints one JSON object a line, the card's
name and power limit last.

    python3 tools/ssm_bwd_design.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def variants(src: str) -> dict:
    def sub(old, new, text=src):
        if old not in text:
            raise SystemExit(f"ssm_bwd_design: the source no longer holds "
                             f"{old[:60]!r}")
        return text.replace(old, new)
    no_sum = src
    for piece in ("sum.load(sm.rows[(c + 1) & 1], rank);",
                  "sum.store(rank, t0 + kC, min(kC, T - t0 - kC), dk, dr, "
                  "dk_out, dw);",
                  "sum.load(sm.rows[0], rank);",
                  "sum.store(rank, 0, min(kC, T), dk, dr, dk_out, dw);"):
        no_sum = sub(piece, ";", no_sum)
    no_sync = sub('asm volatile("barrier.cluster.arrive.release.aligned;\\n"'
                  ' ::: "memory");', "",
                  sub('asm volatile("barrier.cluster.wait.acquire.aligned;'
                      '\\n" ::: "memory");', "", no_sum))
    return {
        "committed": src,
        "no_pass1_steps": sub(
            "for (int tt = tc; tt < n; ++tt) fwd_step(S, tt, a, cb, s);", "",
            sub("#pragma unroll\n        for (int tt = 0; tt < kC; ++tt) "
                "fwd_step(S, tc + tt, a, cb, s);", "")),
        "no_recompute": sub("stash_step(sm, S, tt, tid, a, cb, s);", ";"),
        "no_bwd_steps": sub("bwd_step(sm, S, rows, tt, tid, uu, g, du_acc);",
                            ";"),
        "no_cluster_sum": no_sum,
        "no_cluster_sync": no_sync,
        "cp4": sub("const int vec = dk % 4 == 0", "const int vec = 0 && dk % 4 == 0"),
    }


CANDIDATES = ("committed", "cp4")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssm_bwd_design: torch.cuda.is_available() is False; this "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssm_scan as KS

    out = ROOT / "build" / "ssm_bwd_design"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "ssm_scan_bwd.cu").read_text()
    procs = {}
    for name, text in variants(src).items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ptxas = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            raise SystemExit(f"ssm_bwd_design: {name} does not build")
        ptxas[name] = CS.ptxas_summary(log)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(24)
    b, t, dk, dv = 128, 2048, 64, 64
    r, w, k, v, _, _ = CS.wkv_inputs(b, t, dk, dv, g, dev, False)
    dy = torch.randn((b, t, dv), generator=g, device=dev)
    want = KS.ssm_scan_bwd_plain(r, w, k, v, None, None, dy, None)

    def use(name):
        _build._LIBS["ssm_scan_bwd"] = ctypes.CDLL(str(out / f"lib{name}.so"))
        _build._FUNCS.clear()

    for name in CANDIDATES:
        use(name)
        got = KS._backward(r, w, k, v, None, None, dy, None)
        err = max(CS.rel_err(a, c) for a, c in zip(got, want)
                  if c is not None)
        CS.check(err <= CS.SCAN_BWD_TOL, f"{name} differs from the plain "
                 f"backward ({err})")
    times = {name: [] for name in procs}
    for _ in range(2):
        for name in procs:
            use(name)
            times[name].append(CS.time_cuda(
                lambda: KS._backward(r, w, k, v, None, None, dy, None),
                reps=5))
    for name in procs:
        regs = max(i.get("registers", 0) for i in ptxas[name].values())
        print(json.dumps({"build": name, "shape": [b, t, dk, dv],
                          "ms": times[name], "registers": regs}), flush=True)
    print(CS.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
