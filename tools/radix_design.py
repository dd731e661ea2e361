#!/usr/bin/env python3
"""The radix kernels' design choices, measured on one NVIDIA GPU.

Builds ``src/repro_torch/kernels/csrc/radix_rank.cu`` as committed and
four variants of it, each made by replacing one piece of the source:

- ``release_acquire``: the status words stored with ``st.release.gpu`` and
  read with ``ld.acquire.gpu`` instead of relaxed accesses;
- ``direct_scatter``: radix_pass writes each key and value straight to its
  place from the thread that ranked it, without staging the tile in shared
  memory in bucket order;
- ``match_hist``: radix_hist counts through ``__match_any_sync`` groups
  (one shared atomic a group) instead of one shared atomic a key;
- ``ballot_rank``: the tile kernel finds a lane's bucket peers with 8
  ``__ballot_sync`` votes, one a digit bit (Onesweep's warp multi-split),
  instead of ``__match_any_sync``.

For each build, at (4, 16384) and (64, 16384) with both tile sizes: the
device microseconds (profiler, mean of 20 launches) of radix_rank,
radix_hist and radix_pass (a middle pass with int32 values), each held
exactly to its plain version first. Prints one JSON object a line, the
card's name and power limit last.

    python3 tools/radix_design.py
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

STAGED = """  } else {
    // stage the tile in bucket order"""
DIRECT = """  } else {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kKpt; ++k) {
      const long long idx = first + k * 32;
      if (idx >= a.chunk_len) break;
      const int d = digit[k];
      const size_t pos = row + (size_t)(start[d] + before[d] +
                                        cnt[d * kPitch + warp] + rank[k]);
      a.keys_out[pos] = key[k];
      if constexpr (kVal == -1) {
        ((Val*)a.vals_out)[pos] = (uint32_t)idx;
      } else {
        ((Val*)a.vals_out)[pos] = ((const Val*)a.vals)[row + idx];
      }
    }
  }
  if constexpr (false) {
    // stage the tile in bucket order"""
ATOMIC_HIST = """    for (int p = 0; p < n_passes; ++p) {
      atomicAdd(&sh[p * kRadix + ((key[k] >> (8 * p)) & (kRadix - 1))], 1u);
    }"""
MATCH_HIST = """    const unsigned active = __activemask();
    for (int p = 0; p < n_passes; ++p) {
      const int d = (int)((key[k] >> (8 * p)) & (kRadix - 1));
      const unsigned peers = __match_any_sync(active, d);
      if ((peers & ((1u << lane) - 1u)) == 0) {
        atomicAdd(&sh[p * kRadix + d], (unsigned)__popc(peers));
      }
    }"""
MATCH_RANK = """    unsigned peers = 0;
    int pre = 0;
    if (valid) {
      peers = __match_any_sync(active, digit[k]);
      pre = *slot;
    }"""
BALLOT_RANK = """    unsigned peers = active;
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      const bool set = (digit[k] >> bit) & 1;
      const unsigned votes = __ballot_sync(0xffffffffu, set);
      peers &= set ? votes : ~votes;
    }
    int pre = 0;
    if (valid) pre = *slot;"""


def variants(src: str) -> dict:
    def sub(old, new, text=src):
        if old not in text:
            raise SystemExit(f"radix_design: the source no longer holds "
                             f"{old[:60]!r}")
        return text.replace(old, new)
    return {
        "committed": src,
        "release_acquire": sub("ld.relaxed.gpu", "ld.acquire.gpu",
                               sub("st.relaxed.gpu", "st.release.gpu")),
        "direct_scatter": sub(STAGED, DIRECT),
        "match_hist": sub(ATOMIC_HIST, MATCH_HIST),
        "ballot_rank": sub(MATCH_RANK, BALLOT_RANK),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("radix_design: torch.cuda.is_available() is False; this runs "
              "on an NVIDIA GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from repro_torch.kernels import _build
    from repro_torch.kernels import radix_rank as KR

    out = ROOT / "build" / "radix_design"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "radix_rank.cu").read_text()
    procs = {}
    for name, text in variants(src).items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            raise SystemExit(f"radix_design: {name} does not build")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    shapes = {n: (torch.randint(0, 2**32, (n, 16384), generator=g,
                                device=dev, dtype=torch.int64),
                  torch.randint(0, 2**31, (n, 16384), generator=g,
                                device=dev, dtype=torch.int32))
              for n in (4, 64)}

    def device_us(fn, name):
        _, spans = CS.profiled(lambda: [fn() for _ in range(20)])
        return statistics.mean(e - s for s, e, nm in spans if name in nm)

    for name in procs:
        _build._LIBS["radix_rank"] = ctypes.CDLL(str(out / f"lib{name}.so"))
        _build._FUNCS.clear()
        for n, (keys, vals) in shapes.items():
            hp, sp = KR.radix_hist_plain(keys)
            want_r = KR.radix_rank_plain(keys, 8)
            want_p = KR.radix_pass_plain(keys, vals, sp, 1)
            row = {"build": name, "shape": [n, 16384]}
            for tile in KR.TILES:
                got = (KR.radix_rank(keys, 8, tile=tile)
                       + KR.radix_hist(keys, tile=tile)
                       + KR.radix_pass(keys, vals, sp, 1, tile=tile))
                CS.check(all(torch.equal(x, y) for x, y in
                             zip(got, want_r + (hp, sp) + want_p)),
                         f"{name} tile {tile} at {n} chunks differs from "
                         f"the plain versions")
                row[f"tile_{tile}_us"] = {
                    "radix_rank": device_us(
                        lambda: KR.radix_rank(keys, 8, tile=tile),
                        "rank_tiles_kernel"),
                    "radix_hist": device_us(
                        lambda: KR.radix_hist(keys, tile=tile),
                        "radix_hist_kernel"),
                    "radix_pass": device_us(
                        lambda: KR.radix_pass(keys, vals, sp, 1, tile=tile),
                        "rank_tiles_kernel")}
            print(json.dumps(row), flush=True)
    print(CS.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
