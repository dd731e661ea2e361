#!/usr/bin/env python3
"""The MoE dispatch's rank, timed on one NVIDIA GPU.

``models/moe._local_dispatch`` ranks each routed entry within its expert by
a cumsum over the token-major one-hot of the top-k experts. This times, at
olmoe-1b-7b's bf16 prefill shape (8,192 tokens, k = 8, 64 experts, model
width 2,048) and jamba-v0.1-52b's (2,048 tokens, k = 2, 16 experts, 4,096):

- the rank as a cumsum over the outer axis of the (N*k, E) one-hot (the
  reference's layout);
- the rank as a cumsum along the contiguous axis of its (E, N*k)
  transpose (what the port runs), held equal to the first;
- the port's whole ``_local_dispatch`` (rank, gather and the accumulating
  ``index_put_`` scatter).

Milliseconds per call by CUDA events (``chip_smoke.time_cuda``), one line
each, then the card's name and power limit.

    python3 tools/moe_dispatch.py
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("moe_dispatch: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.models import moe as M

    dev = torch.device("cuda")
    for n, k, e, d in ((8192, 8, 64, 2048), (2048, 2, 16, 4096)):
        cfg = M.MoEConfig(d_model=d, d_ff=1024, num_experts=e,
                          experts_per_token=k)
        c = M.capacity(n, cfg)
        g = torch.Generator(device=dev).manual_seed(0)
        xt = torch.randn((n, d), generator=g, device=dev).bfloat16()
        probs = torch.softmax(torch.randn((n, e), generator=g, device=dev),
                              -1)
        top_p, top_e = torch.topk(probs, k, -1)
        flat_e = top_e.reshape(-1)
        rows = torch.arange(n * k, device=dev)

        def outer():
            oh = F.one_hot(flat_e, e)
            return torch.gather(torch.cumsum(oh, 0) - oh, 1,
                                flat_e[:, None])[:, 0]

        def transposed():
            oh = F.one_hot(flat_e, e).T.contiguous()
            return (torch.cumsum(oh, 1) - oh)[flat_e, rows]

        assert torch.equal(transposed(), outer())
        for name, fn in (("outer_cumsum_int64", outer),
                         ("transposed_cumsum", transposed),
                         ("_local_dispatch", lambda: M._local_dispatch(
                             xt, top_e, top_p, e, c))):
            ms = CS.time_cuda(fn, reps=5, rounds=3)
            print(f"n={n} k={k} E={e} c={c} d={d} {name}: {ms:.3f} ms",
                  flush=True)
    print(CS.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
