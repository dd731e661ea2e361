"""Training launcher (port of ``repro.launch.train``).

Composes config -> data -> loop on one device: the card by default, or
``--device cpu`` (the plain versions of the kernels). Weights are random,
drawn from ``--seed``; batches come from the synthetic token stream
(``data.lm``). On the card every attention layer runs ``flash_attention``
and every RWKV layer ``ssm_scan``, each with its backward kernel, each
layer under remat as the config has it. ``--mesh`` takes only ``none``:
the sharded step is not ported. Configs whose ``input_mode`` is
``embeds`` exit, as in the reference.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --reduced --device cpu --steps 4 --batch 2 --seq 16
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --steps 3 --batch 2 --seq 2048          # on the card, full width
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression + error feedback")
    ap.add_argument("--mesh", default="none", choices=("none",),
                    help="only 'none': the port trains on one device")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def run(argv=None) -> Dict[str, Any]:
    """What ``main`` does, returning the config, the loop's result and the
    wall time of the loop."""
    from repro_torch import configs
    from repro_torch.data.lm import DataConfig, TokenStream
    from repro_torch.device import resolve_device
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import LoopConfig, train

    args = parse_args(argv)
    cfg = (configs.reduced_config(args.arch) if args.reduced
           else configs.get_config(args.arch))
    if cfg.input_mode != "tokens":
        raise SystemExit(
            f"{args.arch} takes precomputed embeddings (modality stub); "
            "use examples/train_lm.py which wires the embedding stub")
    dev = resolve_device(args.device)
    ds = TokenStream(DataConfig(vocab=cfg.vocab, batch=args.batch,
                                seq_len=args.seq, seed=args.seed),
                     device=dev)
    loop_cfg = LoopConfig(total_steps=args.steps,
                          ckpt_every=args.ckpt_every,
                          log_every=args.log_every)
    opt_cfg = AdamWConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                          decay_steps=max(args.steps, args.warmup + 1))
    t0 = time.perf_counter()
    res = train(cfg, ds.batch, loop_cfg, opt_cfg, ckpt_dir=args.ckpt_dir,
                seed=args.seed, compress=args.compress, device=dev)
    seconds = time.perf_counter() - t0
    first = res.losses[0] if res.losses else float("nan")
    last = res.losses[-1] if res.losses else float("nan")
    print(f"[train] done: {res.final_step} steps, loss {first:.4f} -> "
          f"{last:.4f}, {len(res.straggler_events)} straggler events, "
          f"{res.restarts} restarts")
    return {"cfg": cfg, "result": res, "seconds": seconds, "stream": ds,
            "opt_cfg": opt_cfg}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
