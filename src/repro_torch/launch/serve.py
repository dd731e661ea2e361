"""Serving launcher: batched prefill + decode (port of
``repro.launch.serve``).

A batch of random prompts is prefilled once (on the card, every attention
layer is one ``flash_attention`` launch and every RWKV layer one
``ssm_scan`` launch), then decoded token by token: the decode loop is the
1-D dependency-bound recurrence of serving. Attention archs decode over
bf16 ring-buffer KV caches, RWKV and Mamba with O(1) state. Weights are
random, drawn from ``--seed``. Configs whose ``input_mode`` is
``embeds`` (llava-next-34b, musicgen-large: their image or audio frontend
is a stub) take random bf16 prompt embeddings instead of tokens.

``--temperature`` differs from the reference on purpose. The reference's
decode loop passes no key to its decode step, so its ``sample_token``
falls back to greedy and the flag changes nothing there. The port samples
every decoded token (not the prefill's, which is greedy in both) with
Gumbel noise from a ``torch.Generator`` seeded with ``--seed`` + 2, so the
same seed gives the same stream; at ``--temperature 0`` the stream is the
reference's greedy one.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --arch gemma-2b --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --full
      # on the card
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve import engine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-slots", type=int, default=0,
                    help="KV slots (0 = prompt+gen)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(argv=None) -> Dict[str, Any]:
    """What ``main`` does, returning its prompts, stream and timings."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = (configs.reduced_config(args.arch) if args.reduced
           else configs.get_config(args.arch))
    slots = args.cache_slots or (args.prompt_len + args.gen)
    # weights from seed, prompts from seed + 1, sampling noise from seed + 2
    params = T.init_model(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    b, s = args.batch, args.prompt_len
    prompt_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    if cfg.input_mode == "embeds":
        prompts = torch.randn((b, s, cfg.d_model), device=dev,
                              generator=prompt_gen).to(torch.bfloat16)
        batch = {"embeds": prompts}
        # every decode step is fed one and the same draw: the reference's
        # step input is normal(fold_in(ks, 0)), a constant key, so its
        # stub frontend repeats one embedding; the port mirrors that rather
        # than choosing an input of its own
        step_embeds = torch.randn((b, 1, cfg.d_model), device=dev,
                                  generator=prompt_gen).to(torch.bfloat16)
        step_inp = lambda tok: {"embeds": step_embeds}  # noqa: E731
    else:
        prompts = torch.randint(0, cfg.vocab, (b, s), device=dev,
                                generator=prompt_gen)
        batch = {"tokens": prompts}
        step_inp = lambda tok: {"tokens": tok[:, None]}  # noqa: E731
    generator = (torch.Generator(device=dev).manual_seed(args.seed + 2)
                 if args.temperature > 0 else None)

    prefill = engine.make_prefill_step(cfg, cache_slots=slots)
    decode = engine.make_decode_step(cfg, args.temperature)

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tok = engine.sample_token(logits)

    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        tok, logits, caches = decode(params, caches, step_inp(tok), s + i,
                                     generator)
        out_tokens.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen = torch.stack(out_tokens, dim=1)
    steps = max(args.gen - 1, 0)
    print(f"[serve] arch={cfg.name} batch={b} prompt={s} gen={args.gen} "
          f"dtype={str(cfg.dtype).replace('torch.', '')} device={dev}")
    print(f"[serve] prefill: {t_prefill*1e3:.1f} ms "
          f"({b*s/max(t_prefill,1e-9):.0f} tok/s)")
    print(f"[serve] decode:  {t_decode*1e3:.1f} ms "
          f"({b*steps/max(t_decode,1e-9):.1f} tok/s)")
    for row in range(b):
        print(f"[serve] row {row}: {gen[row].tolist()}")
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")
    return {"cfg": cfg, "params": params, "prompts": prompts,
            "generated": gen, "logits": logits, "caches": caches,
            "prefill_ms": t_prefill * 1e3, "decode_ms": t_decode * 1e3,
            "decode_steps": steps}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
