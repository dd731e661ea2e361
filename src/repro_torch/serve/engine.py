"""Serving steps: prefill, single-token decode, chunked prefill and the
per-request ``generate`` (port of ``repro.serve.engine``).

Decode is the dependency-bound 1-D recurrence of serving: each step
consumes the previous step's cache. Attention layers carry bf16 KV ring
buffers; RWKV layers carry O(1) recurrent state, so their decode cost is
flat in context length. The steps are plain functions under
``torch.inference_mode()``; there is no jit. On the card a prefill runs
the kernels (``flash_attention``, ``ssm_scan``); a chunk runs ``ssm_scan``
from the carried state, and its attention, like a decode step's, is the
plain ``blockwise_attention`` over the cache, so ``generate`` launches no
``flash_attention``. Sampling at
``temperature > 0`` draws Gumbel noise from a ``torch.Generator`` (the
reference's Gumbel-max), so only greedy streams equal the reference's.
The verify, paged and sharded steps come with the paging slice (ROADMAP
queue 1, item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SamplingPolicy:
    """Per-request sampling knobs threaded through the decode steps.

    ``temperature <= 0`` is greedy (exact argmax of the raw logits).
    ``top_k = 0`` disables top-k; ``top_p = 1.0`` disables nucleus
    filtering. Both filters are exact identities when disabled.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0: {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables): {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1]: {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def fingerprint(self):
        """Hashable identity for memo keys (RequestCache, coalescing)."""
        return (float(self.temperature), int(self.top_k), float(self.top_p))


def _filter_topk_topp(lg: Tensor, top_ks: Tensor, top_ps: Tensor) -> Tensor:
    """Mask logits (B, V) outside the per-row top-k / nucleus sets to -inf.

    top_ks (B,) int (0 = disabled) and top_ps (B,) fp32 (1.0 = disabled)
    are value thresholds against the descending sort: ties at the cut
    survive together, and a disabled filter keeps every entry.
    """
    v = lg.shape[-1]
    srt = torch.sort(lg, dim=-1, descending=True).values
    k = torch.clamp(torch.where(top_ks <= 0, v, top_ks), 1, v).to(torch.int64)
    kth = torch.take_along_dim(srt, (k - 1)[:, None], dim=-1)
    keep_k = lg >= kth
    # exclusive cumsum of sorted probs: entry i kept iff the mass strictly
    # before it is < top_p; always keeps the argmax, disabled at p = 1.
    probs = torch.softmax(srt, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs
    nk = torch.clamp_min(torch.sum((cum < top_ps[:, None]).to(torch.int64),
                                   dim=-1), 1)
    nth = torch.take_along_dim(srt, (nk - 1)[:, None], dim=-1)
    keep_p = lg >= nth
    return torch.where(keep_k & keep_p, lg, -torch.inf)


def _gumbel(shape, generator: torch.Generator, device) -> Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(torch.clamp_min(u, tiny)))


def sample_token(logits: Tensor, generator: Optional[torch.Generator] = None,
                 temperature=0.0, top_k=0, top_p=1.0) -> Tensor:
    """logits: (B, 1, V) -> (B,) int64. temperature 0 = greedy.

    ``temperature``, ``top_k`` and ``top_p`` may be python scalars or (B,)
    tensors (per-slot knobs). Sampling is Gumbel-max
    (``argmax(l / T + g)``) with noise from ``generator``; greedy rows stay
    exactly the argmax of the raw logits whatever the filters.
    """
    lg = logits[:, -1].to(torch.float32)
    greedy = torch.argmax(lg, dim=-1)
    b = lg.shape[0]
    scalars = (isinstance(temperature, (int, float))
               and isinstance(top_k, int)
               and isinstance(top_p, (int, float)))
    if scalars:
        if temperature <= 0.0 or generator is None:
            return greedy
        if top_k > 0 or top_p < 1.0:                # skip the sort when off
            lg = _filter_topk_topp(
                lg, torch.full((b,), top_k, device=lg.device),
                torch.full((b,), top_p, dtype=torch.float32,
                           device=lg.device))
        return torch.argmax(lg / temperature
                            + _gumbel(lg.shape, generator, lg.device), dim=-1)
    temps = torch.as_tensor(temperature, dtype=torch.float32,
                            device=lg.device).expand(b)
    ks = torch.as_tensor(top_k, device=lg.device).expand(b)
    ps = torch.as_tensor(top_p, dtype=torch.float32,
                         device=lg.device).expand(b)
    if generator is None:
        if bool((temps > 0.0).any()):
            raise ValueError("sampling at temperature > 0 needs a generator")
        return greedy
    filt = _filter_topk_topp(lg, ks, ps)
    scaled = (filt / torch.clamp_min(temps, 1e-6)[:, None]
              + _gumbel(lg.shape, generator, lg.device))
    sampled = torch.argmax(scaled, dim=-1)
    return torch.where(temps > 0.0, sampled, greedy)


def make_prefill_step(cfg: ModelConfig, cache_slots: int,
                      use_kernels: bool = True):
    """prefill(params, {"tokens"|"embeds": ...}) -> (last_logits, caches)."""

    @torch.inference_mode()
    def prefill(params, batch: Dict[str, Tensor]):
        logits, _, caches = T.apply_model(
            params, cfg, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), mode="prefill",
            cache_slots=cache_slots, use_kernels=use_kernels)
        return logits, caches

    return prefill


def make_decode_step(cfg: ModelConfig, temperature: float = 0.0):
    """decode(params, caches, inp, pos[, generator]) -> (next_tok, logits,
    caches). inp: {"tokens": (B, 1)} or {"embeds": (B, 1, D)}; pos: the
    absolute position of the incoming token."""

    @torch.inference_mode()
    def decode(params, caches, inp: Dict[str, Tensor], pos,
               generator: Optional[torch.Generator] = None):
        logits, _, caches = T.apply_model(
            params, cfg, tokens=inp.get("tokens"),
            embeds=inp.get("embeds"), mode="decode", caches=caches,
            pos_scalar=pos)
        nxt = sample_token(logits, generator, temperature)
        return nxt, logits, caches

    return decode


def make_slot_decode_step(cfg: ModelConfig):
    """decode(params, caches, tokens, pos, temps, generator[, top_ks,
    top_ps]) -> (next_tok, logits, caches) with per-slot clocks and
    sampling knobs: tokens (B, 1), pos (B,), temps (B,) fp32 (0 = greedy),
    top_ks (B,) / top_ps (B,) optional (None = disabled)."""

    @torch.inference_mode()
    def decode(params, caches, tokens: Tensor, pos: Tensor, temps: Tensor,
               generator: Optional[torch.Generator],
               top_ks: Optional[Tensor] = None,
               top_ps: Optional[Tensor] = None):
        logits, _, caches = T.apply_model(
            params, cfg, tokens=tokens, mode="decode", caches=caches,
            pos_scalar=pos)
        nxt = sample_token(logits, generator, temps,
                           0 if top_ks is None else top_ks,
                           1.0 if top_ps is None else top_ps)
        return nxt, logits, caches

    return decode


def make_chunk_step(cfg: ModelConfig):
    """chunk(params, caches, tokens, pos) -> (logits (B, C, V), caches).

    Chunked prefill: tokens (B, C) are C consecutive tokens per row from
    absolute position pos[b]; attention appends the chunk to the cache and
    masks by absolute position, RWKV layers run the state-carried scan
    (the kernel on the card). Every row carries a full chunk; logits cover
    every chunk position."""

    @torch.inference_mode()
    def chunk(params, caches, tokens: Tensor, pos: Tensor):
        logits, _, caches = T.apply_model(
            params, cfg, tokens=tokens, mode="decode", caches=caches,
            pos_scalar=pos)
        return logits, caches

    return chunk


def generate(params, cfg: ModelConfig, prompt, max_new_tokens: int,
             *, temperature: float = 0.0, top_k: int = 0,
             top_p: float = 1.0, eos_token: Optional[int] = None,
             prefill_chunk: int = 32, cache_slots: int = 0,
             generator: Optional[torch.Generator] = None):
    """Per-request generation, the scheduler's single-request oracle.

    The prompt is consumed as in the reference: full ``prefill_chunk``
    chunks over the first L-1 tokens, the remainder teacher-forced through
    decode. Runs on the device of ``params``. Returns (tokens (g,) int32
    numpy, reason).
    """
    dev = params.final_norm["scale"].device
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                             device=dev)
    ln = int(prompt.shape[0])
    assert ln >= 1, "empty prompt"
    slots = cache_slots or (ln + max_new_tokens)
    caches = T.init_caches(cfg, batch=1, slots=slots, per_slot_pos=True,
                           device=dev)
    chunk_fn = make_chunk_step(cfg)
    decode_fn = make_slot_decode_step(cfg)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def at(pos):
        return torch.tensor([pos], dtype=torch.int64, device=dev)

    ctx = 0
    while ln - 1 - ctx >= prefill_chunk:
        toks = prompt[None, ctx:ctx + prefill_chunk]
        _, caches = chunk_fn(params, caches, toks, at(ctx))
        ctx += prefill_chunk

    temps = torch.tensor([temperature], dtype=torch.float32, device=dev)
    tks = torch.tensor([top_k], dtype=torch.int64, device=dev)
    tps = torch.tensor([top_p], dtype=torch.float32, device=dev)
    out, reason, last = [], "length", None
    while len(out) < max_new_tokens:
        tok = prompt[ctx] if ctx < ln else last
        nxt, _, caches = decode_fn(params, caches, tok.reshape(1, 1),
                                   at(ctx), temps, generator, tks, tps)
        ctx += 1
        last = nxt[0]
        if ctx >= ln:                       # prompt consumed: real sample
            out.append(int(last))
            if eos_token is not None and out[-1] == eos_token:
                reason = "eos"
                break
    return np.asarray(out, np.int32), reason
