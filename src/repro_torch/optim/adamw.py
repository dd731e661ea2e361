"""AdamW with warmup+cosine schedule and global-norm clipping (port of
``repro.optim.adamw``).

Trees are flat dicts of tensors keyed by parameter name (a ``Model``'s
``named_parameters`` order), or a ``Model`` itself where parameters are
read. ``mu`` and ``nu`` are fp32 whatever the parameters' type, as the
reference's are for its fp32 masters. The arithmetic follows the
reference's order in fp32: the schedule, the bias corrections
``1 - b ** count`` and the per-leaf update.

Unlike the reference, which returns new trees, ``clip_by_global_norm`` and
``adamw_update`` update in place: the optimizer state of a 2.5 B-parameter
model (40 GB with its fp32 masters and gradients) leaves no room on one
80 GB card for a second copy.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple, Union

import torch
from torch import nn

Tensor = torch.Tensor
Tree = Dict[str, Tensor]


class AdamWConfig(NamedTuple):
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _leaves(tree: Union[Tree, nn.Module]) -> Tree:
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return tree


def lr_at(cfg: AdamWConfig, step, device=None) -> Tensor:
    """The learning rate at ``step`` (a number or a tensor), fp32."""
    step = torch.as_tensor(step, device=device).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params: Union[Tree, nn.Module]) -> dict:
    """fp32 zeros for ``mu`` and ``nu`` beside each parameter, and an int32
    ``count``, on the parameters' device."""
    leaves = _leaves(params)
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in leaves.items()}
    dev = next(iter(leaves.values())).device if leaves else None
    return {"mu": zeros,
            "nu": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, Tensor]:
    """Scales every gradient by min(1, max_norm / |g|) in place, |g| the
    global fp32 norm. Returns (grads, |g|)."""
    sq = None
    for g in grads.values():
        s = torch.sum(torch.square(g.to(torch.float32)))
        sq = s if sq is None else sq + s
    gnorm = torch.sqrt(sq)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    for g in grads.values():
        g.copy_((g * scale).to(g.dtype))
    return grads, gnorm


@torch.no_grad()
def adamw_update(grads: Tree, opt_state: dict,
                 params: Union[Tree, nn.Module], cfg: AdamWConfig):
    """One AdamW step, in place on ``params``, ``mu`` and ``nu`` (and
    ``count``). Returns (params, opt_state, lr)."""
    leaves = _leaves(params)
    count = opt_state["count"] + 1
    lr = lr_at(cfg, count)
    cf = count.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=cf.device), cf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=cf.device), cf)
    for name, p in leaves.items():
        g = grads[name].to(torch.float32)
        m, v = opt_state["mu"][name], opt_state["nu"][name]
        p32 = p.to(torch.float32)
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        mhat = m / b1c
        vhat = v / b2c
        step = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        p.copy_((p32 - lr * step).to(p.dtype))
    opt_state["count"].copy_(count)
    return params, opt_state, lr
