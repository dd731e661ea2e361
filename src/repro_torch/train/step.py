"""Training step: loss -> backward -> clip -> (optional compression) ->
AdamW (port of ``repro.train.step``).

The state is a ``TrainState`` of tensors on one device: the ``Model`` of
fp32 masters with ``requires_grad`` on, AdamW's fp32 ``mu`` and ``nu``
keyed by parameter name, the step counter, and the error-feedback
residuals when gradients are compressed. Where the reference's step is a
pure function that launchers jit and donate, the port's step updates the
state's tensors in place and returns it: the same values, without a second
copy of the state. In train mode the model runs ``flash_attention`` and
``ssm_scan`` (kernels on the card, their plain versions on the CPU) with
their backward kernels, each layer under remat as ``cfg.remat`` says.

The reference's ``state_shardings`` and ``batch_shardings`` place the
state on a mesh; the port runs on one card, and they wait with the sharded
parts.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import (AdamWConfig, adamw_update,
                               clip_by_global_norm, init_opt_state)
from repro_torch.train import grad_compress as gc

Tensor = torch.Tensor


class TrainState(NamedTuple):
    params: T.Model
    opt: Dict[str, Any]           # {"mu": {name: t}, "nu": {...}, "count"}
    step: Tensor                  # int32 scalar
    ef: Optional[Dict[str, Tensor]] = None   # error feedback (compression)


def init_train_state(cfg: ModelConfig,
                     generator: Optional[torch.Generator],
                     compress: bool = False,
                     device: DeviceLike = None) -> TrainState:
    """Random fp32 masters from ``generator`` (which lives on ``device``,
    default the card), with gradients on, and zero optimizer state. On the
    ``meta`` device nothing is drawn and the generator may be None
    (``init_model``'s rule)."""
    dev = resolve_device(device)
    params = T.init_model(cfg, generator, dev)
    params.requires_grad_(True)
    ef = ({n: torch.zeros_like(p, requires_grad=False)
           for n, p in params.named_parameters()} if compress else None)
    return TrainState(params=params, opt=init_opt_state(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev),
                      ef=ef)


def _loss_for(params: T.Model, cfg: ModelConfig, mb: Dict[str, Tensor],
              use_kernels: bool):
    logits, aux, _ = T.apply_model(params, cfg, tokens=mb.get("tokens"),
                                   embeds=mb.get("embeds"), mode="train",
                                   use_kernels=use_kernels)
    loss, metrics = T.lm_loss(logits, mb["labels"], mb.get("mask"))
    return loss + aux, metrics, aux


def _grads(params: T.Model) -> Dict[str, Tensor]:
    """Each parameter's gradient (zeros where autograd left none, as the
    reference's grad tree always has every leaf); clears ``.grad``."""
    out = {}
    for n, p in params.named_parameters():
        out[n] = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
    return out


def loss_and_grads(params: T.Model, cfg: ModelConfig,
                   batch: Dict[str, Tensor], accum_steps: int = 1,
                   use_kernels: bool = True):
    """The loss (with the aux loss), its metrics, the aux loss and the
    gradients before clipping, {name: tensor}. ``accum_steps > 1`` splits
    the batch into that many microbatches, run one after another (the
    reference's ``lax.scan``), and averages: each microbatch's gradient is
    added in fp32 divided by ``accum_steps``, the losses and metrics are
    means. ``use_kernels=False`` runs the plain versions
    (``blockwise_attention``, the WKV step loop) under autograd instead of
    the kernels."""
    for p in params.parameters():
        p.grad = None
    if accum_steps <= 1:
        loss, metrics, aux = _loss_for(params, cfg, batch, use_kernels)
        loss.backward()
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                aux.detach(), _grads(params))
    b = next(iter(batch.values())).shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} is not a multiple of accum_steps "
                         f"{accum_steps}")
    n = b // accum_steps
    acc = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for name, p in params.named_parameters()}
    losses, auxs, mets = [], [], []
    for i in range(accum_steps):
        mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        loss, metrics, aux = _loss_for(params, cfg, mb, use_kernels)
        loss.backward()
        for name, g in _grads(params).items():
            acc[name] += g.to(torch.float32) / accum_steps
        losses.append(loss.detach())
        auxs.append(aux.detach())
        mets.append({k: v.detach() for k, v in metrics.items()})
    metrics = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
    return (torch.stack(losses).mean(), metrics, torch.stack(auxs).mean(),
            acc)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    compress: bool = False, accum_steps: int = 1):
    """Returns train_step(state, batch) -> (state, metrics).

    batch: {"tokens" | "embeds", "labels", optional "mask"} on the state's
    device. metrics: ce, z_loss, loss (with the aux loss), aux, grad_norm
    and lr, as 0-d tensors. The state's tensors are updated in place.
    """

    def train_step(state: TrainState, batch: Dict[str, Tensor]):
        loss, metrics, aux, grads = loss_and_grads(
            state.params, cfg, batch, accum_steps)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm)
        ef = state.ef
        if compress:
            grads, ef = gc.compress_decompress(grads, ef)
        _, opt, lr = adamw_update(grads, state.opt, state.params, opt_cfg)
        del grads
        new_state = TrainState(params=state.params, opt=opt,
                               step=state.step + 1, ef=ef)
        metrics = dict(metrics, loss=loss, aux=aux, grad_norm=gnorm, lr=lr)
        return new_state, metrics

    return train_step
