"""Stand-ins on the ``meta`` device for every model input (port of
``repro.launch.specs``). Nothing is allocated and nothing is drawn.

The meta device is to this module what ``jax.eval_shape`` is to the
reference: a tensor there has a shape, a dtype and strides and no data, and
every op on it only works out its result's shape. So the port's own objects
stand in for the reference's ``ShapeDtypeStruct`` trees: a batch dict, a
``Model``, caches and a ``TrainState``, all on meta, which the dry run
(``launch.dryrun``) walks. ``device="meta"`` is the default here, and only
here: the port's other entry points default to the card.

`input_specs(cfg, shape)` returns the batch for a (arch x shape) cell:
  * train_*    - {"tokens"|"embeds", "labels"} at (global_batch, seq)
  * prefill_*  - {"tokens"|"embeds"}
  * decode_* / long_* - one new token + the full-context cache

Modality frontends are stubs, as in the reference: the [vlm] and [audio]
archs take precomputed patch or frame embeddings (B, S, d_model) instead of
token ids.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike
from repro_torch.models import transformer as T
from repro_torch.train.step import TrainState, init_train_state

META = "meta"


def _tokens_or_embeds(cfg: ModelConfig, b: int, s: int,
                      device: DeviceLike) -> Dict[str, torch.Tensor]:
    if cfg.input_mode == "embeds":
        return {"embeds": torch.empty((b, s, cfg.d_model),
                                      dtype=torch.bfloat16, device=device)}
    return {"tokens": torch.empty((b, s), dtype=torch.int32, device=device)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device: DeviceLike = META) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = _tokens_or_embeds(cfg, b, s, device)
        batch["labels"] = torch.empty((b, s), dtype=torch.int32,
                                      device=device)
        return {"batch": batch}
    if shape.kind == "prefill":
        return {"batch": _tokens_or_embeds(cfg, b, s, device)}
    if shape.kind == "decode":
        return {"caches": T.init_caches(cfg, b, s, device=device),
                "inp": _tokens_or_embeds(cfg, b, 1, device),
                "pos": torch.empty((), dtype=torch.int32, device=device)}
    raise ValueError(shape.kind)


def params_specs(cfg: ModelConfig, device: DeviceLike = META) -> T.Model:
    """The ``Model`` of fp32 masters, on meta: no generator is needed,
    since nothing is drawn there."""
    return T.init_model(cfg, None, device)


def train_state_specs(cfg: ModelConfig,
                      device: DeviceLike = META) -> TrainState:
    """The ``TrainState`` (masters with gradients on, AdamW's ``mu`` and
    ``nu``, the counters), on meta."""
    return init_train_state(cfg, None, device=device)
