"""Model / shape configuration dataclasses (port of ``repro.configs.base``).

Each architecture has a ``configs/<id>.py`` exporting ``CONFIG`` (the
published shape) and ``reduced()`` (a tiny same-family config for CPU
tests), field for field as in the reference; only ``dtype`` is a
``torch.dtype``. The decoder is composed from a *period pattern* of
LayerSpecs repeated depth/period times; ``models.transformer`` runs every
mixer (``attn``, ``mamba``, ``rwkv``) and MLP (``dense``, ``moe``,
``rwkv_ffn``) of the ten configs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the period pattern."""
    mixer: str = "attn"          # attn | mamba | rwkv
    window: int = 0              # attn only; 0 = global, >0 sliding window
    mlp: str = "dense"           # dense | moe | rwkv_ffn
    rope_theta: float = 1e4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    act: str = "swiglu"          # swiglu | geglu
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    scale_embed: bool = False    # gemma-style sqrt(d_model) embed scaling
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM / RWKV
    ssm_state: int = 16
    ssm_expand: int = 2
    rwkv_head_dim: int = 64
    scan_chunk: int = 64
    # frontend: tokens (LM) or precomputed embeddings (vlm/audio stubs)
    input_mode: str = "tokens"
    # numerics / runtime
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "full"   # full | dots (save MXU outputs, §Perf)
    kv_block: int = 512
    # long-context applicability (pure full-attention archs skip long_500k)
    subquadratic: bool = False

    def __post_init__(self):
        assert self.num_layers % len(self.pattern) == 0, \
            (self.name, self.num_layers, len(self.pattern))

    @property
    def num_periods(self) -> int:
        return self.num_layers // len(self.pattern)

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        return self.pattern * self.num_periods


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the assignment."""
    name: str
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the cell runs; otherwise the documented skip reason."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("pure full-attention arch: 524k-token decode needs "
                "sub-quadratic attention (DESIGN.md §3.3)")
    return None
