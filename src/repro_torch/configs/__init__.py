"""Architecture registry: the 10 assigned architectures (port of
``repro.configs``)."""

from __future__ import annotations

from repro_torch.configs.base import (LayerSpec, ModelConfig, ShapeConfig, SHAPES,
                                shape_applicable)

from repro_torch.configs import (deepseek_7b, gemma3_12b, gemma_2b,
                           jamba_v0_1_52b, llava_next_34b,
                           moonshot_v1_16b_a3b, musicgen_large, olmoe_1b_7b,
                           qwen2_5_14b, rwkv6_1b6)

_MODULES = {
    "llava-next-34b": llava_next_34b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "rwkv6-1.6b": rwkv6_1b6,
    "deepseek-7b": deepseek_7b,
    "gemma-2b": gemma_2b,
    "gemma3-12b": gemma3_12b,
    "qwen2.5-14b": qwen2_5_14b,
    "musicgen-large": musicgen_large,
    "jamba-v0.1-52b": jamba_v0_1_52b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    return _MODULES[name].CONFIG


def reduced_config(name: str) -> ModelConfig:
    return _MODULES[name].reduced()


__all__ = ["ARCH_NAMES", "LayerSpec", "ModelConfig", "SHAPES", "ShapeConfig",
           "get_config", "reduced_config", "shape_applicable"]
