"""llava-next-34b [vlm]: dense transformer backbone of LLaVA-NeXT-34B.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The anyres image frontend is a STUB per the brief: input_specs() provides
precomputed patch embeddings (B, S, d_model); the backbone trains/serves
over them. Pure full attention -> long_500k is skipped.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    input_mode="embeds",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128, pattern=(LayerSpec(mixer="attn"),),
        input_mode="embeds")
