"""musicgen-large [audio]: decoder-only over EnCodec tokens.

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048. [arXiv:2306.05284; hf]

The EnCodec frontend (and the 4-codebook interleaving) is a STUB per the
brief: input_specs() provides precomputed frame embeddings (B, S, d_model);
labels index the 2048-entry codebook vocab. Pure full attention ->
long_500k skipped.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=2048,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    input_mode="embeds",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab=64, pattern=(LayerSpec(mixer="attn"),),
        input_mode="embeds")
