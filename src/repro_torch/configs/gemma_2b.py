"""gemma-2b [dense]: 18L d_model=2048 8H MQA (kv=1) d_ff=16384
vocab=256000. GeGLU, head_dim=256, tied + scaled embeddings.
[arXiv:2403.08295; hf]

Pure full attention -> long_500k skipped. MQA (kv=1) stresses the KV
replication path in the sharding rules.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    act="geglu",
    tie_embeddings=True,
    scale_embed=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=32,
        d_ff=128, vocab=128, pattern=(LayerSpec(mixer="attn"),),
        act="geglu", tie_embeddings=True, scale_embed=True)
