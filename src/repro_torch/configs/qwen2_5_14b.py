"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064. QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]

Pure full attention -> long_500k skipped.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab=152064,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    qkv_bias=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128, pattern=(LayerSpec(mixer="attn"),),
        qkv_bias=True)
