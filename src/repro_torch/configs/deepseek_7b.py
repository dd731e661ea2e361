"""deepseek-7b [dense]: llama-arch. 30L d_model=4096 32H (kv=32)
d_ff=11008 vocab=102400. [arXiv:2401.02954; hf]

Pure full attention -> long_500k skipped.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab=102400,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab=128, pattern=(LayerSpec(mixer="attn"),))
