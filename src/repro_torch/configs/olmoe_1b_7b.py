"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) expert d_ff=1024
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060; hf]

Every layer's FFN is MoE (OLMoE uses no dense layers). Full attention ->
long_500k skipped.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab=50304,
    pattern=(LayerSpec(mixer="attn", mlp="moe"),),
    num_experts=64,
    experts_per_token=8,
    moe_d_ff=1024,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=96, vocab=128, pattern=(LayerSpec(mixer="attn", mlp="moe"),),
        num_experts=8, experts_per_token=2, moe_d_ff=96)
