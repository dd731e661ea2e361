"""moonshot-v1-16b-a3b [moe]: Moonlight-16B-A3B (kimi).

48L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=163840, MoE 64 experts
top-6. [hf:moonshotai/Moonlight-16B-A3B; hf]

All layers MoE (the released model keeps layer 0 dense; we follow the
assignment's uniform spec and note the difference in DESIGN.md). Full
attention -> long_500k skipped.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=163840,
    pattern=(LayerSpec(mixer="attn", mlp="moe"),),
    num_experts=64,
    experts_per_token=6,
    moe_d_ff=1408,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=96, vocab=128, pattern=(LayerSpec(mixer="attn", mlp="moe"),),
        num_experts=8, experts_per_token=3, moe_d_ff=96)
