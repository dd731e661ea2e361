"""jamba-v0.1-52b [hybrid]: Mamba + attention 1:7 interleave, MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16 experts
top-2. [arXiv:2403.19887; hf]

Period-8 pattern (Jamba block): one attention layer per 8 (position 4),
seven Mamba layers; MoE replaces the dense FFN on every other layer
(e = 16, top-2), matching the published 1:7 attn ratio and e/2 MoE ratio.
Mamba layers run on core.linear_attn.mamba_chunked (the paper-technique
core path) -> subquadratic, long_500k RUNS.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

_M_D = LayerSpec(mixer="mamba", mlp="dense")
_M_E = LayerSpec(mixer="mamba", mlp="moe")
_A_E = LayerSpec(mixer="attn", mlp="moe")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    # positions 0..7; attention at 4 (1:7), MoE on odd positions (1:2)
    pattern=(_M_D, _M_E, _M_D, _M_E, LayerSpec(mixer="attn", mlp="dense"),
             _M_E, _M_D, _M_E),
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=14336,
    ssm_state=16,
    ssm_expand=2,
    subquadratic=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=96, vocab=128,
        pattern=(LayerSpec(mixer="mamba", mlp="dense"),
                 LayerSpec(mixer="mamba", mlp="moe"),
                 LayerSpec(mixer="attn", mlp="dense"),
                 LayerSpec(mixer="mamba", mlp="moe")),
        num_experts=4, experts_per_token=2, moe_d_ff=96,
        ssm_state=4, ssm_expand=2, subquadratic=True)
