"""rwkv6-1.6b [ssm]: RWKV-6 "Finch" 1.6B — attention-free, data-dependent
decay. 24L d_model=2048 d_ff=7168 vocab=65536. [arXiv:2404.05892]

The WKV6 recurrence is the paper-technique core path (DESIGN.md §3.1):
chunk-parallel training (core.linear_attn.wkv_chunked) and O(1)-state
decode, which is what makes the long_500k shape runnable.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,            # d_model / rwkv_head_dim
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab=65536,
    pattern=(LayerSpec(mixer="rwkv", mlp="rwkv_ffn"),),
    rwkv_head_dim=64,
    subquadratic=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab=128,
        pattern=(LayerSpec(mixer="rwkv", mlp="rwkv_ffn"),),
        rwkv_head_dim=16, subquadratic=True)
