"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144. 5:1 local:global attention, 128k context, qk-norm.
[hf:google/gemma-3-1b-pt; unverified]

Pattern period 6: five sliding-window (1024) layers at rope theta 1e4,
one global layer at theta 1e6. The 5:1 local ratio bounds the quadratic
term, so long_500k RUNS for this arch (decode over the window cache is
O(window) for 5/6 of layers; global layers are O(seq) per token, linear
in decode). The window band-mask shares the chain band machinery
conceptually (DESIGN.md §3.3).
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

_LOCAL = LayerSpec(mixer="attn", window=1024, mlp="dense", rope_theta=1e4)
_GLOBAL = LayerSpec(mixer="attn", window=0, mlp="dense", rope_theta=1e6)

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    qk_norm=True,
    tie_embeddings=True,
    scale_embed=True,
    subquadratic=True,
    remat_policy="dots",   # §Perf gemma3 iteration 6 (banded+dots)
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab=128,
        pattern=(LayerSpec(mixer="attn", window=16),
                 LayerSpec(mixer="attn", window=0, rope_theta=1e6)),
        qk_norm=True, tie_embeddings=True, scale_embed=True,
        subquadratic=True)
