# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified]

Assumption noted in DESIGN.md: SwiGLU expert FFNs (the HF release uses GeGLU
variants; FLOP-equivalent at equal width x3 matrices).

Port of ``repro/configs/grok_1_314b.py``: the same fields, field for field.
"""
from repro_torch.models import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131_072,
    moe=MoEConfig(n_experts=8, top_k=2, expert_ff=32768),
    ffn_pattern="E",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, expert_ff=128),
        ffn_pattern="E",
        remat=False,
    )
