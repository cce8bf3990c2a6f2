# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408 (per expert)
vocab=102400, MoE 64 routed top-6 + 2 shared, MLA kv_lora=512, first layer
dense.  [arXiv:2405.04434; hf]

The assignment header says "MoE 64e top-6" while the note says "160 routed";
we follow the header (64 routed — the actual V2-Lite value), noted in
DESIGN.md.  The dense first layer uses the real model's d_ff=10944.

Port of ``repro/configs/deepseek_v2_lite_16b.py``: the same fields, field for
field.
"""
from repro_torch.models import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # dense (first) layer width
    vocab=102_400,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, expert_ff=1408),
    ffn_pattern="E",
    first_k_dense=1,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b-reduced",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, expert_ff=32),
        ffn_pattern="E",
        first_k_dense=1,
        remat=False,
    )
