# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, QKV bias.  [arXiv:2407.10671; hf]

Port of ``repro/configs/qwen2_1_5b.py``: the same fields, field for field.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151_936,
    qkv_bias=True,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        qkv_bias=True,
        tie_embeddings=True,
        remat=False,
    )
