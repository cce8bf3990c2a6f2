# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (GQA kv=32, i.e. MHA)
d_ff=8192 vocab=32064, RoPE + SwiGLU.  [arXiv:2404.14219; unverified]

Port of ``repro/configs/phi3_mini_3_8b.py``: the same fields, field for field.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab=32_064,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        remat=False,
    )
