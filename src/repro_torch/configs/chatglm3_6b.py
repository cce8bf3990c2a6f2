# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024, 2d (partial) RoPE.  [arXiv:2406.12793; hf]

Port of ``repro/configs/chatglm3_6b.py``: the same fields, field for field.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=65_024,
    rope="partial",
    rope_frac=0.5,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        rope="partial",
        rope_frac=0.5,
        remat=False,
    )
