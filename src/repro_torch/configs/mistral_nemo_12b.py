# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k ctx, head_dim=128.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]

Port of ``repro/configs/mistral_nemo_12b.py``: the same fields, field for
field.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131_072,
    rope_theta=1_000_000.0,
    max_seq=131_072,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        remat=False,
    )
