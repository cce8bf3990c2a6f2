# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""phi-3-vision-4.2b [vlm] — phi3-mini backbone (32L d_model=3072 32H
d_ff=8192 vocab=32064) + CLIP frontend STUB: input_specs() provides 576
precomputed patch embeddings prepended to the token sequence.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

Port of ``repro/configs/phi_3_vision_4_2b.py``: the same fields, field for
field.
"""
from repro_torch.models import ModelConfig

N_PATCHES = 576  # CLIP ViT-L/14 @ 336px

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab=32_064,
    n_prefix=N_PATCHES,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        n_prefix=8,
        remat=False,
    )
