# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""whisper-small [audio] (port of ``repro/configs/whisper_small.py``):
enc-dec, 12 + 12 layers, d_model=768, 12 heads of 64, d_ff=3072,
vocab=51865; the conv frontend is a stub (the caller passes 1500
precomputed frame embeddings).  [arXiv:2212.04356]

As in the JAX package, the decoder uses RoPE instead of learned positional
embeddings (FLOP-neutral); the encoder uses sinusoidal positions.
"""
from repro_torch.models import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51_865,
    ffn="gelu",
    norm="layernorm",
    encoder=EncoderConfig(n_layers=12, n_frames=1500),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        ffn="gelu",
        norm="layernorm",
        encoder=EncoderConfig(n_layers=2, n_frames=16),
        remat=False,
    )
