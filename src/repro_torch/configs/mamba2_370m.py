# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""mamba2-370m [ssm] (port of ``repro/configs/mamba2_370m.py``): 48
Mamba2 layers, d_model=1024, attention-free (SSD: 32 heads of 64,
ssm_state=128, one group), no FFN, tied embeddings, vocab=50280.
[arXiv:2405.21060]

Its prefill runs the SSD intra-chunk term on the hand-written CUDA kernel
(``kernels/ssd_chunk``, ``csrc/ssd_chunk.cu``), one launch per layer.
"""
from repro_torch.models import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    n_layers=48,
    d_model=1024,
    n_heads=16,  # unused (attention-free); SSD heads come from SSMConfig
    n_kv_heads=16,
    head_dim=64,
    d_ff=0,
    vocab=50_280,
    ssm=SSMConfig(d_state=128, head_dim=64, n_groups=1, expand=2),
    layer_pattern="M",
    ffn_pattern="-",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=0,
        vocab=512,
        ssm=SSMConfig(d_state=16, head_dim=16, n_groups=1, expand=2,
                      chunk=16),
        layer_pattern="M",
        ffn_pattern="-",
        tie_embeddings=True,
        remat=False,
    )
