# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16 experts top-2, Mamba:attention 7:1
interleave (attention at index 4 of each 8-layer superblock), MoE every
other layer.  [arXiv:2403.19887; hf]

Hardware adaptation noted in DESIGN.md: Jamba's Mamba-1 layers are
implemented as Mamba2/SSD blocks (MXU-friendly chunked dual form) with
d_state=128 — the roofline-relevant shapes (state size, head count) follow
the Mamba2 convention.

Port of ``repro/configs/jamba_1_5_large_398b.py``: the same fields, field for
field.
"""
from repro_torch.models import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65_536,
    moe=MoEConfig(n_experts=16, top_k=2, expert_ff=24576),
    ssm=SSMConfig(d_state=128, head_dim=64, n_groups=8, expand=2),
    layer_pattern="MMMMAMMM",
    ffn_pattern="DE",
    block_size=8,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b-reduced",
        n_layers=8,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, expert_ff=128),
        ssm=SSMConfig(d_state=16, head_dim=16, n_groups=2, expand=2,
                      chunk=16),
        layer_pattern="MMMMAMMM",
        ffn_pattern="DE",
        block_size=8,
        remat=False,
    )
