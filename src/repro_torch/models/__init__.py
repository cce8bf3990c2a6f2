# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.models``: the model stack (GQA, MLA and Mamba2 layers,
dense and MoE FFNs, the Whisper encoder-decoder)."""
from .config import (EncoderConfig, MLAConfig, MoEConfig, ModelConfig,
                     SSMConfig)
from .transformer import Model, init_cache, model_spec

__all__ = ["EncoderConfig", "MLAConfig", "MoEConfig", "ModelConfig",
           "SSMConfig", "Model", "init_cache", "model_spec"]
