# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Architecture registry (port of ``repro.configs``): ``--arch <id>`` ->
``ModelConfig``, full or reduced.  The ids and their order are the JAX
package's; ``paper_ivm`` (the summarization task's own configuration)
is not an architecture and stays out of ``ARCHS``, as there.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models import ModelConfig

ARCHS = {
    "grok-1-314b": "grok_1_314b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "whisper-small": "whisper_small",
    "qwen2-1.5b": "qwen2_1_5b",
    "chatglm3-6b": "chatglm3_6b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "mamba2-370m": "mamba2_370m",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
}


def get_config(arch: str, *, reduced: bool = False,
               **overrides) -> ModelConfig:
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; choose from {list(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    cfg = mod.reduced() if reduced else mod.CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def all_archs():
    return list(ARCHS)
