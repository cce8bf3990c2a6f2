# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Architecture registry (port of ``repro.configs``): ``--arch <id>`` ->
``ModelConfig``, full or reduced.

Only the architectures the port runs are registered; the JAX package's
other ids raise ``NotImplementedError`` naming the ``ROADMAP.md`` item
that ports them.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models import ModelConfig
from repro_torch.models.config import ROADMAP_MOE_MLA

ARCHS = {
    "whisper-small": "whisper_small",
    "mamba2-370m": "mamba2_370m",
}
UNPORTED = {  # the JAX package's other architectures
    "grok-1-314b": ROADMAP_MOE_MLA,
    "deepseek-v2-lite-16b": ROADMAP_MOE_MLA,
    "qwen2-1.5b": ROADMAP_MOE_MLA,
    "chatglm3-6b": ROADMAP_MOE_MLA,
    "phi3-mini-3.8b": ROADMAP_MOE_MLA,
    "mistral-nemo-12b": ROADMAP_MOE_MLA,
    "jamba-1.5-large-398b": ROADMAP_MOE_MLA,
    "phi-3-vision-4.2b": ROADMAP_MOE_MLA,
}


def get_config(arch: str, *, reduced: bool = False,
               **overrides) -> ModelConfig:
    if arch in UNPORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet; {UNPORTED[arch]}")
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; choose from "
                         f"{list(ARCHS) + list(UNPORTED)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    cfg = mod.reduced() if reduced else mod.CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def all_archs():
    return list(ARCHS)
