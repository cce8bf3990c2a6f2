# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Carry a pod's state across packages as flat numpy leaves.

Keys are the names the JAX package's checkpoint store gives its
``PodState`` leaves (``repro/ckpt/store.py:_flatten_with_keys``): field
names joined by ``/``, e.g. ``algo/ld/feats``, ``algo/hp/k_cap``,
``sid``.  A pod checkpointed by the JAX package therefore loads into the
port leaf for leaf, and back.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Dict

import numpy as np
import torch

from repro_torch.serve.summarize import PodState
from repro_torch.tree import leaves_with_keys


def _build(cls, flat: Dict[str, np.ndarray], prefix: str, device):
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        key = prefix + f.name
        sub = hints[f.name]
        if dataclasses.is_dataclass(sub):
            kw[f.name] = _build(sub, flat, key + "/", device)
        else:
            if key not in flat:
                raise KeyError(f"missing leaf {key!r}")
            kw[f.name] = torch.from_numpy(np.array(flat[key])).to(device)
    return cls(**kw)


def pod_state_from_numpy(flat: Dict[str, np.ndarray], *, device) -> PodState:
    """A port ``PodState`` on ``device`` from flat numpy leaves."""
    extra = set(flat) - set(_keys())
    if extra:
        raise KeyError(f"unknown leaves {sorted(extra)}")
    return _build(PodState, flat, "", torch.device(device))


def pod_state_to_numpy(state: PodState) -> Dict[str, np.ndarray]:
    """Flat numpy leaves of a port ``PodState`` (host copies)."""
    return {k: v.detach().cpu().numpy()
            for k, v in leaves_with_keys(state).items()}


def _keys():
    def walk(cls, prefix):
        hints = typing.get_type_hints(cls)
        for f in dataclasses.fields(cls):
            if dataclasses.is_dataclass(hints[f.name]):
                yield from walk(hints[f.name], prefix + f.name + "/")
            else:
                yield prefix + f.name
    return list(walk(PodState, ""))
