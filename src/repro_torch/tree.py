# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Nested frozen dataclasses (or nested dicts) of tensors as the port's
pytrees.

The JAX package registers its state dataclasses as pytrees; the port
keeps plain frozen dataclasses and walks them here.  Leaves are tensors;
``None`` fields and ``torch.Generator`` fields (the random baseline's
draws) pass through untouched and are no leaves.  A model's parameters
are nested dicts, walked by ``leaves_with_keys`` too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over dataclasses of identical structure."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if tree is None or isinstance(tree, torch.Generator):
        return tree
    return fn(tree, *rest)


def leaves_with_keys(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"ld/feats": tensor, ...}`` — the key scheme of the JAX
    package's ``ckpt.store._flatten_with_keys`` (field names, or dict
    keys, joined by ``/``)."""
    out: Dict[str, torch.Tensor] = {}
    items = (tree.items() if isinstance(tree, dict) else
             ((f.name, getattr(tree, f.name))
              for f in dataclasses.fields(tree)))
    for name, v in items:
        key = f"{prefix}{name}"
        if dataclasses.is_dataclass(v) or isinstance(v, dict):
            out.update(leaves_with_keys(v, key + "/"))
        elif isinstance(v, torch.Tensor):
            out[key] = v
    return out
