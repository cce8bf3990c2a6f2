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


def copy_into(dst: Any, src: Any, rows=None) -> Any:
    """Copy the leaves of ``src`` into ``dst``'s tensors in place (the
    port's stand-in for a donated update) -> ``dst``: every leaf, or only
    the leading-axis ``rows`` (an index tensor) of each; a leaf of
    ``src`` that already is ``dst``'s own data is left."""
    for d, s in zip(leaves_with_keys(dst).values(),
                    leaves_with_keys(src).values()):
        if rows is not None:
            d.index_copy_(0, rows, s)
        elif s.data_ptr() != d.data_ptr():
            d.copy_(s)
    return dst


def _flatten(tree: Any):
    """(tensor leaves, rebuild) of a dataclass tree, a tuple / list of
    trees, a tensor or ``None``."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda it: next(it)
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(t) for t in tree]
        return ([l for ls, _ in parts for l in ls],
                lambda it: type(tree)(r(it) for _, r in parts))
    if dataclasses.is_dataclass(tree):
        leaves = list(leaves_with_keys(tree).values())
        return leaves, lambda it: tree_map(lambda _: next(it), tree)
    return [], lambda it: tree


def vmap(fn: Callable) -> Callable:
    """``torch.func.vmap`` over dataclass trees (the JAX package's
    ``jax.vmap`` of a state pytree): every tensor leaf of every argument
    is mapped along its leading axis; the result's dataclasses come back
    with the mapped axis leading.  A result leaf that does not depend on
    a mapped input comes back expanded (stride 0): copy it before writing
    into it."""
    def mapped(*args):
        flat = [_flatten(a) for a in args]
        out_rebuild = []

        def inner(*leaf_lists):
            out = fn(*(r(iter(ls)) for (_, r), ls in zip(flat, leaf_lists)))
            leaves, rebuild = _flatten(out)
            out_rebuild.append(rebuild)
            return tuple(leaves)

        outs = torch.func.vmap(inner)(*(ls for ls, _ in flat))
        return out_rebuild[0](iter(outs))

    return mapped
