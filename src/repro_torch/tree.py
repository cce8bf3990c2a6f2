# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Nested frozen dataclasses, dicts, tuples and NamedTuples of tensors as
the port's pytrees.

The JAX package registers its state dataclasses as pytrees; the port
keeps plain frozen dataclasses and walks them here.  Leaves are tensors;
``None`` fields and ``torch.Generator`` fields (the random baseline's
draws) pass through untouched and are no leaves.  A model's parameters
are nested dicts; a training checkpoint is the tuple ``(params,
OptState(m, v, step))``, keyed as JAX keys it: a tuple by the index, a
NamedTuple by the field name (``0/embed``, ``1/m/embed``, ``1/step``).

``vmap`` maps a function over the leading axis of such trees in one
process; ``shard_map`` maps it over the ranks of a device mesh, whose
global trees hold DTensors split on the leading axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch


def _is_namedtuple(t: Any) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of identical structure."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return (type(tree)(*out) if _is_namedtuple(tree)
                else type(tree)(out))
    if tree is None or isinstance(tree, torch.Generator):
        return tree
    return fn(tree, *rest)


def _items(tree: Any):
    """(key, child) pairs of one node: dict keys, NamedTuple fields,
    tuple indices, dataclass fields."""
    if isinstance(tree, dict):
        return tree.items()
    if _is_namedtuple(tree):
        return zip(tree._fields, tree)
    if isinstance(tree, tuple):
        return ((str(i), v) for i, v in enumerate(tree))
    return ((f.name, getattr(tree, f.name))
            for f in dataclasses.fields(tree))


def _is_node(t: Any) -> bool:
    """Whether ``t`` is an inner node of a tree (not a leaf)."""
    return dataclasses.is_dataclass(t) or isinstance(t, (dict, tuple))


def leaves_with_keys(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"ld/feats": tensor, ...}`` — the key scheme of the JAX
    package's ``ckpt.store._flatten_with_keys`` (field names, dict keys
    or tuple indices, joined by ``/``)."""
    out: Dict[str, torch.Tensor] = {}
    for name, v in _items(tree):
        key = f"{prefix}{name}"
        if _is_node(v):
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


def _shard0(mesh, axis) -> tuple:
    from repro_torch.launch.mesh import placements

    return placements((axis,), mesh)


def shard_tree(tree: Any, mesh, axis) -> Any:
    """Each rank's local tree -> the global tree: every tensor leaf a
    DTensor split on its leading dimension over mesh ``axis`` (a name or a
    tuple of names), ``Shard(0)``, and replicated over the mesh's other
    axes.  The local tensors are wrapped, not copied; every rank's leaf
    must have the same shape."""
    from torch.distributed.tensor import DTensor

    pl = _shard0(mesh, axis)
    return tree_map(lambda l: DTensor.from_local(l, mesh, pl,
                                                 run_check=False), tree)


def local_tree(tree: Any, mesh, axis) -> Any:
    """A global tree of ``shard_tree``'s placements -> this rank's local
    tensors (the DTensors' own storage, no copy)."""
    from torch.distributed.tensor import DTensor

    pl = _shard0(mesh, axis)

    def local(l):
        if not isinstance(l, DTensor):
            raise TypeError(f"a global leaf must be a DTensor, got "
                            f"{type(l).__name__}")
        if l.device_mesh != mesh or tuple(l.placements) != pl:
            raise ValueError(f"a leaf on {l.device_mesh} with placements "
                             f"{l.placements}, expected {pl} on {mesh}")
        return l.to_local()

    return tree_map(local, tree)


def shard_map(fn: Callable, mesh, axis) -> Callable:
    """``shard_map`` over the leading dimension (the JAX package's
    ``shard_map`` with every in and out spec ``P(axis)``): ``fn`` takes
    and returns trees of one rank's local tensors; the mapped function
    takes and returns global trees whose leaves are DTensors split on the
    leading dimension over ``axis`` (``shard_tree``).  ``axis`` is a mesh
    axis name or a tuple of names: ``("pod", "data")`` splits the leading
    dimension over both, pod-major."""
    def mapped(*args):
        out = fn(*(local_tree(a, mesh, axis) for a in args))
        return shard_tree(out, mesh, axis)

    return mapped
