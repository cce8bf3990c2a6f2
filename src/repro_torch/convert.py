# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Carry states across packages as flat numpy leaves.

Keys are the names the JAX package's checkpoint store gives its leaves
(``repro/ckpt/store.py:_flatten_with_keys``): field names joined by
``/``, e.g. ``algo/ld/feats``, ``lds/Linv``, ``hp/k_cap``, ``sid``.  A
pod (``PodState``) or an algorithm state (``TSState``, ``SieveState``,
``ISIState``, ``QSState``, a bare ``LogDetState``) saved by the JAX
package therefore loads into the port leaf for leaf, and back.

``RandomState`` carries its counters (feats, n, seen) only: the JAX PRNG
key has no ``torch.Generator`` counterpart, so its ``key`` leaf is not
read and the port's generator starts fresh from ``seed``.

A state sharded over a device mesh crosses as its global leaves (the
JAX package's P*S rows): ``split_sharded`` gives each rank its rows and
``join_sharded`` joins them back.

A model's parameter tree (the nested dict of the JAX package's
``Model.init``) carries across key for key (``model_params_from_jax``),
and so does an optimizer state (``opt_state_from_jax``).

A bfloat16 leaf crosses as its raw 16-bit words: numpy has no bfloat16
of its own and the port does not import ``ml_dtypes``.  Out, it is a
``uint16`` array of the bits (``leaf_to_numpy``; ``dtype_name`` gives
``"bfloat16"``, the name the JAX checkpoint store records); in, any
2-byte array that is not a float (``ml_dtypes.bfloat16``, the raw
``|V2`` that ``np.save`` writes for it, ``int16`` or ``uint16``) is
taken as bfloat16 bits and reinterpreted, never converted by value.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Dict, List

import numpy as np
import torch

from repro_torch.tree import leaves_with_keys


def _algo_states():
    from repro_torch.core.baselines import ISIState, QSState, RandomState
    from repro_torch.core.functions import LogDetState
    from repro_torch.core.sieves import SieveState
    from repro_torch.core.threesieves import TSState

    return (TSState, SieveState, QSState, ISIState, RandomState, LogDetState)


def _field_class(hint, flat, key):
    """The dataclass a field holds: its annotation, or, for a field typed
    ``Any`` (a pod's algorithm state), the state class whose leaves are
    the ones under ``key``; ``None`` for a tensor leaf."""
    if dataclasses.is_dataclass(hint):
        return hint
    if hint is not typing.Any:
        return None
    under = {k[len(key) + 1:] for k in flat if k.startswith(key + "/")}
    for cls in _algo_states():
        if set(_keys(cls, flat)) == under:
            return cls
    raise KeyError(f"no algorithm state has the leaves under {key!r}: "
                   f"{sorted(under)}")


def _build(cls, flat: Dict[str, np.ndarray], prefix: str, device, seed):
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        key = prefix + f.name
        sub = _field_class(hints[f.name], flat, key)
        if sub is not None:
            kw[f.name] = _build(sub, flat, key + "/", device, seed)
        elif hints[f.name] is torch.Generator:
            kw[f.name] = torch.Generator(device=device).manual_seed(seed)
        else:
            if key not in flat:
                raise KeyError(f"missing leaf {key!r}")
            kw[f.name] = tensor_from_numpy(flat[key], device)
    return cls(**kw)


def _keys(cls, flat, prefix=""):
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        sub = _field_class(hints[f.name], flat, prefix + f.name)
        if sub is not None:
            yield from _keys(sub, flat, prefix + f.name + "/")
        elif hints[f.name] is not torch.Generator:
            yield prefix + f.name


def state_from_numpy(cls, flat: Dict[str, np.ndarray], *, device,
                     seed: int = 0):
    """A port state of dataclass ``cls`` on ``device`` from flat numpy
    leaves; a ``torch.Generator`` field is seeded with ``seed``, and a
    pod's algorithm state takes the class its leaves name."""
    extra = set(flat) - set(_keys(cls, flat))
    if extra:
        raise KeyError(f"unknown leaves {sorted(extra)}")
    return _build(cls, flat, "", torch.device(device), seed)


def is_bf16_bits(arr: np.ndarray) -> bool:
    """A 2-byte array that is not a float: bfloat16 bits."""
    return arr.dtype.itemsize == 2 and arr.dtype.kind in "Viu"


def dtype_name(t: torch.Tensor) -> str:
    """The numpy name of a leaf's dtype (``"bfloat16"`` for bfloat16)."""
    return str(t.dtype).removeprefix("torch.")


def leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of one leaf, on every device (a CPU tensor's
    ``.numpy()`` would share its memory, and the pod steps its state in
    place); a bfloat16 leaf as the ``uint16`` array of its bits."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    out = t.to("cpu", copy=True).numpy()
    return out.view(np.uint16) if out.dtype == np.int16 else out


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """A tensor on ``device`` from one numpy leaf; 2-byte non-float data
    comes in as bfloat16 by reinterpreting the bits (``is_bf16_bits``)."""
    arr = np.asarray(arr)
    if is_bf16_bits(arr):
        return torch.from_numpy(np.array(arr.view(np.int16))).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """Flat numpy leaves of a port state: host copies on every device,
    a bfloat16 leaf as its ``uint16`` bits (``leaf_to_numpy``)."""
    return {k: leaf_to_numpy(v) for k, v in leaves_with_keys(state).items()}


def model_params_from_jax(tree, device):
    """The port's parameter tree from the JAX package's (a nested dict of
    numpy arrays, e.g. ``Model.init`` passed through ``np.asarray``):
    the same keys, shapes and dtypes, as tensors on ``device`` (a
    bfloat16 leaf by its bits, ``tensor_from_numpy``)."""
    if isinstance(tree, dict):
        return {k: model_params_from_jax(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def opt_state_from_jax(state, device):
    """The port's ``train.OptState`` from the JAX package's (``m`` and
    ``v`` nested dicts of numpy arrays like the parameters, ``step`` a
    numpy int32 scalar, e.g. the JAX state passed through ``np.asarray``
    leaf by leaf): the same keys, shapes and dtypes, on ``device``."""
    from repro_torch.train.optim import OptState

    return OptState(m=model_params_from_jax(state.m, device),
                    v=model_params_from_jax(state.v, device),
                    step=tensor_from_numpy(state.step, device))


def split_sharded(flat: Dict[str, np.ndarray], parts: int, *,
                  keep_axis: bool = True) -> List[Dict[str, np.ndarray]]:
    """A global state's flat leaves -> the ``parts`` ranks' own: leaf by
    leaf the leading axis split into equal pieces, in rank order (the
    rows ``shard_map`` hands each rank).  A JAX sharded pod state (P*S
    session rows) gives the P ranks' pod states; a distributed
    summarizer's stacked states (P rows) the ranks' (1, ...) states.
    ``keep_axis=False`` takes rows of one instead and drops the axis: a
    per-pod tree stacked on a leading pod axis (the compressor's
    error-feedback residuals, one tree a pod) gives each pod's tree."""
    out: List[Dict[str, np.ndarray]] = [{} for _ in range(parts)]
    for key, arr in flat.items():
        arr = np.asarray(arr)
        if arr.ndim == 0 or arr.shape[0] % parts:
            raise ValueError(f"leaf {key!r} of shape {arr.shape} does not "
                             f"split over {parts} ranks")
        if not keep_axis and arr.shape[0] != parts:
            raise ValueError(f"leaf {key!r} of shape {arr.shape} is not "
                             f"stacked over {parts} pods")
        for p, piece in enumerate(np.split(arr, parts)):
            out[p][key] = piece if keep_axis else piece[0]
    return out


def join_sharded(parts: List[Dict[str, np.ndarray]], *,
                 keep_axis: bool = True) -> Dict[str, np.ndarray]:
    """The inverse of ``split_sharded``: the ranks' flat leaves, in rank
    order, concatenated on the leading axis (``keep_axis=False``:
    stacked on a new one)."""
    join = np.concatenate if keep_axis else np.stack
    return {key: join([np.asarray(p[key]) for p in parts])
            for key in parts[0]}
