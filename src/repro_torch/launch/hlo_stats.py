# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Collective traffic of a traced program (port of
``repro/launch/hlo_stats.py``, which parses it out of XLA's HLO text).

Eager PyTorch has no HLO: ``CollectiveCounter`` is a
``TorchDispatchMode`` that sees the collectives a program issues on this
rank, the functional ones DTensor redistributes with
(``_c10d_functional``: all-gather, all-reduce, reduce-scatter,
all-to-all; DTensor's own ``shard_dim_alltoall``) and the eager ones
(``c10d``: the same four, broadcast, and send / recv, the point-to-point
pairs a collective-permute is made of), and records each one's operand
bytes under the reference's five kinds.  The mode lets DTensor run first
(it declines ops on DTensors), so it sees the local program of one rank:
the per-shard convention of the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name (namespace::name, no overload) -> kind
_KINDS = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_reduce_coalesced_": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allreduce_": "all-reduce",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::broadcast_": "all-reduce",
    "c10d::send": "collective-permute",
}
# the positional argument that holds a collective's operand(s): the
# eager c10d ops take their output buffers first
_OPERAND = {"c10d::allgather_": 1, "c10d::_allgather_base_": 1,
            "c10d::reduce_scatter_": 1, "c10d::_reduce_scatter_base_": 1,
            "c10d::alltoall_base_": 1}


def op_name(func) -> str:
    """``namespace::name`` of an OpOverload, without its overload."""
    return func._schema.name


def tensor_bytes(x) -> int:
    """Bytes of every tensor in ``x`` (a tensor or a list / tuple)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(tensor_bytes(t) for t in x)
    return 0


def collective_kind(func):
    """The reference's kind of a collective op, or ``None``."""
    return _KINDS.get(op_name(func))


def operand_bytes(func, args) -> int:
    """A collective's operand bytes (its input, not its output buffer)."""
    return tensor_bytes(args[_OPERAND.get(op_name(func), 0)])


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def as_dict(self) -> Dict:
        return {
            "total_bytes": self.total_bytes,
            "total_count": self.total_count,
            "bytes_by_kind": dict(self.bytes_by_kind),
            "count_by_kind": dict(self.count_by_kind),
        }


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives issued on this rank while active:
    ``with CollectiveCounter() as c: program()`` then ``c.stats()``."""

    def __init__(self):
        super().__init__()
        self.bytes_by_kind = {k: 0 for k in COLLECTIVES}
        self.count_by_kind = {k: 0 for k in COLLECTIVES}

    def record(self, func, args) -> None:
        kind = collective_kind(func)
        if kind is not None:
            self.bytes_by_kind[kind] += operand_bytes(func, args)
            self.count_by_kind[kind] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs first, then its local ops
        self.record(func, args)
        return func(*args, **(kwargs or {}))

    def stats(self) -> CollectiveStats:
        return CollectiveStats(bytes_by_kind=dict(self.bytes_by_kind),
                               count_by_kind=dict(self.count_by_kind))


def collective_stats(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` and count its collectives on this rank
    -> (its result, ``CollectiveStats``)."""
    with CollectiveCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.stats()
