# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Device meshes and their collectives (port of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
caller's process group: one rank a device.  The axes keep the JAX names:

  * ``pod``   — inter-pod data parallelism (gradients cross it once a
                step, through ``train.compress``),
  * ``data``  — intra-pod data parallelism (the pod's sessions, the
                distributed summarizer's shards),
  * ``model`` — tensor parallelism (size 1 on the host mesh).

The meshes are functions, not module constants: importing this module
starts no process group.  The backend is the caller's group
(``torch.distributed.init_process_group``); only ``make_host_mesh`` on a
process with no group makes a one-rank group of its own.

``all_gather`` and ``all_reduce_sum`` are the collectives of the
``shard_map`` programs (``jax.lax.all_gather`` / ``psum`` over a named
axis): they run on the group of one mesh axis, on the tensors' own
device, whatever the group's backend.  NCCL takes CUDA tensors; so does
gloo for both collectives (checked on the H100 with PyTorch 2.11: the
all-gather into one tensor and the sum, float32 and int32), copying
them through host memory itself, which is what lets ranks that share
one card, where NCCL cannot put two ranks of one group, run on gloo.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from repro_torch.device import resolve_device


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(device, shape: Sequence[int], names: Sequence[str]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh: (16, 16) over ("data", "model"), or (2, 16,
    16) over ("pod", "data", "model"); the caller's group must hold
    exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, world = math.prod(shape), _world_size()
    if world != need:
        raise ValueError(f"the production mesh {shape} over {axes} needs a "
                         f"process group of {need} ranks; this one has "
                         f"{world}")
    return _mesh(resolve_device(device), shape, axes)


def make_host_mesh(device=None):
    """(world, 1) over ("data", "model") on the caller's group; on a
    process with no group, a one-rank group of its own (nccl on the
    card, gloo on the CPU), so the mesh is (1, 1) as the JAX one is."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return _mesh(dev, (dist.get_world_size(), 1), ("data", "model"))


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}, the JAX ``Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(axis) -> tuple:
    """A mesh axis (a name or a tuple of names) as a tuple of names."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def pspec(*parts) -> tuple:
    """A partition spec from one entry per tensor dimension, normalized
    as the JAX ``PartitionSpec`` is: a tuple of one axis name becomes the
    name, an empty tuple ``None``."""
    def entry(ax):
        if isinstance(ax, (tuple, list)):
            ax = tuple(ax)
            return None if not ax else ax[0] if len(ax) == 1 else ax
        return ax

    return tuple(entry(ax) for ax in parts)


def placements(spec: Sequence, mesh) -> tuple:
    """A partition spec (per tensor dimension a mesh axis name, a tuple
    of names or ``None``) -> the DTensor placements on ``mesh`` (per mesh
    dimension ``Shard(dim)`` or ``Replicate()``).  A dimension over a
    tuple of axes splits over them in mesh order, the first major, as a
    JAX ``PartitionSpec`` entry does."""
    from torch.distributed.tensor import Replicate, Shard

    by_axis = {}
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        for name in axis_names(ax):
            if name not in mesh.mesh_dim_names:
                raise ValueError(f"mesh axis {name!r} not in "
                                 f"{mesh.mesh_dim_names}")
            if name in by_axis:
                raise ValueError(f"mesh axis {name!r} used twice in {spec}")
            by_axis[name] = dim
    return tuple(Shard(by_axis[n]) if n in by_axis else Replicate()
                 for n in mesh.mesh_dim_names)


def all_gather(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``t`` along mesh ``axis``, concatenated on the leading
    dimension in the axis's order: (n * t.shape[0], ...)."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    src = t.contiguous()
    out = torch.empty((group.size() * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out


def all_reduce_sum(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of every rank's ``t`` along mesh ``axis`` (a new tensor,
    the same on every rank of the axis)."""
    import torch.distributed as dist

    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return out
