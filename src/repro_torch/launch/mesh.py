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

The model on a mesh: ``use_mesh`` sets the ambient mesh the model code
lays its activations out on (``models.layers.shard_act``);
``distribute`` / ``distribute_tree`` turn a tree every rank holds alike
into DTensors; ``register_host_backend`` is the process-group backend
for ranks that share one card when DTensor drives the collectives.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Dict, Sequence

import torch

from repro_torch.device import resolve_device


_AMBIENT = contextvars.ContextVar("repro_torch_ambient_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """The ambient mesh of the model code inside the block (the JAX
    package's ``with mesh:``): ``models.layers.shard_act`` lays the
    activations out on it.  Inside, a plain tensor that meets a DTensor
    (a RoPE table, a causal mask) counts as replicated, as a constant
    does under GSPMD.  ``None`` clears it."""
    from torch.distributed.tensor.experimental import implicit_replication

    token = _AMBIENT.set(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _AMBIENT.reset(token)


def ambient_mesh():
    """The mesh of the innermost ``use_mesh`` block, or ``None``."""
    return _AMBIENT.get()


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


def local_slices(shape, mesh, pl: Sequence) -> tuple:
    """This rank's block of a tensor of ``shape`` laid out with placements
    ``pl`` on ``mesh``, as one slice a dimension (``torch.chunk``'s
    split; a dimension split over several mesh axes splits in mesh order,
    the first major)."""
    from torch.distributed.tensor import Shard

    start, length = [0] * len(shape), list(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            d = p.dim % len(shape)
            cs = -(-length[d] // mesh.size(i))
            lo = coord[i] * cs
            start[d] += lo
            length[d] = max(0, min(cs, length[d] - lo))
    return tuple(slice(a, a + n) for a, n in zip(start, length))


def distribute(t: torch.Tensor, mesh, pl: Sequence) -> torch.Tensor:
    """A DTensor with placements ``pl`` on ``mesh`` from the full tensor
    ``t`` that every rank holds alike (one seed, one checkpoint): each
    rank keeps a copy of its own block (``local_slices``), with no
    communication, so the full tensor can be freed; a tensor whole on
    every rank is kept as it is."""
    from torch.distributed.tensor import DTensor

    local = t[local_slices(t.shape, mesh, pl)]
    if tuple(local.shape) != tuple(t.shape):  # a block: a copy of its own
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, tuple(pl), run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_tree(tree, placements_tree, mesh):
    """``distribute`` leaf by leaf (nested dicts): each leaf with the
    placements at the same key, as ``launch.sharding.shardings`` gives
    them."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, placements_tree[k], mesh)
                for k, v in tree.items()}
    return distribute(tree, mesh, placements_tree)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a collective: every rank calls it); any
    other tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


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


# ------------------------------------------ ranks that share one card
def register_host_backend() -> str:
    """Register (once) a process-group backend for ranks that share one
    card: each collective copies its CUDA tensors to the host, runs there
    on a gloo group and copies the result back.  NCCL puts no two ranks
    of one group on one card, and gloo's own CUDA path crashed in the
    functional all-gather that DTensor redistributes with (the H100,
    PyTorch 2.11).  A reduce-scatter is an all-reduce and a slice, an
    all-to-all an all-gather and a slice.  -> the backend's name, for
    ``init_process_group(name, ...)``."""
    import torch.distributed as dist

    name = "hostgloo"
    if name not in dist.Backend.backend_list:
        dist.Backend.register_backend(name, _host_group,
                                      devices=["cpu", "cuda"])
    return name


def _host_group(store, rank, size, timeout):
    return _host_group_class()(store, rank, size, timeout)


def _done(result):
    from torch._C._distributed_c10d import _create_work_from_future

    fut = torch.futures.Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


@functools.lru_cache(maxsize=None)
def _host_group_class():
    """The process-group class of ``register_host_backend`` (built on
    first use: it subclasses ``torch.distributed.ProcessGroup``)."""
    import torch.distributed as dist

    class HostGroup(dist.ProcessGroup):
        def __init__(self, store, rank, size, timeout):
            super().__init__(rank, size)
            self._rank, self._size = rank, size
            self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)

        def getBackendName(self):
            return "hostgloo"

        def _set_group_name(self, name):
            self._name = name
            super()._set_group_name(name)

        @property
        def group_name(self):
            return self._name

        def size(self):
            return self._size

        def rank(self):
            return self._rank

        def _gather(self, t):
            src = t.detach().cpu().contiguous().reshape(-1)
            out = torch.empty(self._size * src.numel(), dtype=t.dtype)
            self._gloo._allgather_base(out, src).wait()
            return out.reshape((self._size,) + tuple(t.shape))

        def allreduce(self, tensors, opts=None):
            from torch.distributed import AllreduceOptions

            opts = opts or AllreduceOptions()
            host = [t.detach().cpu() for t in tensors]
            self._gloo.allreduce(host, opts).wait()
            for t, h in zip(tensors, host):
                t.copy_(h)
            return _done(tensors)

        allreduce_coalesced = allreduce

        def all_gather_single(self, out, inp, opts=None):
            out.copy_(self._gather(inp).reshape(out.shape))
            return _done([out])

        _allgather_base = all_gather_single

        def allgather(self, outs, inps, opts=None):
            for o, i in zip(outs, inps):
                for dst, src in zip(o, self._gather(i)):
                    dst.copy_(src)
            return _done(outs)

        def allgather_into_tensor_coalesced(self, outs, inps, opts=None):
            for o, i in zip(outs, inps):
                self.all_gather_single(o, i)
            return _done(outs)

        def reduce_scatter_single(self, out, inp, opts=None):
            from torch.distributed import AllreduceOptions

            full = inp.detach().cpu().clone()
            ar = AllreduceOptions()
            if opts is not None:
                ar.reduceOp = opts.reduceOp
            self._gloo.allreduce([full], ar).wait()
            out.copy_(full.reshape((self._size,) + tuple(out.shape))[
                self._rank])
            return _done([out])

        _reduce_scatter_base = reduce_scatter_single

        def reduce_scatter_tensor_coalesced(self, outs, inps, opts=None):
            for o, i in zip(outs, inps):
                self.reduce_scatter_single(o, i, opts)
            return _done(outs)

        def reduce_scatter(self, outs, inps, opts=None):
            for o, parts in zip(outs, inps):
                self.reduce_scatter_single(o, torch.stack(list(parts)), opts)
            return _done(outs)

        def all_to_all_single(self, out, inp, out_splits=None,
                              in_splits=None, opts=None):
            if out_splits or in_splits:
                raise NotImplementedError("uneven all-to-all")
            every = self._gather(inp)  # (size, size * n, ...)
            n = inp.shape[0] // self._size
            mine = every[:, self._rank * n:(self._rank + 1) * n]
            out.copy_(mine.reshape(out.shape))
            return _done([out])

        alltoall_base = all_to_all_single

        def broadcast(self, tensors, opts=None):
            host = [t.detach().cpu() for t in tensors]
            self._gloo.broadcast(host, opts).wait()
            for t, h in zip(tensors, host):
                t.copy_(h)
            return _done(tensors)

        def scatter(self, outs, inps, opts=None):
            host_out = [t.detach().cpu() for t in outs]
            host_in = [[t.detach().cpu() for t in i] for i in inps]
            self._gloo.scatter(host_out, host_in, opts).wait()
            for t, h in zip(outs, host_out):
                t.copy_(h)
            return _done(outs)

        def barrier(self, opts=None):
            self._gloo.barrier().wait()
            return _done(None)

    return HostGroup
