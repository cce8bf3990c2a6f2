# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Int8 error-feedback gradient compression for the cross-pod reduction
(port of ``repro/train/compress.py``).

Per leaf: v = g + e; q, scale = Q(v) (int8, symmetric per-tensor scale);
the pods' q are summed in int32 over the mesh's ``pod`` axis and decoded
with the mean scale; the local residual e' = v - Q^-1(q, scale) carries
the rounding into the next step, so its bias cancels over steps.

Each pod is a rank along the ``pod`` axis of a device mesh; the psums of
the JAX ``shard_map`` body are ``launch.mesh.all_reduce_sum`` over that
axis's group.  The sum runs on int32, 4 bytes a parameter on the wire, as
the reference's psum does: ``compress_ratio`` 4.0 counts the int8 payload
before the sum, not the bytes the reduction moves.

``Compressor()`` (no mesh) or a mesh without the axis is the identity
with ``compress_ratio`` 1.0, as the reference is on a mesh without a
``pod`` axis, so the same train step runs on one pod; ``_leaf`` there is
the reference's per-pod body at npods = 1 (the psums over one pod are the
values themselves).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.launch.mesh import all_reduce_sum
from repro_torch.tree import leaves_with_keys, tree_map


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp -> (int8, scale).  Symmetric per-tensor scaling; ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Int8 error-feedback mean over the ranks of ``mesh``'s ``axis``
    (``pod``)."""

    mesh: Any = None  # a DeviceMesh
    axis: str = "pod"

    @property
    def active(self) -> bool:
        return (self.mesh is not None
                and self.axis in self.mesh.mesh_dim_names)

    def init_ef(self, grads_like) -> Any:
        """Zero error-feedback residuals, mirroring the grad tree."""
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device), grads_like)

    def _leaf(self, g: torch.Tensor, e: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's per-pod body: (the reduced gradient in g's
        dtype, the new residual)."""
        v = g.float() + e
        q, scale = _quantize(v)
        if self.active:
            # int8 payloads sum in int32; scales travel alongside as one
            # float32 scalar per leaf
            qsum = all_reduce_sum(q.to(torch.int32), self.mesh, self.axis)
            ssum = all_reduce_sum(scale, self.mesh, self.axis)
            npods = float(self.mesh.get_group(self.axis).size())
        else:
            qsum, ssum, npods = q.to(torch.int32), scale, 1.0
        # decode with the mean scale: every pod used its own
        mean_scale = ssum / npods
        reduced = qsum.float() * mean_scale / npods
        new_e = v - _dequantize(q, scale)  # local residual
        return reduced.to(g.dtype), new_e

    def compress_reduce(self, grads, ef_state
                        ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
        """(reduced grads, new residuals, {"compress_ratio"}): the pod
        mean leaf by leaf; inactive, the identity and 1.0."""
        leaves = ([grads] if isinstance(grads, torch.Tensor)
                  else list(leaves_with_keys(grads).values()))
        dev = leaves[0].device if leaves else None
        if not self.active:
            return grads, ef_state, {"compress_ratio": torch.tensor(
                1.0, dtype=torch.float32, device=dev)}
        pairs = []  # (reduced, residual) per leaf, in tree order
        grads2 = tree_map(lambda g, e: pairs.append(self._leaf(g, e))
                          or pairs[-1][0], grads, ef_state)
        it = iter(pairs)
        ef2 = tree_map(lambda _: next(it)[1], grads)
        # int8 payload + fp32 scale vs fp32 payload
        return grads2, ef2, {"compress_ratio": torch.tensor(
            4.0, dtype=torch.float32, device=dev)}


def reference_reduce(grads_per_pod):
    """Oracle for tests: exact float32 mean over pods (a list of grad
    trees)."""
    n = len(grads_per_pod)
    return tree_map(lambda *gs: sum(g.float() for g in gs) / n,
                    *grads_per_pod)
