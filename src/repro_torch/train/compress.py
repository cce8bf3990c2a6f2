# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Int8 error-feedback gradient compression for the cross-pod reduction
(port of ``repro/train/compress.py``, one process).

Per leaf: v = g + e; q, scale = Q(v) (int8, symmetric per-tensor scale);
the pods' q are summed in int32 and decoded with the mean scale; the
local residual e' = v - Q^-1(q, scale) carries the rounding into the next
step, so its bias cancels over steps.

On one process there is no pod axis: ``Compressor()`` is the identity
with ``compress_ratio`` 1.0, as the reference is on a mesh without a
``pod`` axis, and ``_leaf`` is the reference's per-pod body at npods = 1
(the psums over one pod are the values themselves).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

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
    """Int8 error-feedback mean over the pods; on one process, one pod."""

    def init_ef(self, grads_like) -> Any:
        """Zero error-feedback residuals, mirroring the grad tree."""
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device), grads_like)

    def _leaf(self, g: torch.Tensor, e: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's per-pod body at npods = 1: (the reduced
        gradient in g's dtype, the new residual)."""
        v = g.float() + e
        q, scale = _quantize(v)
        qsum, ssum, npods = q.to(torch.int32), scale, 1.0
        mean_scale = ssum / npods
        reduced = qsum.float() * mean_scale / npods
        new_e = v - _dequantize(q, scale)
        return reduced.to(g.dtype), new_e

    def compress_reduce(self, grads, ef_state
                        ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
        """(grads, ef_state, {"compress_ratio"}): one pod, so the
        identity and 1.0."""
        leaves = ([grads] if isinstance(grads, torch.Tensor)
                  else list(leaves_with_keys(grads).values()))
        dev = leaves[0].device if leaves else None
        return grads, ef_state, {"compress_ratio": torch.tensor(
            1.0, dtype=torch.float32, device=dev)}


def reference_reduce(grads_per_pod):
    """Oracle for tests: exact float32 mean over pods (a list of grad
    trees)."""
    n = len(grads_per_pod)
    return tree_map(lambda *gs: sum(g.float() for g in gs) / n,
                    *grads_per_pod)
