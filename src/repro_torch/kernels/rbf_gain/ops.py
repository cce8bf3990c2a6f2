# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Public gain-pass wrapper (port of ``repro/kernels/rbf_gain/ops.py:
fused_gains_traced``).

A CUDA tensor goes to the ``gain_traced`` kernel; a CPU tensor to its
plain version.  There is no fallback from one to the other.  No padding:
the CUDA kernel masks its own ragged edges.
"""
from __future__ import annotations

import torch

from repro_torch.kernelmath import KernelParams

from .kernel import gain_traced
from .ref import gain_traced_ref


def fused_gains_traced(x: torch.Tensor, feats: torch.Tensor,
                       linv: torch.Tensor, n: torch.Tensor,
                       kern: KernelParams, *, a: float) -> torch.Tensor:
    """Marginal gains of x (B, d) against a summary -> (B,) f32."""
    if not x.is_cuda:
        return gain_traced_ref(x, feats, linv, n, kern, a=a)
    return gain_traced(
        x.to(torch.float32).contiguous(), feats.contiguous(),
        linv.contiguous(), n.to(torch.int32).reshape(1),
        kern.inv2l2.to(torch.float32).reshape(1),
        kern.kind_id.to(torch.int32).reshape(1), a=a)
