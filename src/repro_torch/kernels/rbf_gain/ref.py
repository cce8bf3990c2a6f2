# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Plain PyTorch version of the ``gain_traced`` CUDA kernel."""
from __future__ import annotations

import torch

from repro_torch.kernelmath import KernelParams, traced_gain_rows


def gain_traced_ref(x: torch.Tensor, feats: torch.Tensor, linv: torch.Tensor,
                    n: torch.Tensor, kern: KernelParams, *,
                    a: float) -> torch.Tensor:
    """x (B, d), feats (K, d), linv (K, K), n () live rows -> (B,) f32."""
    K = feats.shape[0]
    mask = (torch.arange(K, device=feats.device) < n).to(torch.float32)
    return traced_gain_rows(x.to(torch.float32), feats.to(torch.float32),
                            linv.to(torch.float32), mask[None, :],
                            a=a, kern=kern)[:, 0]
