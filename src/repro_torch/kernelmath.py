# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Kernel math shared by the objective and the kernels' plain versions
(port of ``repro/kernelmath.py``).

``KernelParams`` holds a session's kernel hyperparameters as 0-dim
tensors: ``inv2l2 = 1/(2 l^2)`` (derived once on the host in float64 and
rounded to f32 by ``core.spec.HyperParams.build``) and the kind id.  The
CUDA kernels read the same two scalars per session, so tenants with
different kernels share one launch.

``traced_gain_rows`` is the plain version of the traced gain pass of the
CUDA kernels (``csrc/gain_rows.cuh``).  Its op order is the JAX
package's: one Gram matmul, ``exp(-inv2l2 * d2)`` for rbf, and the
``linear_norm`` normalisation applied to the Gram entries after the
matmul.  Both functions broadcast over leading instance axes of the
summary (``y`` / ``feats`` (I, K, d), ``linv`` (I, K, K)), the plain form
of the stacked ``gain_traced`` launch.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.constants import GAIN_EPS, NORM_EPS

KERNEL_KIND_IDS = {"rbf": 0, "linear_norm": 1}


@dataclasses.dataclass(frozen=True)
class KernelParams:
    """Per-session kernel hyperparameters as 0-dim tensors."""

    inv2l2: torch.Tensor  # () float32 — 1 / (2 * lengthscale^2)
    kind_id: torch.Tensor  # () int32 — KERNEL_KIND_IDS[kind]

    @classmethod
    def of(cls, config, *, device) -> "KernelParams":
        """Host-side conversion from a static ``KernelConfig``."""
        return cls(
            inv2l2=torch.tensor(1.0 / (2.0 * float(config.lengthscale) ** 2),
                                dtype=torch.float32, device=device),
            kind_id=torch.tensor(KERNEL_KIND_IDS[config.kind],
                                 dtype=torch.int32, device=device),
        )


def pairwise_traced(x: torch.Tensor, y: torch.Tensor,
                    kern: KernelParams) -> torch.Tensor:
    """k(x_i, y_j) for x (N, d), y (M, d) -> (N, M), kernel from tensors.

    Both kinds read the one Gram matmul and the selection is branch-free,
    as in the JAX package.
    """
    g = x @ y.mT  # (N, M)
    xn2 = torch.sum(x * x, dim=-1, keepdim=True)  # (N, 1)
    yn2 = torch.sum(y * y, dim=-1, keepdim=True).mT  # (1, M)
    d2 = torch.clamp_min(xn2 + yn2 - 2.0 * g, 0.0)
    rbf = torch.exp(-kern.inv2l2.to(x.dtype) * d2)
    nx = torch.clamp_min(torch.sqrt(xn2), NORM_EPS)
    ny = torch.clamp_min(torch.sqrt(yn2), NORM_EPS)
    lin = 0.5 * (g / (nx * ny) + 1.0)
    return torch.where(kern.kind_id == 0, rbf, lin)


def traced_gain_rows(x: torch.Tensor, feats: torch.Tensor,
                     linv: torch.Tensor, mask: torch.Tensor, *, a: float,
                     kern: KernelParams) -> torch.Tensor:
    """Marginal gains of candidate rows x (B, d) -> (B, 1).

        Km   = a * k(x, feats) * mask          (B, K)
        C    = Km @ Linv^T                     (B, K)
        gain = 1/2 log((1+a) - |C_row|^2)      (B, 1)

    ``mask`` broadcasts over rows ((K,) or (1, K); (I, 1, K) for stacked
    summaries, which give (I, B, 1)).
    """
    km = a * pairwise_traced(x, feats, kern) * mask  # (B, K)
    c = km @ linv.mT  # (B, K)
    cn2 = torch.sum(c * c, dim=-1, keepdim=True)  # (B, 1)
    return 0.5 * torch.log(torch.clamp_min((1.0 + a) - cn2, GAIN_EPS))
