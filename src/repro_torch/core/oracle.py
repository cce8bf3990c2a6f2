# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The batched marginal-gain oracle (port of ``repro/core/oracle.py``).

Backends:

    auto    the ``gain_traced`` CUDA kernel for a CUDA tensor, the plain
            PyTorch version for a CPU tensor;
    torch   the plain version on any device (the yardstick the kernel is
            held against on the card);
    cuda    the kernel; a CPU tensor raises.

There is no fallback between them.  The static-``KernelConfig`` path
(``kern=None``, the twin of the TPU kernel ``gain_pallas``) has no CUDA
kernel yet: it runs the plain version on CPU tensors (and under
``torch``) and raises ``NotImplementedError`` for CUDA tensors.
ThreeSieves always passes its per-session ``KernelParams``, so the pod
never reaches it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.constants import GAIN_EPS
from repro_torch.kernels.rbf_gain import fused_gains_traced
from repro_torch.kernels.rbf_gain.ref import gain_traced_ref

from .functions import KernelConfig, KernelParams

BACKENDS = ("auto", "torch", "cuda")


@dataclasses.dataclass(frozen=True)
class GainOracle:
    """Batched gains for f(S) = 1/2 logdet(I + a Sigma_S):

        C    = Linv @ (a * k(S, X) * mask)       (K, B)
        gain = 1/2 * log((1 + a) - |C_col|^2)    (B,)
    """

    kernel: KernelConfig = KernelConfig()
    a: float = 1.0
    backend: str = "auto"
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} invalid; choose "
                             f"from {BACKENDS}")

    def gains(self, feats: torch.Tensor, linv: torch.Tensor, n: torch.Tensor,
              X: torch.Tensor, kern: KernelParams | None = None
              ) -> torch.Tensor:
        """feats (K, d), linv (K, K), n () live rows, X (B, d) -> (B,)."""
        if self.backend == "cuda" and not X.is_cuda:
            raise ValueError("oracle backend 'cuda' needs CUDA tensors, got "
                             f"X on {X.device}")
        if kern is None:
            if X.is_cuda and self.backend != "torch":
                raise NotImplementedError(
                    "the static-KernelConfig gain kernel (TPU twin "
                    "repro/kernels/rbf_gain/kernel.py:gain_pallas) is not "
                    "yet ported to CUDA; pass kern=KernelParams or use "
                    "backend='torch' (see ROADMAP.md)")
            return self._static_gains(feats, linv, n, X)
        if self.backend == "torch":
            return gain_traced_ref(X, feats, linv, n, kern,
                                   a=self.a).to(self.dtype)
        return fused_gains_traced(X, feats, linv, n, kern,
                                  a=self.a).to(self.dtype)

    def _static_gains(self, feats, linv, n, X):
        X = X.to(self.dtype)
        kidx = torch.arange(feats.shape[0], device=feats.device)
        mask = (kidx < n).to(self.dtype)
        KX = self.kernel.pairwise(feats, X) * mask[:, None]  # (K, B)
        C = linv @ (self.a * KX)  # (K, B)
        cn2 = torch.sum(C * C, dim=0)  # (B,)
        return 0.5 * torch.log(torch.clamp_min((1.0 + self.a) - cn2,
                                               GAIN_EPS))

    def gain1(self, feats: torch.Tensor, linv: torch.Tensor, n: torch.Tensor,
              x: torch.Tensor, kern: KernelParams | None = None
              ) -> torch.Tensor:
        """Single-item query (d,) -> () — a B=1 batch."""
        return self.gains(feats, linv, n, x[None, :], kern=kern)[0]


def make(kernel: KernelConfig, a: float = 1.0, *, backend: str | None = None,
         dtype: torch.dtype = torch.float32) -> GainOracle:
    """Build a ``GainOracle``; ``backend=None`` means ``auto``."""
    return GainOracle(kernel=kernel, a=a, backend=backend or "auto",
                      dtype=dtype)
