# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The batched marginal-gain oracle (port of ``repro/core/oracle.py``).

Two query forms, each with a CUDA kernel:

    kern=KernelParams  the session's kernel as tensors (ThreeSieves, the
                       stacked sieves): ``gain_traced``, twin of the TPU
                       kernel ``gain_pallas_traced``; stacked summaries
                       (feats (I, K, d)) take one launch;
    kern=None          the objective's static ``KernelConfig`` (Greedy,
                       the baselines): ``gain_static``, twin of
                       ``gain_pallas``.

Backends:

    auto    the kernel for a CUDA tensor, its plain PyTorch version for a
            CPU tensor (``kernels.rbf_gain.ops``);
    torch   the plain version on any device (the yardstick the kernels
            are held against on the card); for ``kern=None`` the
            ``KernelConfig.pairwise`` form, twin of the JAX oracle's
            ``jnp`` branch;
    cuda    the kernel; a CPU tensor raises.

``resolve_backend(backend, device)`` names the route a backend takes for
inputs on ``device``: ``cuda`` (the kernel), ``plain`` (the kernel's
plain version: ``auto`` on a CPU tensor) or ``torch``.  The process
default (``make(backend=None)``) is ``REPRO_TORCH_ORACLE_BACKEND``, else
``auto``; the variable is the port's own, so an environment set up for
the JAX package's ``pallas`` / ``jnp`` cannot reach it.

There is no fallback between them: a kernel that cannot build or launch
raises, and where the reference degrades an explicit kernel request to
its plain path with a warning (``pallas`` off the TPU), the port raises
``ValueError``; so it has no ``backend_fallback_total`` to record.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.constants import GAIN_EPS
from repro_torch.kernels.rbf_gain import (fused_gains, fused_gains_traced,
                                          gain_traced_ref)

from .functions import KernelConfig, KernelParams

BACKENDS = ("auto", "torch", "cuda")
_ENV_VAR = "REPRO_TORCH_ORACLE_BACKEND"


def default_backend() -> str:
    """Process-wide default: ``REPRO_TORCH_ORACLE_BACKEND``, else auto."""
    backend = os.environ.get(_ENV_VAR, "auto")
    if backend not in BACKENDS:
        raise ValueError(
            f"{_ENV_VAR}={backend!r} invalid; choose from {BACKENDS}")
    return backend


def resolve_backend(backend: str, device) -> str:
    """The route ``backend`` takes for inputs on ``device``: ``cuda``
    (the kernel), ``plain`` (``auto`` on a CPU tensor: the kernel's plain
    version) or ``torch``.  An explicit ``cuda`` for a CPU tensor raises
    ``ValueError``: the port never falls back."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} invalid; choose from "
                         f"{BACKENDS}")
    on_card = torch.device(device).type == "cuda"
    if backend == "auto":
        return "cuda" if on_card else "plain"
    if backend == "cuda" and not on_card:
        raise ValueError("oracle backend 'cuda' needs CUDA tensors, got "
                         f"them on {device}; the port does not fall back "
                         "to the plain version")
    return backend


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

    def resolved(self, device) -> str:
        """The route of this oracle's backend for inputs on ``device``
        (``resolve_backend``)."""
        return resolve_backend(self.backend, device)

    @property
    def inv2l2(self) -> float:
        """1/(2 l^2) of the static kernel (a by-value kernel constant)."""
        return 1.0 / (2.0 * float(self.kernel.lengthscale) ** 2)

    def gains(self, feats: torch.Tensor, linv: torch.Tensor, n: torch.Tensor,
              X: torch.Tensor, kern: KernelParams | None = None
              ) -> torch.Tensor:
        """feats (K, d), linv (K, K), n () live rows, X (B, d) -> (B,);
        with ``kern``, also stacked feats (I, K, d), linv (I, K, K),
        n (I,) -> (I, B), and grouped X (G, B, d) with ``kern`` leaves of
        G elements: run g of the I / G summaries against X[g] with kernel
        g (a pod's slots in one launch) -> (I, B)."""
        # cuda and plain both go through the kernel wrappers, which take
        # the kernel on a CUDA tensor and its plain version on the CPU
        route = self.resolved(X.device)
        if kern is None:
            if route == "torch":
                return self._static_gains(feats, linv, n, X)
            return fused_gains(X, feats, linv, n, a=self.a,
                               inv2l2=self.inv2l2,
                               kind=self.kernel.kind).to(self.dtype)
        if route == "torch":
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
        """Single-item query (d,) -> () — a B=1 batch ((I,) for stacked
        summaries)."""
        return self.gains(feats, linv, n, x[None, :], kern=kern)[..., 0]


def make(kernel: KernelConfig, a: float = 1.0, *, backend: str | None = None,
         dtype: torch.dtype = torch.float32) -> GainOracle:
    """Build a ``GainOracle``; ``backend=None`` reads the process default
    (``default_backend``)."""
    return GainOracle(kernel=kernel, a=a,
                      backend=backend or default_backend(), dtype=dtype)
