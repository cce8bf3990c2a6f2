# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Shared machinery of the sieve family (port of
``repro/core/sieve_family.py``): the residual accept threshold, stacking
and row selection of state dataclasses, and the ``SieveAlgorithm`` base
(ladder, hyperparameters, the per-item ``run`` over ``step``).

``StackedSieve`` (SieveStreaming, SieveStreaming++, Salsa) is not ported
yet; see ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.tree import tree_map

from .functions import LogDet
from .spec import HyperParams
from .thresholds import Ladder


def residual_threshold(target, fval, n, K):
    """(target - f(S)) / max(K - |S|, 1) — the family's accept bar."""
    denom = torch.clamp_min(K - n, 1).to(fval.dtype)
    return (target - fval) / denom


def stack_states(tree, n: int):
    """Copy one state to a stacked (n, ...) instance axis."""
    return tree_map(lambda l: l.expand((n,) + tuple(l.shape)).clone(), tree)


def tree_select(mask: torch.Tensor, on_true, on_false):
    """Per-row select between two stacked states: row i of ``on_true``
    where ``mask[i]``, else of ``on_false`` (fresh tensors)."""
    return tree_map(
        lambda a, b: torch.where(
            mask.reshape(tuple(mask.shape) + (1,) * (a.dim() - 1)), a, b),
        on_true, on_false)


@dataclasses.dataclass(frozen=True)
class SieveAlgorithm:
    """Base protocol: init / step / run / run_batched / summary.

    ``f.K`` sizes the summary buffers (K_max rows); ``eps`` (and
    ThreeSieves' ``T``) fill the default ``HyperParams``.  The effective
    (K, T, eps) of a run live in ``state.hp``.
    """

    f: LogDet
    eps: float = 0.1

    @property
    def ladder(self) -> Ladder:
        return Ladder(eps=self.eps, m=self.f.singleton_value, K=self.f.K)

    def default_hyper(self) -> HyperParams:
        return HyperParams.build(K=self.f.K, T=int(getattr(self, "T", 1)),
                                 eps=self.eps, m=self.f.singleton_value,
                                 lengthscale=self.f.kernel.lengthscale,
                                 kernel_kind=self.f.kernel.kind,
                                 device=self.f.device)

    def hyper(self, *, K=None, T=None, eps=None, lengthscale=None,
              kernel_kind=None) -> HyperParams:
        """Per-instance hyperparams validated against this algorithm's
        capacities (``None`` keeps the default)."""
        K = self.f.K if K is None else int(K)
        T = int(getattr(self, "T", 1)) if T is None else int(T)
        eps = self.eps if eps is None else float(eps)
        if lengthscale is None:
            lengthscale = self.f.kernel.lengthscale
        if kernel_kind is None:
            kernel_kind = self.f.kernel.kind
        if K > self.f.K:
            raise ValueError(
                f"K={K} exceeds this program's summary capacity "
                f"K_max={self.f.K}; construct the algorithm (or pod) with "
                "K >= the largest tenant budget")
        return HyperParams.build(K=K, T=T, eps=eps,
                                 m=self.f.singleton_value,
                                 lengthscale=lengthscale,
                                 kernel_kind=kernel_kind,
                                 device=self.f.device)

    def init(self, hyper: HyperParams | None = None):
        raise NotImplementedError

    def step(self, state, x: torch.Tensor):
        raise NotImplementedError

    def run(self, state, X: torch.Tensor, n_valid=None):
        """Per-item loop over ``step``; ``n_valid`` limits it to the
        prefix ``X[:n_valid]`` (the padded tail leaves the state as is)."""
        B = X.shape[0]
        nv = B if n_valid is None else min(max(int(n_valid), 0), B)
        for i in range(nv):
            state = self.step(state, X[i])
        return state

    def run_batched(self, state, X: torch.Tensor, n_valid=None):
        return self.run(state, X, n_valid)

    def summary(self, state) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        raise NotImplementedError

    def insertions(self, state) -> torch.Tensor:
        """Total summary insertions so far — monotone over the stream."""
        raise NotImplementedError
