# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The IVM log-determinant objective as an incremental Cholesky state
(port of ``repro/core/functions.py``).

    f(S) = 1/2 * log det(I + a * Sigma_S),   Sigma_S[i, j] = k(e_i, e_j)

Fixed-shape, zero-padded buffers: ``feats`` (K, d), the Cholesky factor
``L`` (K, K) of ``I + a Sigma_S`` and its explicit inverse ``Linv``, the
live row count ``n`` and ``fval``.  Appending e:

    c    = Linv @ (a * k_S(e))
    dd   = sqrt((1 + a) - |c|^2)        gain = log dd
    L    <- [[L, 0], [c^T, dd]]
    Linv <- [[Linv, 0], [-(c^T Linv)/dd, 1/dd]]

Every method is functional: it returns new tensors and leaves its input
untouched.  (``kernels.pod_step`` is the one place that updates these
buffers in place.)  ``maybe_append_stacked`` is the twin of
``jax.vmap(f.maybe_append)`` over stacked instances; ``refactor`` and
``evaluate`` factor an explicit summary buffer from scratch (the
replacement baselines), over any leading batch axes.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.constants import GAIN_EPS, NORM_EPS
from repro_torch.device import resolve_device
from repro_torch.kernelmath import (KERNEL_KIND_IDS, KernelParams,
                                    pairwise_traced, traced_gain_rows)
from repro_torch.tree import tree_map

__all__ = [
    "KERNEL_KIND_IDS", "KernelConfig", "KernelParams", "LogDet",
    "LogDetState", "naive_logdet", "pairwise_traced",
    "rbf_lengthscale_batch", "rbf_lengthscale_stream", "traced_gain_rows",
]


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Positive-definite kernel. ``rbf`` is the paper's choice."""

    kind: str = "rbf"  # "rbf" | "linear_norm"
    lengthscale: float = 1.0

    def pairwise(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """k(x_i, y_j) for x (..., N, d), y (..., M, d) -> (..., N, M)."""
        if self.kind == "rbf":
            xn = torch.sum(x * x, dim=-1, keepdim=True)  # (N, 1)
            yn = torch.sum(y * y, dim=-1, keepdim=True).mT  # (1, M)
            d2 = torch.clamp_min(xn + yn - 2.0 * (x @ y.mT), 0.0)
            return torch.exp(-d2 / (2.0 * self.lengthscale ** 2))
        if self.kind == "linear_norm":
            xs = x / torch.clamp_min(
                torch.linalg.norm(x, dim=-1, keepdim=True), NORM_EPS)
            ys = y / torch.clamp_min(
                torch.linalg.norm(y, dim=-1, keepdim=True), NORM_EPS)
            return 0.5 * (xs @ ys.mT + 1.0)
        raise ValueError(f"unknown kernel {self.kind}")


def rbf_lengthscale_batch(d: int) -> float:
    """Paper's batch-experiment lengthscale l = 1/(2 sqrt(d))."""
    return 1.0 / (2.0 * (d ** 0.5))


def rbf_lengthscale_stream(d: int) -> float:
    """Paper's streaming-experiment lengthscale l = 1/sqrt(d)."""
    return 1.0 / (d ** 0.5)


@dataclasses.dataclass(frozen=True)
class LogDetState:
    """Fixed-shape summary state for f(S) = 1/2 log det(I + a Sigma_S)."""

    feats: torch.Tensor  # (K, d) zero padded
    L: torch.Tensor  # (K, K) lower triangular, identity on padded rows
    Linv: torch.Tensor  # (K, K)
    n: torch.Tensor  # () int32 — number of live rows
    fval: torch.Tensor  # () float32 — current f(S)
    n_queries: torch.Tensor  # () int32 — oracle queries issued (metrics)

    @property
    def K(self) -> int:
        return self.feats.shape[-2]


@dataclasses.dataclass(frozen=True)
class LogDet:
    """The IVM objective bound to a kernel, a scale ``a`` and a device.

    ``backend`` selects the gain oracle (``auto`` | ``torch`` | ``cuda``,
    see ``core.oracle``); ``device=None`` means ``cuda`` and raises when
    there is no card.
    """

    K: int
    d: int
    kernel: KernelConfig = KernelConfig()
    a: float = 1.0
    dtype: torch.dtype = torch.float32
    backend: str | None = None
    device: torch.device | str | None = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def oracle(self):
        """The batched gain oracle every query below routes through."""
        from . import oracle

        return oracle.make(self.kernel, self.a, backend=self.backend,
                           dtype=self.dtype)

    @property
    def singleton_value(self) -> float:
        """m = f({e}) for normalized kernels — known analytically."""
        return 0.5 * math.log(1.0 + self.a)

    # -- state ---------------------------------------------------------------
    def init(self) -> LogDetState:
        K, dev = self.K, self.device
        z = torch.zeros((), dtype=torch.int32, device=dev)
        return LogDetState(
            feats=torch.zeros((K, self.d), dtype=self.dtype, device=dev),
            L=torch.eye(K, dtype=self.dtype, device=dev),
            Linv=torch.eye(K, dtype=self.dtype, device=dev),
            n=z,
            fval=torch.zeros((), dtype=self.dtype, device=dev),
            n_queries=z.clone(),
        )

    def _mask(self, state: LogDetState) -> torch.Tensor:
        kidx = torch.arange(self.K, device=state.n.device)
        return (kidx < state.n).to(self.dtype)

    # -- queries --------------------------------------------------------------
    def gains(self, state: LogDetState, X: torch.Tensor,
              kern: KernelParams | None = None) -> torch.Tensor:
        """Marginal gains Delta_f(x | S) for a batch X (B, d) -> (B,)."""
        return self.oracle.gains(state.feats, state.Linv, state.n, X,
                                 kern=kern)

    def gain1(self, state: LogDetState, x: torch.Tensor,
              kern: KernelParams | None = None) -> torch.Tensor:
        """Single-item marginal gain (d,) -> ()."""
        return self.oracle.gain1(state.feats, state.Linv, state.n, x,
                                 kern=kern)

    # -- update ---------------------------------------------------------------
    def append(self, state: LogDetState, x: torch.Tensor,
               kern: KernelParams | None = None) -> LogDetState:
        """Add x to the summary (caller guarantees state.n < K).

        With ``kern`` the whitening uses the multiply-reduce form the
        pod-step kernel replays; without it the static ``KernelConfig``
        matvec form of the baselines.
        """
        x = x.to(self.dtype)
        mask = self._mask(state)
        if kern is None:
            kx = self.kernel.pairwise(state.feats, x[None, :])[:, 0] * mask
            c = state.Linv @ (self.a * kx)  # (K,)
        else:
            kx = pairwise_traced(x[None, :], state.feats, kern)[0] * mask
            c = torch.sum(state.Linv * (self.a * kx)[None, :], dim=-1)
        dd2 = torch.clamp_min((1.0 + self.a) - torch.sum(c * c), GAIN_EPS)
        dd = torch.sqrt(dd2)
        gain = 0.5 * torch.log(dd2)

        n = state.n
        at_n = torch.arange(self.K, device=n.device) == n  # (K,)
        Lrow = torch.where(at_n, dd, c)  # L row n := [c, dd]
        r = -(c @ state.Linv) / dd  # Linv row n := [-(c Linv)/dd, 1/dd]
        Linv_row = torch.where(at_n, 1.0 / dd, r)
        rows = at_n[:, None]
        return LogDetState(
            feats=torch.where(rows, x[None, :], state.feats),
            L=torch.where(rows, Lrow[None, :], state.L),
            Linv=torch.where(rows, Linv_row[None, :], state.Linv),
            n=n + 1,
            fval=state.fval + gain,
            n_queries=state.n_queries,
        )

    def maybe_append(self, state: LogDetState, x: torch.Tensor,
                     take: torch.Tensor,
                     kern: KernelParams | None = None) -> LogDetState:
        """Conditionally append (a select, no host branch)."""
        appended = self.append(state, x, kern)
        return tree_map(lambda a, b: torch.where(take, a, b), appended, state)

    def maybe_append_stacked(self, states: LogDetState, x: torch.Tensor,
                             takes: torch.Tensor,
                             kern: KernelParams | None = None
                             ) -> LogDetState:
        """``maybe_append`` of one item into I stacked states (leading
        axis), instance i where ``takes[i]`` — the twin of
        ``jax.vmap(f.maybe_append)`` (``torch.func.vmap``, same ops)."""
        def one(feats, L, Linv, n, fval, n_queries, take):
            st = self.maybe_append(
                LogDetState(feats, L, Linv, n, fval, n_queries), x, take,
                kern)
            return st.feats, st.L, st.Linv, st.n, st.fval, st.n_queries

        leaves = (states.feats, states.L, states.Linv, states.n,
                  states.fval, states.n_queries)
        return LogDetState(*torch.func.vmap(one)(*leaves, takes))

    # -- batch (re)evaluation ---------------------------------------------------
    def refactor(self, feats: torch.Tensor, n: torch.Tensor) -> LogDetState:
        """Full O(K^3) factorization of an explicit summary buffer.

        feats (..., K, d), n (...) live rows, over any leading batch axes
        (Preemption factors its K swaps in one batched call).  Padded rows
        and columns are identity, so they add 0 to the log-determinant.
        Any buffer length works (QuickStream evaluates rings larger than
        K).  Library Cholesky and triangular solve, as the JAX package
        leaves them to XLA outside any kernel.
        """
        K = feats.shape[-2]
        n = n.to(torch.int32)
        live = torch.arange(K, device=feats.device) < n[..., None]  # (..., K)
        m2 = live[..., :, None] & live[..., None, :]
        eye = torch.eye(K, dtype=self.dtype, device=feats.device)
        Kmat = self.kernel.pairwise(feats, feats)
        M = torch.where(m2, eye + self.a * Kmat, eye)
        # LAPACK and cuSOLVER have no bf16 / fp16 Cholesky: such a state
        # is factored in float32 and stored in its own dtype
        work = (self.dtype if self.dtype in (torch.float32, torch.float64)
                else torch.float32)
        L = torch.linalg.cholesky(M.to(work)).contiguous()
        Linv = torch.linalg.solve_triangular(
            L, torch.eye(K, dtype=work, device=feats.device).expand_as(L),
            upper=False).contiguous()
        logd = torch.log(torch.diagonal(L, dim1=-2, dim2=-1))
        fval = torch.sum(torch.where(live, logd, 0.0), dim=-1)
        return LogDetState(
            feats=torch.where(live[..., None], feats, 0.0).to(self.dtype),
            L=L.to(self.dtype),
            Linv=Linv.to(self.dtype),
            n=n,
            fval=fval.to(self.dtype),
            n_queries=torch.zeros(n.shape, dtype=torch.int32,
                                  device=feats.device),
        )

    def evaluate(self, feats: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        """f(S) for an explicit summary buffer — the naive oracle."""
        return self.refactor(feats, n).fval


def naive_logdet(feats: torch.Tensor, kernel: KernelConfig,
                 a: float) -> torch.Tensor:
    """f(S) = 1/2 logdet(I + a K_SS) on live rows only (tests' float64
    reference when given float64 rows)."""
    Kmat = kernel.pairwise(feats, feats)
    M = torch.eye(feats.shape[0], dtype=Kmat.dtype,
                  device=feats.device) + a * Kmat
    _, ld = torch.linalg.slogdet(M)
    return 0.5 * ld
