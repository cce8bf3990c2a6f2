# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Streaming baselines the paper compares against (port of
``repro/core/baselines.py``):

  * Random                     — reservoir sampling
  * IndependentSetImprovement  — Chakrabarti & Kale 2014
  * PreemptionStreaming        — Buchbinder et al. 2019
  * QuickStream                — Kuhnle 2021 (ring of c*K rows)

Replacements invalidate the incremental Cholesky factors, so they
refactor from scratch (``LogDet.refactor``), as the JAX package does.
Each is a per-item loop (the JAX package aliases ``run_batched`` to
``run``); ``jax.lax.cond`` becomes a host branch on a device scalar, one
sync per item.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .functions import LogDet, LogDetState


def _set_row(buf: torch.Tensor, i: torch.Tensor, x: torch.Tensor):
    """``buf`` with row ``i`` (a device scalar) replaced by ``x`` — the
    ``buf.at[i].set(x)`` of the JAX package, without a host sync."""
    rows = torch.arange(buf.shape[0], device=buf.device) == i
    rows = rows.reshape(-1, *(1,) * (buf.dim() - 1))
    return torch.where(rows, x.to(buf.dtype), buf)


class _PerItem:
    """``run`` / ``run_batched`` as a loop over ``step``."""

    def run(self, state, X: torch.Tensor):
        for x in X:
            state = self.step(state, x)
        return state

    def run_batched(self, state, X: torch.Tensor):
        """Uniform-protocol alias — no batched fast path for this baseline."""
        return self.run(state, X)


# ---------------------------------------------------------------------------
# Random (reservoir sampling)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RandomState:
    feats: torch.Tensor  # (K, d)
    n: torch.Tensor  # () int32 live rows
    seen: torch.Tensor  # () int32 items observed
    gen: torch.Generator  # draws in place of the JAX key (advanced by step)


@dataclasses.dataclass(frozen=True)
class RandomReservoir(_PerItem):
    """Reservoir sampling.  The draws come from a ``torch.Generator`` on
    the objective's device; they cannot match the JAX key's stream, so
    the port is held to the JAX package on properties, not on values."""

    f: LogDet

    def init(self, seed: int = 0) -> RandomState:
        dev = self.f.device
        z = torch.zeros((), dtype=torch.int32, device=dev)
        return RandomState(
            feats=torch.zeros((self.f.K, self.f.d), dtype=self.f.dtype,
                              device=dev),
            n=z, seen=z.clone(),
            gen=torch.Generator(device=dev).manual_seed(seed))

    def step(self, state: RandomState, x: torch.Tensor) -> RandomState:
        K = self.f.K
        u = torch.rand((), generator=state.gen, dtype=torch.float64,
                       device=state.gen.device)
        j = torch.floor(u * (state.seen + 1)).to(torch.int32)  # [0, seen]
        fill = state.n < K
        slot = torch.where(fill, state.n, j)
        take = fill | (j < K)
        feats = torch.where(take, _set_row(state.feats, slot, x), state.feats)
        return RandomState(feats=feats,
                           n=torch.clamp_max(state.n + fill.to(torch.int32),
                                             K),
                           seen=state.seen + 1, gen=state.gen)

    def summary(self, state: RandomState):
        return state.feats, state.n, self.f.evaluate(state.feats, state.n)

    def memory_elements(self, state) -> int:
        return self.f.K


# ---------------------------------------------------------------------------
# IndependentSetImprovement
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ISIState:
    ld: LogDetState
    w: torch.Tensor  # (K,) insertion-time marginal gains, never updated


@dataclasses.dataclass(frozen=True)
class IndependentSetImprovement(_PerItem):
    f: LogDet

    def init(self) -> ISIState:
        return ISIState(ld=self.f.init(),
                        w=torch.full((self.f.K,), torch.inf,
                                     dtype=self.f.dtype,
                                     device=self.f.device))

    def step(self, state: ISIState, x: torch.Tensor) -> ISIState:
        f, ld = self.f, state.ld
        g = f.gain1(ld, x)  # static kernel: gain_static at B = 1
        if bool(ld.n < f.K):
            out = ISIState(ld=f.append(ld, x), w=_set_row(state.w, ld.n, g))
        else:
            am = torch.argmin(state.w)
            if bool(g > 2.0 * state.w[am]):
                ld2 = f.refactor(_set_row(ld.feats, am, x), ld.n)
                out = ISIState(
                    ld=dataclasses.replace(ld2, n_queries=ld.n_queries),
                    w=_set_row(state.w, am, g))
            else:
                out = state
        return ISIState(ld=dataclasses.replace(
            out.ld, n_queries=ld.n_queries + 1), w=out.w)

    def summary(self, state: ISIState):
        return state.ld.feats, state.ld.n, state.ld.fval

    def memory_elements(self, state) -> int:
        return self.f.K


# ---------------------------------------------------------------------------
# PreemptionStreaming (swap if it improves f by >= f(S)/K)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PreemptionStreaming(_PerItem):
    f: LogDet

    def init(self) -> LogDetState:
        return self.f.init()

    def step(self, ld: LogDetState, x: torch.Tensor) -> LogDetState:
        f, K = self.f, self.f.K
        if bool(ld.n < K):
            out = f.append(ld, x)
        else:
            # the K swaps (row v := x), factored in one batched Cholesky
            swap = torch.eye(K, dtype=torch.bool, device=ld.feats.device)
            feats = torch.where(swap[:, :, None], x.to(f.dtype),
                                ld.feats[None])
            vals = f.evaluate(feats, ld.n.expand(K))
            u = torch.argmax(vals)
            if bool(vals[u] - ld.fval >= ld.fval / K):
                out = dataclasses.replace(f.refactor(feats[u], ld.n),
                                          n_queries=ld.n_queries)
            else:
                out = ld
        return dataclasses.replace(out, n_queries=ld.n_queries + K)

    def summary(self, ld: LogDetState):
        return ld.feats, ld.n, ld.fval

    def memory_elements(self, state) -> int:
        return self.f.K


# ---------------------------------------------------------------------------
# QuickStream (buffered bulk-accept; fixed-shape ring buffer)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QSState:
    buf: torch.Tensor  # (c, d) pending chunk
    nbuf: torch.Tensor  # () int32
    A: torch.Tensor  # (cap, d) accepted ring
    nA: torch.Tensor  # () int32 total ever accepted (ring position nA % cap)
    fA: torch.Tensor  # () float32 f(A) of the live window
    n_queries: torch.Tensor  # () int32


@dataclasses.dataclass(frozen=True)
class QuickStream:
    """Kuhnle 2021, with the unbounded buffer replaced by a ring of
    ``cap = c * K`` rows (the final trim size), as in the JAX package."""

    f: LogDet
    c: int = 4

    @property
    def cap(self) -> int:
        return self.c * self.f.K

    def init(self) -> QSState:
        dev, dt = self.f.device, self.f.dtype
        z = torch.zeros((), dtype=torch.int32, device=dev)
        return QSState(
            buf=torch.zeros((self.c, self.f.d), dtype=dt, device=dev),
            nbuf=z, A=torch.zeros((self.cap, self.f.d), dtype=dt,
                                  device=dev),
            nA=z.clone(), fA=torch.zeros((), dtype=torch.float32, device=dev),
            n_queries=z.clone())

    def step(self, state: QSState, x: torch.Tensor) -> QSState:
        buf = _set_row(state.buf, state.nbuf, x)
        nbuf = state.nbuf + 1
        if not bool(nbuf >= self.c):
            return dataclasses.replace(state, buf=buf, nbuf=nbuf)
        # flush: the c buffered items join the ring if f grows enough
        idx = (state.nA + torch.arange(self.c, device=buf.device)) % self.cap
        A2 = state.A.index_copy(0, idx.long(), buf)
        n2 = torch.clamp_max(state.nA + self.c, self.cap)
        f2 = self.f.evaluate(A2, n2)
        zero = torch.zeros_like(state.nbuf)
        if bool(f2 - state.fA >= state.fA / self.f.K):
            return QSState(buf=torch.zeros_like(buf), nbuf=zero, A=A2,
                           nA=state.nA + self.c, fA=f2.to(torch.float32),
                           n_queries=state.n_queries + 1)
        return dataclasses.replace(state, buf=torch.zeros_like(buf),
                                   nbuf=zero,
                                   n_queries=state.n_queries + 1)

    def run(self, state: QSState, X: torch.Tensor, n_valid=None) -> QSState:
        """Per-item loop over the prefix ``X[:n_valid]``."""
        nv = X.shape[0] if n_valid is None else min(max(int(n_valid), 0),
                                                    X.shape[0])
        for x in X[:nv]:
            state = self.step(state, x)
        return state

    def run_batched(self, state: QSState, X: torch.Tensor,
                    n_valid=None) -> QSState:
        """Uniform-protocol alias — no batched fast path for this baseline."""
        return self.run(state, X, n_valid)

    def insertions(self, state: QSState) -> torch.Tensor:
        """Total ring insertions ever (monotone)."""
        return state.nA

    def summary(self, state: QSState) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
        """The best of the c groups of K ring rows (a deterministic
        partition), evaluated in one batched call."""
        K = self.f.K
        n_live = torch.clamp_max(state.nA, self.cap)
        groups = state.A.reshape(self.c, K, self.f.d)
        ns = torch.clamp(n_live - K * torch.arange(
            self.c, device=n_live.device), 0, K).to(torch.int32)
        vals = self.f.evaluate(groups, ns)
        g = torch.argmax(vals)
        return groups[g], ns[g], vals[g]

    def memory_elements(self, state) -> int:
        return self.cap + self.c
