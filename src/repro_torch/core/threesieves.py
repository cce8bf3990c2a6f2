# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""ThreeSieves, the paper's algorithm (port of ``repro/core/threesieves.py``).

Two execution paths with the same semantics:

  * ``run``          — per-item loop over ``step`` (Algorithm 1),
  * ``run_batched``  — one gain pass per state change plus closed-form
                       rung descent: r rejections from counter t lower
                       the rung by (t + r) // T and leave (t + r) % T.

The JAX ``lax.while_loop`` / ``lax.cond`` of ``run_batched`` is a Python
loop here; the pod steps many sessions at once through the CUDA
pod-step kernel instead (``kernels.pod_step``).  (K, T, eps) and the
kernel hyperparameters are state (``TSState.hp``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from .functions import LogDetState
from .sieve_family import SieveAlgorithm, residual_threshold
from .spec import HyperParams
from .thresholds import TracedLadder


@dataclasses.dataclass(frozen=True)
class TSState:
    ld: LogDetState
    j: torch.Tensor  # () int32 — current rung of the threshold ladder
    t: torch.Tensor  # () int32 — consecutive rejections at the current rung
    n_fused: torch.Tensor  # () int32 — fused gain passes (metrics)
    hp: HyperParams


@dataclasses.dataclass(frozen=True)
class ThreeSieves(SieveAlgorithm):
    """ThreeSieves(K, T, eps) over the LogDet objective.

    ``T``/``eps`` are the defaults stamped into ``init()``'s
    hyperparameters; a run reads ``state.hp``.
    """

    eps: float = dataclasses.field(default=1e-3, kw_only=True)
    T: int = dataclasses.field(default=500, kw_only=True)

    @staticmethod
    def T_from_alpha_tau(alpha: float, tau: float) -> int:
        """Eq. (3): T = -ln(alpha)/tau  (the Rule-of-Three inverted)."""
        return int(math.ceil(-math.log(alpha) / tau))

    # ------------------------------------------------------------------ state
    def init(self, hyper: HyperParams | None = None) -> TSState:
        z = torch.zeros((), dtype=torch.int32, device=self.f.device)
        hp = self.default_hyper() if hyper is None else hyper
        return TSState(ld=self.f.init(), j=z, t=z.clone(), n_fused=z.clone(),
                       hp=hp)

    def _threshold(self, ld: LogDetState, j, hp: HyperParams):
        v = TracedLadder.of(hp).value(j, self.f.dtype)
        return residual_threshold(v / 2.0, ld.fval, ld.n, hp.k_cap)

    # ------------------------------------------------------------- Algorithm 1
    def step(self, state: TSState, x: torch.Tensor) -> TSState:
        """Process one stream item (lines 4-12 of Algorithm 1)."""
        f, hp, ld = self.f, state.hp, state.ld
        gain = f.gain1(ld, x, hp.kern)
        thr = self._threshold(ld, state.j, hp)
        accept = (gain >= thr) & (ld.n < hp.k_cap)
        ld2 = f.maybe_append(ld, x, accept, hp.kern)
        t_rej = state.t + 1
        lower = t_rej >= hp.T
        j_rej = torch.where(
            lower, torch.minimum(state.j + 1, hp.num_rungs - 1), state.j)
        t_rej = torch.where(lower, torch.zeros_like(t_rej), t_rej)
        j = torch.where(accept, state.j, j_rej)
        t = torch.where(accept, torch.zeros_like(t_rej), t_rej)
        ld2 = dataclasses.replace(ld2, n_queries=ld.n_queries + 1)
        return TSState(ld=ld2, j=j, t=t, n_fused=state.n_fused, hp=hp)

    # ------------------------------------------------------------- fast path
    def run_batched(self, state: TSState, X: torch.Tensor, n_valid=None, *,
                    margins: Optional[Dict[int, float]] = None) -> TSState:
        """Same result as ``run``, with one gain pass per state change.

        ``n_valid`` restricts processing to the prefix ``X[:n_valid]``.
        ``margins``, when given a dict, receives for every item this call
        decides its relative decision margin
        ``|gain - thr| / max(1, |thr|)`` (keyed by row of ``X``): the
        near-tie test that comparisons with other implementations use.
        """
        f, B = self.f, X.shape[0]
        hp = state.hp
        T, nr, k_cap = int(hp.T), int(hp.num_rungs), int(hp.k_cap)
        lad = TracedLadder.of(hp)
        dev = X.device
        r_idx = torch.arange(B, dtype=torch.int32, device=dev)
        nv = B if n_valid is None else min(max(int(n_valid), 0), B)
        ld, j, t = state.ld, int(state.j), int(state.t)
        n_fused = int(state.n_fused)

        def consume_all(j, t, steps):
            return min(j + (t + steps) // T, nr - 1), (t + steps) % T

        cursor = 0
        while cursor < nv:
            n_fused += 1  # one pass per state change, full summary included
            if int(ld.n) >= k_cap:  # the pass would price nothing
                j, t = consume_all(j, t, nv - cursor)
                break
            gains = f.gains(ld, X, hp.kern)
            r = r_idx - cursor
            j_p = torch.clamp_max(j + torch.div(t + r, T, rounding_mode="floor"),
                                  nr - 1)
            v_p = lad.value(j_p, f.dtype)
            thr_p = residual_threshold(v_p / 2.0, ld.fval, ld.n, hp.k_cap)
            acc = (gains >= thr_p) & (r_idx >= cursor) & (r_idx < nv)
            hits = torch.nonzero(acc)
            istar = int(hits[0, 0]) if hits.numel() else nv
            if margins is not None:
                end = min(istar + 1, nv)
                rel = ((gains[cursor:end] - thr_p[cursor:end]).abs()
                       / torch.clamp_min(thr_p[cursor:end].abs(), 1.0))
                margins.update(zip(range(cursor, end), rel.tolist()))
            if istar == nv:
                j, t = consume_all(j, t, nv - cursor)
                break
            j = min(j + (t + istar - cursor) // T, nr - 1)
            t = 0
            ld = f.append(ld, X[istar], hp.kern)
            cursor = istar + 1

        i32 = dict(dtype=torch.int32, device=state.j.device)
        ld = dataclasses.replace(ld, n_queries=ld.n_queries + nv)
        return TSState(ld=ld, j=torch.tensor(j, **i32),
                       t=torch.tensor(t, **i32),
                       n_fused=torch.tensor(n_fused, **i32), hp=hp)

    # ---------------------------------------------------------------- metrics
    def summary(self, state: TSState) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
        return state.ld.feats, state.ld.n, state.ld.fval

    def insertions(self, state: TSState) -> torch.Tensor:
        return state.ld.n

    def memory_elements(self, state: TSState) -> torch.Tensor:
        return state.hp.k_cap
