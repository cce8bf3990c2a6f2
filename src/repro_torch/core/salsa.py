# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Salsa (Norouzi-Fard et al. 2018), streaming variant (port of
``repro/core/salsa.py``).

Three length-free thresholding rules run in parallel, each over the full
ladder; the best summary wins:

  rule 0 ("sieve")   thr = (v/2 - f(S)) / (K - |S|)
  rule 1 ("dense")   thr = v / (2K)
  rule 2 ("eager")   thr = (2v/3 - f(S)) / (K - |S|)

The rule/rung instances are one stacked axis of NUM_RULES * rung_cap
summaries (``StackedSieve``), priced by one stacked gain launch per pass.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .sieve_family import StackedSieve, residual_threshold
from .sieves import SieveState, new_state
from .spec import HyperParams
from .thresholds import TracedLadder

NUM_RULES = 3


@dataclasses.dataclass(frozen=True)
class Salsa(StackedSieve):
    @property
    def n_instances(self) -> int:
        return NUM_RULES * self.rung_cap

    def init(self, hyper: HyperParams | None = None) -> SieveState:
        hp = self.default_hyper() if hyper is None else hyper
        valid = TracedLadder.of(hp).valid(self.rung_cap).repeat(NUM_RULES)
        return new_state(self.f, self.n_instances, valid, hp)

    def _thresholds(self, state: SieveState) -> torch.Tensor:
        """(n_inst,) accept bars given per-instance f and |S|."""
        fvals, ns, k_cap = state.lds.fval, state.lds.n, state.hp.k_cap
        nv = self.rung_cap
        vs = TracedLadder.of(state.hp).values(nv, self.f.dtype).repeat(
            NUM_RULES)
        rule = torch.arange(NUM_RULES, device=vs.device).repeat_interleave(nv)
        thr0 = residual_threshold(vs / 2.0, fvals, ns, k_cap)
        thr1 = (vs / (2.0 * k_cap.to(vs.dtype))).expand_as(fvals)
        thr2 = residual_threshold(2.0 * vs / 3.0, fvals, ns, k_cap)
        return torch.where(rule == 0, thr0, torch.where(rule == 1, thr1,
                                                        thr2))

    def _can_accept(self, state: SieveState) -> torch.Tensor:
        return state.alive & (state.lds.n < state.hp.k_cap)

    def _apply_item(self, state: SieveState, x: torch.Tensor,
                    takes: torch.Tensor) -> SieveState:
        lds = self.f.maybe_append_stacked(state.lds, x, takes,
                                          state.hp.kern)
        nq = state.n_queries + state.alive.sum(dtype=torch.int32)
        peak = torch.maximum(state.peak_mem, lds.n.sum(dtype=torch.int32))
        return SieveState(lds=lds, alive=state.alive, lb=state.lb,
                          n_queries=nq, peak_mem=peak, hp=state.hp)

    def _bulk_reject(self, state: SieveState, r: int) -> SieveState:
        nq = state.n_queries + r * state.alive.sum(dtype=torch.int32)
        peak = torch.maximum(state.peak_mem,
                             state.lds.n.sum(dtype=torch.int32))
        return dataclasses.replace(state, n_queries=nq, peak_mem=peak)

    def summary(self, state: SieveState) -> Tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
        i = torch.argmax(state.lds.fval)
        return state.lds.feats[i], state.lds.n[i], state.lds.fval[i]

    def memory_elements(self, state: SieveState) -> torch.Tensor:
        return state.lds.n.sum(dtype=torch.int32)
