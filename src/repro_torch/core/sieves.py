# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""SieveStreaming (Badanidiyuru et al. 2014) and SieveStreaming++
(Kazemi et al. 2019), port of ``repro/core/sieves.py``.

One summary per rung of the threshold ladder, stored as stacked
``LogDetState`` tensors with a leading (rung_cap,) axis; the per-item
update appends into every accepting rung at once
(``LogDet.maybe_append_stacked``) and the batched path prices every rung
in one stacked gain launch (``StackedSieve``).

SieveStreaming++ also tracks LB = max_v f(S_v) and deactivates rungs
whose OPT guess v fell to LB or below.  The buffers keep their shape, so
the paper's memory metric (peak live stored elements) comes from the
activity mask.  (K, eps) are state (``SieveState.hp``): a smaller ladder
occupies a prefix of the rung axis and its tail starts dead.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .functions import LogDet, LogDetState
from .sieve_family import StackedSieve, residual_threshold, stack_states
from .spec import HyperParams
from .thresholds import TracedLadder


@dataclasses.dataclass(frozen=True)
class SieveState:
    lds: LogDetState  # stacked over instances: leading axis (n_inst,)
    alive: torch.Tensor  # (n_inst,) bool — ladder validity, SS++ deactivation
    lb: torch.Tensor  # () f.dtype — best f seen (SS++ only)
    n_queries: torch.Tensor  # () int32
    peak_mem: torch.Tensor  # () int32 — max live stored elements
    hp: HyperParams


def new_state(f: LogDet, n_inst: int, alive: torch.Tensor,
              hp: HyperParams) -> SieveState:
    """Empty stacked summaries with the given liveness mask."""
    z = torch.zeros((), dtype=torch.int32, device=f.device)
    return SieveState(lds=stack_states(f.init(), n_inst), alive=alive,
                      lb=torch.zeros((), dtype=f.dtype, device=f.device),
                      n_queries=z, peak_mem=z.clone(), hp=hp)


@dataclasses.dataclass(frozen=True)
class SieveStreaming(StackedSieve):
    """Classic SieveStreaming: every (valid) rung is always live."""

    plus_plus: bool = False  # SieveStreaming++ behaviour

    @property
    def n_instances(self) -> int:
        return self.rung_cap

    def init(self, hyper: HyperParams | None = None) -> SieveState:
        hp = self.default_hyper() if hyper is None else hyper
        return new_state(self.f, self.rung_cap,
                         TracedLadder.of(hp).valid(self.rung_cap), hp)

    def _values(self, state: SieveState) -> torch.Tensor:
        """(rung_cap,) OPT guesses in the objective's dtype."""
        return TracedLadder.of(state.hp).values(self.rung_cap, self.f.dtype)

    def _thresholds(self, state: SieveState) -> torch.Tensor:
        return residual_threshold(self._values(state) / 2.0, state.lds.fval,
                                  state.lds.n, state.hp.k_cap)

    def _can_accept(self, state: SieveState) -> torch.Tensor:
        return state.alive & (state.lds.n < state.hp.k_cap)

    def _apply_item(self, state: SieveState, x: torch.Tensor,
                    takes: torch.Tensor) -> SieveState:
        lds = self.f.maybe_append_stacked(state.lds, x, takes,
                                          state.hp.kern)
        if self.plus_plus:
            lb = torch.maximum(state.lb, torch.max(lds.fval))
            # an OPT guess v at or below LB = max_v f(S_v) cannot lie in
            # [(1 - eps) OPT, OPT] any more: the sieve is dropped
            alive = state.alive & (self._values(state) > lb)
        else:
            lb, alive = state.lb, state.alive
        nq = state.n_queries + alive.sum(dtype=torch.int32)
        peak = torch.maximum(state.peak_mem, torch.where(
            alive, lds.n, 0).sum(dtype=torch.int32))
        return SieveState(lds=lds, alive=alive, lb=lb, n_queries=nq,
                          peak_mem=peak, hp=state.hp)

    def _bulk_reject(self, state: SieveState, r: int) -> SieveState:
        """r consecutive all-reject items: only the query counter moves."""
        nq = state.n_queries + r * state.alive.sum(dtype=torch.int32)
        peak = torch.maximum(state.peak_mem, torch.where(
            state.alive, state.lds.n, 0).sum(dtype=torch.int32))
        return dataclasses.replace(state, n_queries=nq, peak_mem=peak)

    def best(self, state: SieveState) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
        """(feats, n, fval) of the winning sieve."""
        i = torch.argmax(torch.where(state.alive, state.lds.fval, -torch.inf))
        return state.lds.feats[i], state.lds.n[i], state.lds.fval[i]

    def summary(self, state: SieveState):
        return self.best(state)

    def memory_elements(self, state: SieveState) -> torch.Tensor:
        """Peak live stored elements (the paper plots maximum memory; SS++
        can end a run with only empty high-threshold sieves alive)."""
        return state.peak_mem


def sieve_streaming_pp(f: LogDet, eps: float = 0.1) -> SieveStreaming:
    return SieveStreaming(f=f, eps=eps, plus_plus=True)
