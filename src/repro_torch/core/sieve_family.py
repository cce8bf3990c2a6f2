# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Shared machinery of the sieve family (port of
``repro/core/sieve_family.py``): the residual accept threshold, stacking
and row selection of state dataclasses, the ``SieveAlgorithm`` base
(ladder, hyperparameters, the per-item ``run`` over ``step``) and
``StackedSieve``, the engine of the algorithms that keep one summary per
stacked instance (SieveStreaming, SieveStreaming++, Salsa), with
``run_slots``, its ``run_batched`` over a pod's slot axis.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.tree import copy_into, tree_map, vmap

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
        self._check_hyper_capacity(K=K, eps=eps)
        return HyperParams.build(K=K, T=T, eps=eps,
                                 m=self.f.singleton_value,
                                 lengthscale=lengthscale,
                                 kernel_kind=kernel_kind,
                                 device=self.f.device)

    def _check_hyper_capacity(self, *, K: int, eps: float) -> None:
        """Hook: shape-capacity checks beyond K_max (stacked sieves add
        the rung-axis bound)."""

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
        """Total summary insertions so far — monotone over the stream;
        per slot of a stacked (S, ...) pod state, (S,).  Every hosted
        algorithm reduces over its own axes only, so the pod calls this
        on its stacked state directly (``vmap`` would cost each ingest a
        host pause of about half a millisecond)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class StackedSieve(SieveAlgorithm):
    """Sieve algorithms that keep one summary per stacked instance.

    Subclasses provide the per-item decision pieces; ``step`` and
    ``run_batched`` are derived from them, so the two cannot drift apart:

      * ``_thresholds(state) -> (n_inst,)``   accept bars (pre-item state)
      * ``_can_accept(state) -> (n_inst,)``   eligibility mask
      * ``_apply_item(state, x, takes)``      appends + bookkeeping for one
                                              item with known accept mask
      * ``_bulk_reject(state, r)``            bookkeeping for r consecutive
                                              all-reject items, closed form

    The instance axis is sized by the default (eps, K) ladder; a smaller
    per-session ladder (``init(hyper)``) occupies a prefix of it and the
    rest never accepts (``TracedLadder.valid``).
    """

    @property
    def n_instances(self) -> int:
        raise NotImplementedError

    @property
    def rung_cap(self) -> int:
        """Rung capacity of the stacked axis (per rule)."""
        return self.ladder.num_rungs

    def _check_hyper_capacity(self, *, K: int, eps: float) -> None:
        need = Ladder(eps=eps, m=self.f.singleton_value, K=K).num_rungs
        if need > self.rung_cap:
            raise ValueError(
                f"(K={K}, eps={eps}) needs {need} threshold rungs; this "
                f"algorithm stacks {self.rung_cap} — construct it with "
                "eps <= the smallest tenant eps and K >= the largest "
                "tenant budget")

    def _thresholds(self, state) -> torch.Tensor:
        raise NotImplementedError

    def _can_accept(self, state) -> torch.Tensor:
        raise NotImplementedError

    def _apply_item(self, state, x: torch.Tensor, takes: torch.Tensor):
        raise NotImplementedError

    def _bulk_reject(self, state, r: int):
        raise NotImplementedError

    def _gains_all(self, state, X: torch.Tensor) -> torch.Tensor:
        """Gains of X against every instance -> (n_inst, B): ONE oracle
        call over the stacked summaries (one ``gain_traced`` launch on the
        card), all with the session's kernel ``state.hp.kern``."""
        lds = state.lds
        return self.f.oracle.gains(lds.feats, lds.Linv, lds.n, X,
                                   kern=state.hp.kern)

    def insertions(self, state) -> torch.Tensor:
        """Insertions across all stacked instances (monotone); per slot
        of a pod state (the sum runs over the instance axis only)."""
        return state.lds.n.sum(dim=-1, dtype=torch.int32)

    def step(self, state, x: torch.Tensor):
        """Process one stream item across all instances."""
        g = self._gains_all(state, x[None, :])[:, 0]
        takes = (g >= self._thresholds(state)) & self._can_accept(state)
        return self._apply_item(state, x, takes)

    def run_batched(self, state, X: torch.Tensor, n_valid=None, *,
                    margins: Optional[Dict[int, float]] = None):
        """Same result as ``run``, with one gain pass per state change.

        Between accepts no instance's (f(S), |S|, liveness) changes, so
        one stacked pass prices the rest of the chunk for every instance
        and the earliest accepting item is found with one host sync.  At
        that item every instance decides with its pre-item state, the
        rejected prefix is folded into ``_bulk_reject``, and gains are
        recomputed only after the accept.  ``n_valid`` restricts the run
        to ``X[:n_valid]``.  ``margins``, when given a dict, receives for
        every item this call decides the smallest relative margin
        ``|gain - thr| / max(1, |thr|)`` over the eligible instances
        (keyed by row of ``X``): the near-tie test of comparisons with
        other implementations.
        """
        B = X.shape[0]
        nv = B if n_valid is None else min(max(int(n_valid), 0), B)
        idx = torch.arange(B, device=X.device)
        cursor = 0
        while cursor < nv:
            gains = self._gains_all(state, X)  # (n_inst, B)
            thr = self._thresholds(state)
            can = self._can_accept(state)
            acc = (gains >= thr[:, None]) & can[:, None]
            acc_item = acc.any(dim=0) & (idx >= cursor) & (idx < nv)
            hits = torch.nonzero(acc_item)
            p = int(hits[0, 0]) if hits.numel() else nv
            if margins is not None:
                end = min(p + 1, nv)
                rel = ((gains[:, cursor:end] - thr[:, None]).abs()
                       / torch.clamp_min(thr.abs(), 1.0)[:, None])
                rel = torch.where(can[:, None], rel, torch.inf).amin(dim=0)
                margins.update((i, m) for i, m in
                               zip(range(cursor, end), rel.tolist())
                               if m != float("inf"))
            if p == nv:
                state = self._bulk_reject(state, nv - cursor)
                break
            state = self._bulk_reject(state, p - cursor)
            state = self._apply_item(state, X[p], acc[:, p])
            cursor = p + 1
        return state

    # ------------------------------------------------------------ pod slots
    def _gains_slots(self, state, X: torch.Tensor) -> torch.Tensor:
        """Gains of each slot's chunk X (S, C, d) against that slot's
        instances -> (S, n_inst, C): ONE grouped oracle call over the
        S x n_inst summaries (one ``gain_traced`` launch on the card),
        each slot with its own kernel ``state.hp.kern``."""
        lds = state.lds
        S, I = lds.n.shape
        return self.f.oracle.gains(
            lds.feats.flatten(0, 1), lds.Linv.flatten(0, 1),
            lds.n.flatten(), X, kern=state.hp.kern).reshape(S, I, -1)

    def run_slots(self, state, X: torch.Tensor, counts: torch.Tensor):
        """``run_batched`` of every slot of a stacked (S, ...) state at
        once, IN PLACE (the JAX pod's ``vmap(run_batched)``); returns
        ``state``.

        X (S, C, d) holds each slot's chunk, ``counts`` (S,) its valid
        prefix.  A round prices the chunks of the unfinished slots
        against all their instances in one grouped gain call; each slot
        then folds its rejected prefix into ``_bulk_reject`` and applies
        its first accepting item at or past its cursor, all slots at once
        (the decision pieces mapped over the slot axis with ``vmap``).
        One host sync per round reads which slots go on, so the rounds
        are the most accept events of any one slot.  A slot whose cursor
        reached its count is neither priced nor changed again.
        """
        S, C = X.shape[:2]
        dev = X.device
        thresholds = vmap(self._thresholds)
        can_accept = vmap(self._can_accept)
        bulk_reject = vmap(self._bulk_reject)
        apply_item = vmap(self._apply_item)
        with obs.hot_span("sieve.sync"):  # the cursors, the first read
            nv = torch.clamp(counts.to(torch.int32), 0, C)
            cursor = torch.zeros_like(nv)
            pos = torch.arange(C, device=dev)
            act = torch.nonzero(nv > 0).flatten()
        while act.numel():
            with obs.hot_span("sieve.round"):
                whole = act.numel() == S
                with obs.hot_span("sieve.gain"):
                    sub = state if whole else tree_map(
                        lambda l: l.index_select(0, act), state)
                    xs = X if whole else X.index_select(0, act)
                    gains = self._gains_slots(sub, xs)  # (A, n_inst, C)
                with obs.hot_span("sieve.decide"):
                    acc = ((gains >= thresholds(sub)[..., None])
                           & can_accept(sub)[..., None])
                    cur, end = cursor[act], nv[act]
                    acc_item = (acc.any(dim=1) & (pos >= cur[:, None])
                                & (pos < end[:, None]))
                    hit = acc_item.any(dim=1)
                    p = torch.where(hit,
                                    acc_item.to(torch.uint8).argmax(dim=1),
                                    end).to(torch.int32)
                    sub = bulk_reject(sub, p - cur)
                    pc = torch.clamp_max(p, C - 1).long()
                    takes = acc.gather(2, pc[:, None, None].expand(
                        -1, acc.shape[1], 1))[..., 0]
                    rows = torch.arange(act.numel(), device=dev)
                    sub = tree_select(
                        hit, apply_item(sub, xs[rows, pc], takes), sub)
                    copy_into(state, sub, None if whole else act)
                    cursor[act] = torch.where(hit, p + 1, end)
                with obs.hot_span("sieve.sync"):
                    act = act[hit & (p + 1 < end)]
        return state

