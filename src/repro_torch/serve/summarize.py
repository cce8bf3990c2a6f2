# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""SummarizerPod: many summarization sessions as one stacked state
(port of ``repro/serve/summarize.py``).

S sessions share one stacked state (every tensor has a leading (S,) slot
axis) plus per-slot metadata.  ``ingest`` routes a tagged batch
``(session_id, x)`` into per-session chunk buffers with one scatter and
advances every session with ONE pod step (``kernels.pod_step``): for
ThreeSieves the CUDA ``pod_step`` kernel on the card, for SieveStreaming,
SieveStreaming++ and Salsa the batched ``StackedSieve.run_slots`` (one
grouped ``gain_traced`` launch per round), for QuickStream a per-slot
loop; on the CPU the plain versions.  Admit, evict and drift reset reuse
slots through masked row selects.  ``insertions``, ``summary`` and a
drift reset's fresh rows are taken per slot, as the JAX pod vmaps them
(``summary`` and ``init`` through ``tree.vmap``).

Per-session hyperparameters (K, T, eps, lengthscale, kernel kind) of the
sieve family are state rows stamped at ``admit(..., spec=SessionSpec(
...))``; QuickStream has none.

The pod step updates the algorithm state IN PLACE (the stand-in for
JAX's donation): tensors returned by ``readout`` may be views of the
live state, so clone them to keep a snapshot across an ingest.  The
lifecycle methods (admit, evict, reset) return fresh state.

``serve`` drives the pod from an ``ingest.IngestPipeline`` (the
double-buffered front end) with drift checks between pipeline runs.
``save``/``restore`` checkpoint the whole pod through a
``ckpt.CheckpointStore`` or ``MemoryStore`` and restore it, or a subset
of its session rows into another live pod (the handoff of
``serve.autoscale``).  ``make_sharded_update`` maps ``ingest`` over the
ranks of a device mesh: P pods of S sessions, one a rank, as one pod of
P*S.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.sieve_family import (SieveAlgorithm, stack_states,
                                           tree_select)
from repro_torch.core.spec import HyperParams, SessionSpec
from repro_torch.device import resolve_device
from repro_torch.kernels.pod_step import pod_step
from repro_torch.tree import (copy_into, leaves_with_keys, shard_map,
                              tree_map, vmap)


class PodReadout(NamedTuple):
    """Per-session readout of a pod."""

    feats: torch.Tensor  # (S, K, d)
    n: torch.Tensor  # (S,)
    fval: torch.Tensor  # (S,)
    active: torch.Tensor  # (S,) bool
    drops: Dict[str, torch.Tensor]
    specs: Optional[HyperParams]


@dataclasses.dataclass(frozen=True)
class PodState:
    """Stacked state of S summarizer sessions; every tensor is (S, ...)."""

    algo: Any  # stacked algorithm state (leading session axis)
    sid: torch.Tensor  # (S,) int32 — session id in the slot, -1 when free
    active: torch.Tensor  # (S,) bool — slot hosts a live session
    items: torch.Tensor  # (S,) int32 — items routed since admission
    accepts: torch.Tensor  # (S,) int32 — summary insertions since admission
    win_items: torch.Tensor  # (S,) int32 — items since the last check/reset
    win_accepts: torch.Tensor  # (S,) int32 — accepts since then
    resets: torch.Tensor  # (S,) int32 — drift resets of the slot
    drops_overflow: torch.Tensor  # (S,) int32 — items past the slot's C
    drops_unknown: torch.Tensor  # (S,) int32 — unknown-sid drops, on slot 0

    @property
    def S(self) -> int:
        return self.sid.shape[0]


@dataclasses.dataclass(frozen=True)
class SummarizerPod:
    """S summarizer sessions as one stacked state.

    ``chunk`` is the per-session capacity of one ingest (the tail is
    counted as dropped).  ``device=None`` means ``cuda`` and must be the
    device of ``algo``'s objective; the pod step runs the CUDA kernels
    there and the plain versions on the CPU (``kernels.pod_step``).
    """

    algo: Any  # ThreeSieves, SieveStreaming(++), Salsa or QuickStream
    sessions: int
    chunk: int
    device: torch.device | str | None = None

    def __post_init__(self):
        dev = resolve_device(self.device)
        if dev != self.algo.f.device:
            raise ValueError(f"pod device {dev} != the objective's device "
                             f"{self.algo.f.device}")
        object.__setattr__(self, "device", dev)

    # ------------------------------------------------------------------ state
    def _zeros(self) -> torch.Tensor:
        return torch.zeros((self.sessions,), dtype=torch.int32,
                           device=self.device)

    def init(self) -> PodState:
        S = self.sessions
        return PodState(
            algo=stack_states(self.algo.init(), S),
            sid=torch.full((S,), -1, dtype=torch.int32, device=self.device),
            active=torch.zeros((S,), dtype=torch.bool, device=self.device),
            items=self._zeros(), accepts=self._zeros(),
            win_items=self._zeros(), win_accepts=self._zeros(),
            resets=self._zeros(), drops_overflow=self._zeros(),
            drops_unknown=self._zeros(),
        )

    def abstract_state(self) -> PodState:
        """The pod's state on the ``meta`` device: shapes and dtypes, no
        storage — the ``like`` donor of ``restore``.  Taken from one
        session's state on the host (a meta ``torch.eye`` would cost its
        first caller a second of PyTorch's meta-kernel import)."""
        cpu = torch.device("cpu")
        one = dataclasses.replace(
            self, algo=dataclasses.replace(
                self.algo, f=dataclasses.replace(self.algo.f, device=cpu)),
            sessions=1, device=cpu).init()
        return tree_map(lambda l: torch.empty(
            (self.sessions,) + tuple(l.shape[1:]), dtype=l.dtype,
            device="meta"), one)

    # -------------------------------------------------------------- lifecycle
    def _hyper_of(self, spec) -> Optional[HyperParams]:
        """``None`` -> pod default; ``HyperParams`` passes through;
        ``SessionSpec`` is validated against the pod's algorithm."""
        if spec is None:
            return None
        if isinstance(spec, HyperParams):
            return spec
        if not isinstance(spec, SessionSpec):
            raise TypeError("spec must be a SessionSpec, HyperParams or "
                            f"None, got {type(spec).__name__}")
        if not isinstance(self.algo, SieveAlgorithm):
            raise ValueError(
                "per-session specs need a sieve-family algorithm (traced "
                f"hyperparam state); this pod hosts "
                f"{type(self.algo).__name__}")
        from repro_torch.core.api import _ALIASES, algo_name

        want = _ALIASES.get(spec.algo.lower(), spec.algo.lower())
        have = algo_name(self.algo)
        if want != have:
            raise ValueError(
                f"spec.algo={spec.algo!r} does not match this pod's "
                f"compiled program ({have}); only K/T/eps vary per slot")
        f = self.algo.f
        if spec.d is not None and int(spec.d) != f.d:
            raise ValueError(f"spec.d={spec.d} != pod objective d={f.d}")
        if float(spec.a) != f.a:
            raise ValueError(f"spec.a={spec.a} != pod a={f.a}")
        return self.algo.hyper(K=spec.K, T=spec.T, eps=spec.eps,
                               lengthscale=spec.lengthscale,
                               kernel_kind=spec.kernel_kind)

    def admit(self, state: PodState, session_id, spec=None
              ) -> Tuple[PodState, torch.Tensor, torch.Tensor]:
        """Admit a session into the first free slot -> (state, slot, ok).

        Idempotent for a live session id; a live session re-admitted with
        a different explicit spec returns ``ok=False``, state unchanged.
        """
        hyper = self._hyper_of(spec)
        sess = torch.as_tensor(session_id, dtype=torch.int32,
                               device=self.device)
        existing = state.active & (state.sid == sess)
        present = existing.any()
        free = ~state.active
        slot = torch.where(present, existing.to(torch.uint8).argmax(),
                           free.to(torch.uint8).argmax())
        if hyper is None:
            spec_ok = torch.ones((), dtype=torch.bool, device=self.device)
        else:
            row = leaves_with_keys(tree_map(lambda l: l[slot],
                                            state.algo.hp))
            want = leaves_with_keys(hyper)
            spec_ok = torch.stack([row[k] == want[k] for k in row]).all()
            spec_ok = torch.where(present, spec_ok, True)
        ok = (sess >= 0) & torch.where(present, spec_ok, free.any())
        hot = ((torch.arange(self.sessions, device=self.device) == slot)
               & ok & ~present)
        one = self.algo.init() if hyper is None else self.algo.init(hyper)
        fresh = stack_states(one, self.sessions)
        z = self._zeros()
        state = dataclasses.replace(
            state,
            algo=tree_select(hot, fresh, state.algo),
            sid=torch.where(hot, sess, state.sid),
            active=state.active | hot,
            items=torch.where(hot, z, state.items),
            accepts=torch.where(hot, z, state.accepts),
            win_items=torch.where(hot, z, state.win_items),
            win_accepts=torch.where(hot, z, state.win_accepts),
            resets=torch.where(hot, z, state.resets),
            drops_overflow=torch.where(hot, z, state.drops_overflow),
        )
        return state, slot, ok

    def evict(self, state: PodState, session_id) -> PodState:
        """Free the slot hosting ``session_id`` (no-op when absent)."""
        return self.evict_sids(state, torch.as_tensor(
            session_id, dtype=torch.int32, device=self.device).reshape(1))

    def evict_sids(self, state: PodState, session_ids) -> PodState:
        """Free every slot hosting one of ``session_ids`` at once."""
        sids = torch.as_tensor(session_ids, dtype=torch.int32,
                               device=self.device).reshape(-1)
        gone = state.active & (state.sid[:, None] == sids[None, :]).any(1)
        return dataclasses.replace(
            state, active=state.active & ~gone,
            sid=torch.where(gone, -1, state.sid))

    def routing_table(self, state: PodState) -> Dict[int, int]:
        """Host export of the live slot table: {session_id: slot}."""
        sid = state.sid.tolist()
        active = state.active.tolist()
        return {s: i for i, s in enumerate(sid) if active[i]}

    def reset_slots(self, state: PodState, mask: torch.Tensor) -> PodState:
        """Drift reset: re-arm the masked sessions' summaries, each from
        ``init`` of its own hyperparameter row (the JAX pod's
        ``vmap(algo.init)(hp)``; the pod default for an algorithm
        without them)."""
        with obs.hot_span("rearm"):
            hp = getattr(state.algo, "hp", None)
            with obs.hot_span("rearm.init"):
                fresh = (stack_states(self.algo.init(), self.sessions)
                         if hp is None else vmap(self.algo.init)(hp))
            with obs.hot_span("rearm.select"):
                mask = mask & state.active
                z = self._zeros()
                return dataclasses.replace(
                    state,
                    algo=tree_select(mask, fresh, state.algo),
                    win_items=torch.where(mask, z, state.win_items),
                    win_accepts=torch.where(mask, z, state.win_accepts),
                    resets=state.resets + mask.to(torch.int32),
                )

    def drift_check(self, state: PodState, *, min_items: int,
                    min_rate: float) -> Tuple[PodState, torch.Tensor]:
        """Reset sessions whose windowed accept rate collapsed
        -> (state, reset_mask)."""
        rate = (state.win_accepts.to(torch.float32)
                / torch.clamp_min(state.win_items, 1).to(torch.float32))
        mask = (state.active & (state.win_items >= min_items)
                & (rate < min_rate))
        return self.reset_slots(state, mask), mask

    # ---------------------------------------------------------------- routing
    def route(self, state: PodState, sids: torch.Tensor, X: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
        """Scatter a tagged batch to per-session chunk buffers.

        sids (N,) int32 (-1 = padding), X (N, d) -> (chunks (S, C, d),
        counts (S,), unknown (), overflow (S,)).  Items with no live
        session go to a trash row S; a stable sort keeps stream order per
        slot.  ``unknown`` counts items of no live session, ``overflow``
        items past a slot's C, per slot.

        On CUDA tensors the route synchronises with the host: each
        ``torch.bincount`` reads its input's minimum and maximum back to
        check and size its output (a copy to pageable memory, which
        blocks, then one to pinned memory, each followed by a stream
        sync).  The stable
        ``argsort`` may synchronise too, but did not on an H100 with
        PyTorch 2.11.  ``portbench/spantrace.py``'s ``host_syncs`` counts
        them by span (``route.count``, ``route.sort``).
        """
        S, C = self.sessions, self.chunk
        N = sids.shape[0]
        dev = sids.device
        with obs.hot_span("route"):
            with obs.hot_span("route.match"):
                match = ((sids[:, None] == state.sid[None, :])
                         & state.active[None, :])
                found = match.any(1)
                slot = torch.where(found, match.to(torch.uint8).argmax(1),
                                   torch.full_like(sids, S,
                                                   dtype=torch.int64))
            with obs.hot_span("route.sort"):
                order = torch.argsort(slot, stable=True)
                sorted_slot = slot[order]
            with obs.hot_span("route.position"):
                seg_start = torch.searchsorted(sorted_slot, sorted_slot,
                                               side="left")
                pos_sorted = torch.arange(N, device=dev) - seg_start
                pos = torch.empty_like(pos_sorted).scatter_(0, order,
                                                            pos_sorted)
            with obs.hot_span("route.scatter"):
                keep = found & (pos < C)
                slot_f = torch.where(keep, slot, S)
                pos_f = torch.clamp_max(pos, C - 1)
                chunks = torch.zeros((S + 1, C) + tuple(X.shape[1:]),
                                     dtype=X.dtype, device=dev)
                # duplicates only ever hit the trash row
                chunks[slot_f, pos_f] = X
            with obs.hot_span("route.count"):
                counts = torch.bincount(slot_f,
                                        minlength=S + 1)[:S].to(torch.int32)
                unknown = (~found & (sids >= 0)).sum().to(torch.int32)
                over_slot = torch.where(found & (pos >= C), slot, S)
                overflow = torch.bincount(over_slot,
                                          minlength=S + 1)[:S].to(torch.int32)
            return chunks[:S], counts, unknown, overflow

    # ----------------------------------------------------------------- ingest
    def ingest(self, state: PodState, sids: torch.Tensor, X: torch.Tensor
               ) -> Tuple[PodState, Dict[str, torch.Tensor]]:
        """Route one tagged batch and advance every session."""
        chunks, counts, unknown, overflow = self.route(state, sids, X)
        return self.ingest_routed(state, chunks, counts, unknown, overflow)

    def ingest_routed(self, state: PodState, chunks: torch.Tensor,
                      counts: torch.Tensor, unknown: torch.Tensor,
                      overflow: torch.Tensor
                      ) -> Tuple[PodState, Dict[str, torch.Tensor]]:
        """Advance every session from pre-routed chunk buffers.

        The algorithm state is stepped in place; the counters are new."""
        # per-session insertions, the monotone accept metric (not
        # ``summary()[1]``: a multi-rung algorithm's winning rung can
        # switch to a smaller summary); one call on the stacked state is
        # per slot, see ``SieveAlgorithm.insertions``
        with obs.hot_span("pod_step"):
            with obs.hot_span("pod_step.ledgers"):
                n_before = self.algo.insertions(state.algo).clone()
            algo2 = pod_step(self.algo, state.algo, chunks, counts)
            with obs.hot_span("pod_step.ledgers"):
                acc = self.algo.insertions(algo2) - n_before
                unk = unknown.to(torch.int32).sum(dtype=torch.int32)
                drops_unknown = state.drops_unknown.clone()
                drops_unknown[0] += unk
                state2 = dataclasses.replace(
                    state, algo=algo2,
                    items=state.items + counts,
                    accepts=state.accepts + acc,
                    win_items=state.win_items + counts,
                    win_accepts=state.win_accepts + acc,
                    drops_overflow=state.drops_overflow + overflow,
                    drops_unknown=drops_unknown,
                )
        return state2, {"counts": counts, "dropped_unknown": unk[None],
                        "dropped_overflow": overflow}

    # ---------------------------------------------------------------- readout
    def readout(self, state: PodState) -> PodReadout:
        """Per-session summaries (each slot's ``summary``), drop ledgers
        and hyperparameter rows (``None`` for an algorithm without
        them)."""
        feats, n, fval = vmap(self.algo.summary)(state.algo)
        drops = {"overflow": state.drops_overflow,
                 "unknown": state.drops_unknown.sum()}
        return PodReadout(feats=feats, n=n, fval=fval, active=state.active,
                          drops=drops, specs=getattr(state.algo, "hp", None))

    def drain_metrics(self, state: PodState, *, pod: str = "0",
                      registry=None) -> None:
        """Harvest this pod's device ledgers into host metrics.

        Host-only, and ONLY at a host-sync boundary (a readout, the end
        of a pipeline run): ``repro_torch.obs.drain.drain_pod`` documents
        the rule.
        """
        obs.drain.drain_pod(state, pod=pod, registry=registry)

    # -------------------------------------------------------------- scale-out
    def make_sharded_update(self, mesh, axis="data", *,
                            pre_routed: bool = False):
        """The P*S-session pod program: ``ingest`` mapped over the ranks
        of ``mesh`` along ``axis`` (a mesh axis name or a tuple of names:
        pass ``("pod", "data")`` on a multi-pod mesh so the session axis
        splits over both, not replicated over ``pod``), with
        ``tree.shard_map``.

        Global state and queue leaves are DTensors with a leading P*S
        (items: P*N) axis split over ``axis`` (``tree.shard_tree`` of
        each rank's own pod state); each rank routes its N items to its
        own S slots (the cluster front end routes session_id -> rank).
        Returns ``(state, sids, X) -> (state, stats)``, the stats split
        the same way; no collective runs in it.

        ``pre_routed=True`` returns the ``ingest_routed`` program
        instead: ``(state, chunks, counts, unknown, overflow) -> (state,
        stats)`` with chunks (P*S, C, d), counts / overflow (P*S,) and
        unknown (P,) (one host-routed count a rank).
        """
        return shard_map(self.ingest_routed if pre_routed else self.ingest,
                         mesh, axis)

    # ------------------------------------------------------------------ serve
    def serve(self, state: PodState, pipeline, *, max_batches=None,
              drift_every: int = 0, min_items: int = 0,
              min_rate: float = 0.0):
        """Drive the pod from an ``ingest.IngestPipeline`` — the
        streaming front-end loop.

        The pipeline owns the hot loop (double-buffered staging of the
        next batch while the card runs the current one); every
        ``drift_every`` device batches this pauses it at a safe point and
        runs ``drift_check`` (resets do not move slots, so the pipeline's
        slot table stays valid).  Returns ``(state, stats)``: the
        pipeline's counts summed over its runs, and a dict-valued stat
        (what an ``on_sync`` hook returns) from the latest run.
        """
        if not drift_every or drift_every <= 0:
            return pipeline.run(state, max_batches=max_batches)
        total = {}
        remaining = max_batches
        while True:
            n = (drift_every if remaining is None
                 else min(drift_every, remaining))
            state, stats = pipeline.run(state, max_batches=n)
            for k, v in stats.items():
                if isinstance(v, dict):
                    total[k] = v  # not additive: the latest wins
                else:
                    total[k] = total.get(k, 0) + v
            # host-side control plane between pipeline runs
            with obs.span("drift_reset", pod=str(pipeline.pod_id),
                          every=drift_every):
                state, _ = self.drift_check(state, min_items=min_items,
                                            min_rate=min_rate)
            if remaining is not None:
                remaining -= stats["batches"]
                if remaining <= 0:
                    return state, total
            if stats["batches"] < n or pipeline.exhausted:
                return state, total

    # ------------------------------------------------------------- checkpoint
    def save(self, store, step: int, state: PodState,
             extra: Optional[Dict] = None):
        """Checkpoint the whole pod (a host snapshot, copied before this
        returns; the next ingest may step the state in place)."""
        return store.save(step, state, extra or {})

    def restore(self, store, step: Optional[int] = None, *, slots=None,
                into: Optional[PodState] = None,
                saved_sessions: Optional[int] = None
                ) -> Tuple[PodState, Dict]:
        """Restore a pod mid-stream onto this pod's device.

        ``slots`` selects a *subset* of the saved session rows — a bool
        mask or an index array over the saved pod's slots — and places
        them into the free slots of the live pod state ``into`` (the
        session-migration half of pod autoscaling: drain on pod A,
        restore rows into pod B without touching B's resident tenants).
        ``saved_sessions`` sizes the saved pod when it differs from this
        pod's ``sessions`` (migrating between pods of different width).
        Inactive saved rows among the selection are skipped; a selected
        session id already live in ``into`` is a conflict (the session
        would be hosted twice) and raises.  ``into``'s pod-scoped
        ``drops_unknown`` ledger is kept as-is — it is not session
        state.  Per-slot hyperparams migrate with their rows, so a K=10
        tenant restored into a K_max=100 pod keeps its K=10 budget.

        The saved pod is read on the host; only the selected rows go to
        the card, and they are written into ``into``'s tensors in place
        (``index_copy_``, one per leaf: the card's share of the cost
        scales with the rows moved, not with the pod's width) after every
        check has passed, and ``into`` is returned.
        """
        if step is None:
            step = store.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {store.root}")
        if slots is None:
            return store.load(step, self.abstract_state(),
                              device=self.device)

        if into is None:
            raise ValueError("slot-subset restore needs the live pod state: "
                             "restore(..., slots=..., into=state)")
        donor = (self if saved_sessions is None
                 else dataclasses.replace(self, sessions=saved_sessions))
        saved, extra = store.load(step, donor.abstract_state(),
                                  device="cpu")
        S_saved = donor.sessions
        slots = np.asarray(slots)
        sel = (np.flatnonzero(slots) if slots.dtype == bool
               else slots.astype(np.int64).ravel())
        if sel.size and (sel.min() < 0 or sel.max() >= S_saved):
            raise IndexError(f"slot index out of range for saved pod of "
                             f"{S_saved} sessions: {sel}")
        # dedupe (first occurrence wins): a repeated index would place the
        # same session into two slots — the double-hosted state admit()'s
        # idempotency guard exists to prevent
        sel = sel[np.sort(np.unique(sel, return_index=True)[1])]
        sel = sel[saved.active.numpy()[sel]]  # skip dead saved rows
        into_active = into.active.cpu().numpy()
        live_sids = into.sid.cpu().numpy()[into_active]
        moving = saved.sid.numpy()[sel]
        clash = np.intersect1d(moving, live_sids)
        if clash.size:
            raise ValueError(f"session ids {clash.tolist()} are already live "
                             "in the target pod")
        free = np.flatnonzero(~into_active)
        if sel.size > free.size:
            raise ValueError(f"target pod has {free.size} free slots for "
                             f"{sel.size} restored sessions")
        src = torch.as_tensor(sel)
        dst = torch.as_tensor(free[: sel.size], device=self.device)
        rows = tree_map(lambda l: l.index_select(0, src).to(self.device),
                        saved)
        rows = dataclasses.replace(
            rows, drops_unknown=into.drops_unknown.index_select(0, dst))
        return copy_into(into, rows, rows=dst), extra
