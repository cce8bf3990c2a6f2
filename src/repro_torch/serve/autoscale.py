# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""PodAutoscaler: the drain/migrate driver of an elastic summarizer fleet
(port of ``repro/serve/autoscale.py``).

The groundwork made sessions cheap to move: a tenant is its (K, d)
summary rows plus its HyperParams row — a fixed-budget pytree slice
(the paper's whole point), already migratable via the slot-subset
``SummarizerPod.restore(..., slots=, into=)`` path.  What was missing is
the *driver*: something that watches the load signals the system
already surfaces, decides a pod is hot, picks victims, and executes a
live two-pod handoff without dropping an in-flight item.  That is this
module.

Signals (all free — they exist for other reasons):

  * slot occupancy      — ``PodReadout.active`` / pod size;
  * overflow drops      — per-slot ``drops_overflow`` deltas since the
                          last check (a tenant outrunning its routing
                          capacity C);
  * queue depth         — per-session ``TaggedBuffer.depths()`` at the
                          fleet front-end (``ingest.PodRouter``).

Handoff protocol (quiesce -> snapshot -> restore -> evict -> flip ->
release), executed by :meth:`PodAutoscaler.handoff` at a safe point —
between ``pipeline.run`` calls, when the source pod's device work is
drained:

  1. **quiesce** the victim sids at the front-end: their items keep
     landing in the source pod's buffer but stop draining — buffered,
     never dropped;
  2. **snapshot** the victim rows of the source pod (one
     ``index_select`` per leaf on the card) to a ``ckpt.MemoryStore``
     (a host copy; no disk inside the quiesce window) and slot-subset
     **restore** them into the target pod's free slots (one
     ``index_copy_`` per leaf);
  3. **evict** the victims from the source pod (one masked select for
     the whole set — ``evict_sids``);
  4. **flip** the routing table and move the parked backlog into the
     target pod's buffer (``PodRouter.migrate``, atomic w.r.t. ``put``,
     so per-session FIFO survives the flip).

Why bit-equality survives migration: a session's future depends only on
its algorithm-state row (summary, thresholds, hyperparams — all moved
verbatim by the checkpoint path) and on the order of its remaining
items (preserved end-to-end: drained-before, parked-backlog, arrivals-
after are disjoint in time per session).  The distributed argument of
the source paper §7 says a summary is a function of (state, item
order), not of which machine holds it — so the migrated tenant's next
readout is bit-equal to the run that never moved (pinned in
tests/test_torch_autoscale.py, on the card in ``chip_smoke.py``'s phase
``handoff``).

A refusal is atomic: if the target pod cannot host the victim set (or a
victim sid is already live there), ``handoff`` returns ``ok=False``
before quiescing anything — the source pod, the routing table and every
buffer are untouched.  Unknown/evicted victims are skipped and counted,
never an error: an autoscaler races evictions by design.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.ckpt import MemoryStore
from repro_torch.ingest import PodRouter
from repro_torch.tree import tree_map

VICTIM_POLICIES = ("fewest-insertions", "largest-queue", "round-robin")


@dataclasses.dataclass(frozen=True)
class ScalePolicy:
    """Declarative 'when is a pod hot, and who moves' policy.

    A signal set to ``None`` is disabled; a pod is hot when ANY enabled
    signal trips.  ``victims`` bounds how many sessions one rebalance
    moves (small moves keep the quiesce window short — the latency the
    bench measures)."""

    max_occupancy: Optional[float] = 0.9  # active slots / S
    max_queue_depth: Optional[int] = None  # per-session front-end backlog
    max_overflow_delta: Optional[int] = None  # new overflow drops per check
    victims: int = 1
    victim_policy: str = "fewest-insertions"

    def __post_init__(self):
        if self.victim_policy not in VICTIM_POLICIES:
            raise ValueError(f"unknown victim policy {self.victim_policy!r};"
                             f" one of {VICTIM_POLICIES}")
        if self.victims < 1:
            raise ValueError(f"victims must be >= 1, got {self.victims}")
        if self.max_occupancy is not None \
                and not 0.0 < self.max_occupancy <= 1.0:
            raise ValueError(f"max_occupancy in (0, 1], got "
                             f"{self.max_occupancy}")


class PodSignals(NamedTuple):
    """One pod's load picture at a check."""

    occupancy: float  # live slots / S
    free_slots: int
    queue_depths: Dict[int, int]  # sid -> front-end backlog
    overflow_delta: Dict[int, int]  # sid -> overflow drops since last check


@dataclasses.dataclass
class HandoffReport:
    """What one two-pod handoff did (or why it refused)."""

    src: int
    dst: int
    requested: List[int]
    moved: List[int]
    skipped: List[int]  # unknown/evicted sids — counted no-ops
    backlog_items: int  # parked items forwarded to the target's buffer
    latency_s: float  # quiesce -> release wall time (the service blip)
    ok: bool
    reason: str = ""


@dataclasses.dataclass
class PodAutoscaler:
    """Drive drain/migrate rebalancing over a ``PodRouter`` fleet.

    ``pods`` maps pod id -> ``SummarizerPod`` program, with one
    buffer-mode pipeline per pod registered in ``router`` under the
    same ids.  Pod *states* stay with the caller (they are the values
    the caller's serve loop threads through ``pipeline.run``);
    state-changing methods take and return the states dict.

    Call :meth:`handoff` (or the policy-driven :meth:`maybe_rebalance`)
    only at a safe point: between ``pipeline.run`` calls, when the
    source pod's in-flight device work has drained (``run`` blocks on
    the state before returning, so 'after run returned' is safe).
    """

    router: PodRouter
    pods: Dict[int, "object"]  # pod id -> SummarizerPod
    policy: ScalePolicy = ScalePolicy()

    def __post_init__(self):
        missing = set(self.pods) - set(self.router.pipelines)
        if missing:
            raise ValueError(f"pods {sorted(missing)} have no router pipeline")
        self._last_overflow: Dict[int, np.ndarray] = {}
        self._rr: Dict[int, int] = {}  # round-robin victim cursor per pod
        self.skipped_unknown = 0  # lifetime no-op victims (the counted kind)

    # ---------------------------------------------------------------- signals
    def signals(self, pod_id: int, state) -> PodSignals:
        """Read one pod's load signals; the overflow baseline advances,
        so each call sees only the drops since the previous one.

        Doubles as the fleet's telemetry *drain tick*: the call already
        host-reads the pod's device ledgers (that is what a load check
        is), so harvesting them into the metrics registry here is free —
        no extra sync, no extra cadence (DESIGN.md §13).
        """
        obs.drain.drain_pod(state, pod=str(pod_id))
        obs.drain.drain_buffer(self.router.pipelines[pod_id].buffer,
                               pod=str(pod_id))
        active = state.active.cpu().numpy()
        sid = state.sid.cpu().numpy()
        over = state.drops_overflow.cpu().numpy()
        last = self._last_overflow.get(pod_id, np.zeros_like(over))
        if last.shape != over.shape:  # pod resized between checks
            last = np.zeros_like(over)
        delta = over - last
        self._last_overflow[pod_id] = over
        depths = self.router.pipelines[pod_id].buffer.depths()
        return PodSignals(
            occupancy=float(active.mean()) if active.size else 0.0,
            free_slots=int((~active).sum()),
            queue_depths={int(s): depths.get(int(s), 0)
                          for s in sid[active]},
            overflow_delta={int(s): int(d)
                            for s, d in zip(sid[active], delta[active])
                            if d > 0},
        )

    def hot(self, sig: PodSignals) -> Tuple[bool, str]:
        """Does ``sig`` trip any enabled policy threshold?"""
        p = self.policy
        if p.max_occupancy is not None and sig.occupancy > p.max_occupancy:
            return True, f"occupancy {sig.occupancy:.2f} > {p.max_occupancy}"
        if p.max_queue_depth is not None and sig.queue_depths:
            sid, depth = max(sig.queue_depths.items(), key=lambda kv: kv[1])
            if depth > p.max_queue_depth:
                return True, (f"session {sid} backlog {depth} > "
                              f"{p.max_queue_depth}")
        if p.max_overflow_delta is not None and sig.overflow_delta:
            sid, d = max(sig.overflow_delta.items(), key=lambda kv: kv[1])
            if d > p.max_overflow_delta:
                return True, (f"session {sid} overflow drops +{d} > "
                              f"{p.max_overflow_delta}")
        return False, ""

    # ---------------------------------------------------------------- victims
    def pick_victims(self, pod_id: int, state, n: Optional[int] = None
                     ) -> List[int]:
        """Choose up to ``n`` victim sids from ``pod_id`` per the policy.

        * ``fewest-insertions`` — smallest lifetime accept count first:
          the cheapest summaries to re-host, and the coldest tenants;
        * ``largest-queue``     — deepest front-end backlog first: move
          the tenant that is *causing* the pressure;
        * ``round-robin``       — rotate over live sids: fairness when
          no signal singles anyone out.
        """
        n = self.policy.victims if n is None else n
        table = self.pods[pod_id].routing_table(state)
        live = sorted(table)  # deterministic base order
        if not live:
            return []
        kind = self.policy.victim_policy
        if kind == "fewest-insertions":
            accepts = state.accepts.cpu().numpy()
            live.sort(key=lambda s: (int(accepts[table[s]]), s))
        elif kind == "largest-queue":
            depths = self.router.pipelines[pod_id].buffer.depths()
            live.sort(key=lambda s: (-depths.get(s, 0), s))
        else:  # round-robin
            cur = self._rr.get(pod_id, 0) % len(live)
            self._rr[pod_id] = cur + n
            live = live[cur:] + live[:cur]
        return live[:n]

    # ---------------------------------------------------------------- handoff
    def handoff(self, states: Dict[int, "object"], src: int, dst: int,
                session_ids) -> Tuple[Dict[int, "object"], HandoffReport]:
        """Migrate ``session_ids`` from pod ``src`` to pod ``dst``, live.

        Returns the updated states dict and a :class:`HandoffReport`.
        Refusals are atomic (nothing quiesced, nothing moved); unknown
        or already-evicted sids are skipped and counted.

        Telemetry: the whole protocol runs under a ``handoff`` span with
        one child span per phase (quiesce/snapshot/restore/evict/flip);
        a refusal closes the parent with ``outcome="refused"`` and NO
        phase children — the span tree is the protocol's audit trail.
        Both pods' device ledgers are drained after a successful move (a
        handoff edge is a host-sync boundary: the victim rows were just
        copied to the host and back).
        """
        reg = obs.get_registry(None)
        with obs.span("handoff", src=str(src), dst=str(dst)) as sp:
            try:
                states, rep = self._handoff(states, src, dst, session_ids)
            except BaseException:
                if reg.enabled:
                    reg.counter("handoffs_total", self._HANDOFF_HELP,
                                ("outcome",)).labels(outcome="error").inc()
                raise
            sp.set(moved=len(rep.moved), skipped=len(rep.skipped),
                   backlog_items=rep.backlog_items, reason=rep.reason)
            if not rep.ok:
                sp.set_outcome("refused")
            if reg.enabled:
                reg.counter("handoffs_total", self._HANDOFF_HELP,
                            ("outcome",)).labels(
                    outcome="ok" if rep.ok else "refused").inc()
                reg.counter("sessions_migrated_total",
                            "sessions moved between pods, fleet-wide"
                            ).inc(len(rep.moved))
                reg.counter("backlog_items_migrated_total",
                            "parked backlog items forwarded at table flips"
                            ).inc(rep.backlog_items)
                if rep.ok and rep.moved:
                    obs.drain.drain_pod(states[src], pod=str(src),
                                        registry=reg)
                    obs.drain.drain_pod(states[dst], pod=str(dst),
                                        registry=reg)
        return states, rep

    _HANDOFF_HELP = "two-pod session migrations by outcome"

    def _handoff(self, states: Dict[int, "object"], src: int, dst: int,
                 session_ids) -> Tuple[Dict[int, "object"], HandoffReport]:
        t0 = time.perf_counter()
        src_pod, dst_pod = self.pods[src], self.pods[dst]
        src_state, dst_state = states[src], states[dst]
        requested = [int(s) for s in np.asarray(session_ids).ravel()]
        table = src_pod.routing_table(src_state)
        moving = [s for s in requested if s in table]
        skipped = [s for s in requested if s not in table]

        def report(ok, reason="", moved=(), backlog=0):
            return HandoffReport(
                src=src, dst=dst, requested=requested, moved=list(moved),
                skipped=skipped, backlog_items=backlog,
                latency_s=time.perf_counter() - t0, ok=ok, reason=reason)

        if src == dst:
            return states, report(False, "src == dst")
        # atomic refusal BEFORE quiescing: capacity and clash checks.
        # (Refusals also leave the skipped ledger untouched — a caller
        # retrying a refused handoff must not double-count its no-ops.)
        if moving:
            dst_active = dst_state.active.cpu().numpy()
            free = int((~dst_active).sum())
            if len(moving) > free:
                return states, report(
                    False, f"target pod {dst} has {free} free slots for "
                           f"{len(moving)} victims")
            dst_live = set(dst_state.sid.cpu().numpy()[dst_active].tolist())
            clash = sorted(set(moving) & dst_live)
            if clash:
                return states, report(
                    False,
                    f"sessions {clash} already live in target pod {dst}")
        self.skipped_unknown += len(skipped)  # the handoff executes now
        if not moving:
            return states, report(True, "no live victims (no-op)")

        # 1. park the victims' stream at the front-end (buffer, don't drop)
        with obs.span("quiesce", sessions=len(moving)):
            self.router.quiesce(moving)
        try:
            # 2. snapshot ONLY the victim rows (one device gather of the
            # selected slots per leaf — the quiesce window must scale
            # with the victim count, not the pod width) and migrate them
            # into dst's free slots via the existing slot-subset
            # checkpoint path, pointed at a MemoryStore
            with obs.span("snapshot", sessions=len(moving)):
                slots = torch.as_tensor([table[s] for s in moving],
                                        device=src_pod.device)
                compact = tree_map(lambda l: l.index_select(0, slots),
                                   src_state)
                store = MemoryStore(keep=1)
                store.save(0, compact)
            with obs.span("restore", pod=str(dst)):
                merged, _ = dst_pod.restore(
                    store, 0, slots=np.arange(len(moving)), into=dst_state,
                    saved_sessions=len(moving))
            # 3. free the source slots in one masked select
            with obs.span("evict", pod=str(src), sessions=len(moving)):
                new_src = src_pod.evict_sids(src_state, moving)
        except BaseException:
            self.router.release(moving)  # un-park; the stream resumes at src
            raise
        # 4. flip the table and forward the parked backlog — zero drops
        with obs.span("flip", dst=str(dst)) as flip_sp:
            backlog = self.router.migrate(moving, dst)
            flip_sp.set(backlog_items=backlog)
        out = dict(states)
        out[src], out[dst] = new_src, merged
        return out, report(True, moved=moving, backlog=backlog)

    # -------------------------------------------------------------- rebalance
    def maybe_rebalance(self, states: Dict[int, "object"]
                        ) -> Tuple[Dict[int, "object"],
                                   Optional[HandoffReport]]:
        """One policy step: find the hottest tripping pod, hand victims
        to the pod with the most free slots.  Returns ``(states, None)``
        when nothing trips (or no target can host)."""
        obs.drain.drain_router(self.router)  # the check IS the drain tick
        picture = {pid: self.signals(pid, states[pid]) for pid in self.pods}
        hot = [(pid, reason) for pid, sig in picture.items()
               for ok, reason in [self.hot(sig)] if ok]
        if not hot:
            return states, None
        src, reason = max(
            hot, key=lambda pr: picture[pr[0]].occupancy)
        targets = [pid for pid in self.pods
                   if pid != src and picture[pid].free_slots > 0
                   and not self.hot(picture[pid])[0]]
        if not targets:
            return states, None
        dst = max(targets, key=lambda pid: picture[pid].free_slots)
        n = min(self.policy.victims, picture[dst].free_slots)
        victims = self.pick_victims(src, states[src], n)
        states, rep = self.handoff(states, src, dst, victims)
        if rep.ok and not rep.reason:
            rep.reason = f"pod {src} hot: {reason}"
        return states, rep
