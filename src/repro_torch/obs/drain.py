# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The device-counter drain: harvest PodState ledgers at sync boundaries
(port of ``repro/obs/drain.py``).

The pod keeps its accept/drop/insertion accounting ON DEVICE — (S,)
int32 leaves of ``PodState`` updated on the card by the ingest step
(``drops_overflow``, ``drops_unknown``, ``items``, ``accepts``,
``resets``).  That is the whole design: the hot path never talks to the
host.  Telemetry must not undo it, so the one rule of this module is

    **record at host-sync boundaries only** —

the drain reads device counters exclusively at points where the caller
has already synchronized (the ``torch.cuda.synchronize`` at the end
of ``IngestPipeline.run``, a readout, the host gather of a handoff or
checkpoint edge) and it is *never called from the ingest step
itself*.  One drain is a handful of (S,)-int32 transfers —
microseconds, at control-plane cadence.

Cumulative -> monotonic: the device ledgers are *cumulative totals*
(and the session-scoped ones restart when a slot is recycled by
``admit``), while registry counters must be monotone.
:func:`observe_total` bridges the two — it incs by the delta since the
previous drain of the same series, and treats a shrinking total as a
counter reset (slot recycle), counting the post-reset value as new.
Baselines live on the registry itself, so a fresh registry (tests,
benches) starts with fresh baselines.

This also unifies the fleet's three drop ledgers under ONE family::

    drops_total{layer="pod",    reason="overflow"|"unknown", pod=...}
    drops_total{layer="buffer", reason="clipped",            pod=...}
    drops_total{layer="router", reason="unrouted",           pod="-"}

pod-layer drops come from the device ledgers (this drain), buffer-layer
from ``TaggedBuffer``'s lifetime per-session drop dict, router-layer
from ``PodRouter.drops_unrouted`` — all snapshotted as monotone
counters, whatever the underlying ledger's own lifetime semantics.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .registry import get_registry

DROPS_HELP = ("items dropped anywhere in the serving stack, by layer "
              "(router front-end / ingest buffer / pod routing) and cause")

#: ladder rung -> gauge value (mirrors repro_torch.ingest.shedding.RUNGS,
#: duplicated here so obs never imports the ingest layer)
SHED_RUNG_INDEX = {"admit": 0, "subsample": 1, "clip": 2}


def observe_total(name: str, labels: Dict[str, str], total: float, *,
                  help: str = "", registry=None) -> float:
    """Record a cumulative device/host ledger total as a monotone
    counter; returns the delta actually added.

    Reset rule: ``total < last`` means the underlying ledger restarted
    (a recycled pod slot, a rebuilt buffer) — the post-reset total is
    counted as new growth.  Residue accumulated between the last drain
    and the reset is lost; drain at every lifecycle edge (the
    instrumented call sites do) to keep that window small.
    """
    reg = get_registry(registry)
    if not reg.enabled:
        return 0.0
    key: Tuple = (name, tuple(sorted(labels.items())))
    last = reg.drain_baselines.get(key, 0.0)
    total = float(total)
    delta = total if total < last else total - last
    reg.drain_baselines[key] = total
    # inc(0) still registers the series: a dashboard should show
    # drops_total{...} = 0 from the first drain, not a hole until the
    # first loss
    reg.counter(name, help, tuple(sorted(labels))).labels(
        **labels).inc(delta)
    return delta


# --------------------------------------------------------------------------
# the three drain points
# --------------------------------------------------------------------------


def drain_pod(state, *, pod: str, registry=None) -> None:
    """Harvest one pod's device ledgers (PodState) into host metrics.

    Call ONLY at a host-sync boundary (see module docstring).  Cost:
    five (S,) int32 device->host transfers + one (S,) bool.
    """
    reg = get_registry(registry)
    if not reg.enabled:
        return
    pod = str(pod)
    over = int(_host(state.drops_overflow).sum())
    unk = int(_host(state.drops_unknown).sum())
    observe_total("drops_total",
                  {"layer": "pod", "reason": "overflow", "pod": pod},
                  over, help=DROPS_HELP, registry=reg)
    observe_total("drops_total",
                  {"layer": "pod", "reason": "unknown", "pod": pod},
                  unk, help=DROPS_HELP, registry=reg)
    observe_total("pod_items_total", {"pod": pod},
                  int(_host(state.items).sum()),
                  help="items routed into live sessions", registry=reg)
    observe_total("pod_accepts_total", {"pod": pod},
                  int(_host(state.accepts).sum()),
                  help="summary insertions across the pod", registry=reg)
    observe_total("pod_drift_resets_total", {"pod": pod},
                  int(_host(state.resets).sum()),
                  help="drift-triggered session re-arms", registry=reg)
    active = _host(state.active)
    reg.gauge("pod_active_sessions", "live slots", ("pod",)).labels(
        pod=pod).set(int(active.sum()))
    reg.gauge("pod_occupancy", "live slots / S", ("pod",)).labels(
        pod=pod).set(float(active.mean()) if active.size else 0.0)


def _host(t) -> np.ndarray:
    """A PodState ledger as a host array (a device tensor is copied)."""
    return t.detach().cpu().numpy()


SHED_HELP = ("items shed by the buffer's watermark ladder, by rung "
             "(subsample = Bernoulli thinning of over-share tenants, "
             "clip = two-threshold clipping) — deliberate policy losses, "
             "kept OUT of drops_total so overflow stays an accident signal")
THROTTLE_HELP = "items refused by per-session token-bucket rate limits"

#: every ladder rung that sheds — registered at zero on each drain so a
#: dashboard shows shed_total{policy=...} = 0, not a hole until overload
SHED_POLICIES = ("subsample", "clip")


def drain_buffer(buffer, *, pod: str, registry=None) -> None:
    """Harvest a ``TaggedBuffer``'s ledgers (host-side; no device I/O).

    ``drops_total{layer="buffer", reason="clipped"}`` counts *overflow*
    drops only; the admission policies' deliberate losses go to their
    own families (``shed_total{policy,pod}``,
    ``ratelimit_throttled_total{pod}``) so the PR 8 unification stays
    truthful — a rising drops_total still means something went wrong,
    a rising shed_total means the ladder is doing its job.
    """
    reg = get_registry(registry)
    if not reg.enabled:
        return
    pod = str(pod)
    observe_total("drops_total",
                  {"layer": "buffer", "reason": "clipped", "pod": pod},
                  buffer.total_drops(), help=DROPS_HELP, registry=reg)
    by_policy = buffer.shed_policy_counts()
    for policy in SHED_POLICIES:
        observe_total("shed_total", {"policy": policy, "pod": pod},
                      by_policy.get(policy, 0), help=SHED_HELP,
                      registry=reg)
    observe_total("ratelimit_throttled_total", {"pod": pod},
                  buffer.total_throttled(), help=THROTTLE_HELP,
                  registry=reg)
    reg.gauge("buffer_shed_rung",
              "current ladder rung (0 admit / 1 subsample / 2 clip)",
              ("pod",)).labels(pod=pod).set(
        SHED_RUNG_INDEX.get(buffer.shed_rung(), 0))
    reg.gauge("buffer_depth_items", "buffered items awaiting the pod",
              ("pod",)).labels(pod=pod).set(buffer.size)
    reg.gauge("buffer_quiesced_sessions",
              "sessions parked mid-handoff", ("pod",)).labels(
        pod=pod).set(len(buffer.quiesced()))


def drain_router(router, *, registry=None) -> None:
    """Harvest the fleet front-end's unrouted-drop ledger."""
    reg = get_registry(registry)
    if not reg.enabled:
        return
    observe_total("drops_total",
                  {"layer": "router", "reason": "unrouted", "pod": "-"},
                  sum(router.drops_unrouted.values()),
                  help=DROPS_HELP, registry=reg)
    reg.gauge("router_table_sessions",
              "sessions with a front-end route", ()).set(len(router.table()))
