# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Double-buffered ingest: the next batch staged while the card steps the
current one (port of ``repro/ingest/pipeline.py``).

    compute stream |   step(i-1)    |    step(i)     |   step(i+1)   |
    side stream    | copy(i)        | copy(i+1)      | copy(i+2)     |
    host           | stage(i+1)     | stage(i+2)     | ...           |

  * for a pod on the card, a batch is repacked to the fixed device
    batch on the host into one of two pinned buffers, the tagged batch
    (sids, X) is copied to the card on a side CUDA stream, and the
    compute stream waits on that copy's event before
    ``SummarizerPod.route`` and ``ingest_routed``: the copy of batch i+1
    and the host's work on batch i+2 overlap the step of batch i (the
    reference's ``jax.device_put`` plus asynchronous dispatch).  The
    card routes, not the host: a numpy scatter of a 268 MB batch takes
    several times its copy;
  * for a pod on the CPU, ``host_route`` (the reference's choice) writes
    the per-session chunks; both routes give the same chunks;
  * the pod step updates the state in place, the stand-in for the
    reference's donated jit.

Routing with a snapshot of the slot table is legal because the table
(sid, active) only changes through lifecycle calls, never through
``ingest``: ``run()`` snapshots it once at entry, and drift resets keep
slots, so ``serve``'s periodic ``drift_check`` needs no re-snapshot.

Feed modes: ``source=`` pulls tagged batches inline; ``buffer=`` drains
a ``TaggedBuffer`` that producer threads fill (``feed_from``).
``PodRouter`` is the fleet front end above that: one tagged ingress
fanned out to N pods' buffers through a host routing table.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.concurrency import make_lock

from .buffer import PAD_SID, TaggedBuffer
from .sources import Source, TaggedBatch

def host_route(sid_table: np.ndarray, active: np.ndarray, sids: np.ndarray,
               X: np.ndarray, chunk: int, *, out: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Numpy twin of ``SummarizerPod.route`` — the same four arrays.

    (sid_table (S,), active (S,), sids (N,), X (N, d), chunk C) ->
    (chunks (S, C, d), counts (S,), unknown (), overflow (S,)).  A slot
    is found by a lookup in the sorted live sid table (the first slot of
    a duplicated id, as the reference's (N, S) match finds it), and a
    stable sort on the slot keeps per-session FIFO.  ``out`` (S, C, d)
    receives the chunks in place (rows past a slot's count are zeroed).
    """
    S, C = len(sid_table), chunk
    N = len(sids)
    sids = np.asarray(sids, np.int32)
    live = np.flatnonzero(active)
    order = np.argsort(sid_table[live], kind="stable")
    table, table_slot = sid_table[live][order], live[order]
    at = np.minimum(np.searchsorted(table, sids, side="left"),
                    max(len(table) - 1, 0))
    found = (table[at] == sids) if len(table) else np.zeros(N, bool)
    slot = np.where(found, table_slot[at] if len(table) else S, S)
    # 16-bit keys take numpy's radix sort
    key = slot.astype(np.int16 if S < np.iinfo(np.int16).max else np.int32)
    order = np.argsort(key, kind="stable")
    seg_start = np.searchsorted(slot[order], slot[order], side="left")
    pos = np.empty((N,), np.int64)
    pos[order] = np.arange(N, dtype=np.int64) - seg_start
    keep = found & (pos < C)
    chunks = (np.zeros((S, C) + X.shape[1:], X.dtype) if out is None
              else out)
    rows = chunks.reshape((S * C,) + X.shape[1:])
    if keep.all():
        rows[slot * C + pos] = X
    else:
        rows[slot[keep] * C + pos[keep]] = X[keep]
    counts = np.bincount(slot[keep], minlength=S).astype(np.int32)
    if out is not None:
        for s in np.flatnonzero(counts < C):
            chunks[s, counts[s]:] = 0
    unknown = np.int32((~found & (sids >= 0)).sum())
    over = found & (pos >= C)
    overflow = np.bincount(slot[over], minlength=S).astype(np.int32)
    return chunks, counts, unknown, overflow


class _Stage:
    """One of the two staging slots: the host buffers (pinned, holding the
    tagged batch, for a pod on the card; the routed chunks for a pod on
    the CPU), their device twins and the events that say when each may
    be reused."""

    def __init__(self, S: int, C: int, B: int, d: int, dev):
        pin = dev.type == "cuda"
        shapes = ({"sids": ((B,), torch.int32), "X": ((B, d), torch.float32)}
                  if pin else
                  {"chunks": ((S, C, d), torch.float32),
                   "counts": ((S,), torch.int32),
                   "overflow": ((S,), torch.int32),
                   "unknown": ((), torch.int32)})
        self.host = {k: torch.empty(s, dtype=t, pin_memory=pin)
                     for k, (s, t) in shapes.items()}
        self.dev = ({k: torch.empty(s, dtype=t, device=dev)
                     for k, (s, t) in shapes.items()} if pin else self.host)
        self.copied = torch.cuda.Event() if pin else None
        self.stepped = torch.cuda.Event() if pin else None
        self.used = False


@dataclasses.dataclass
class IngestPipeline:
    """Drive a SummarizerPod from a tagged source, double-buffered.

    ``batch`` is the fixed device batch size: ragged source batches are
    repacked (and the final partial batch PAD_SID-padded).  Size it so
    that no session exceeds the pod's per-session capacity ``chunk``
    within one batch (everything else is counted overflow, never
    corrupted).  ``timings``, when a list, receives one dict per device batch: the
    host's ms drawing it from the feed and staging it (routing it, for a
    pod on the CPU), and, on the card,
    the copy's and the step's (start, end) ms from the run's first event
    (CUDA events).
    """

    pod: "object"  # SummarizerPod (kept loose to avoid an import cycle)
    source: Optional[Source] = None
    buffer: Optional[TaggedBuffer] = None
    batch: int = 256
    get_timeout: Optional[float] = None  # buffer mode: None = wait forever
    min_fill: int = 1  # buffer mode: items to wait for per device batch
    pod_id: "object" = 0  # telemetry label; PodRouter stamps its key here
    metrics: "object" = None  # None = process default registry; obs.NULL off
    # host callback fired at run()'s sync boundary (after the final
    # synchronize, state fully materialized); a returned dict is merged
    # into run()'s stats
    on_sync: "object" = None
    timings: Optional[List[dict]] = None

    def __post_init__(self):
        if (self.source is None) == (self.buffer is None):
            raise ValueError(
                "exactly one of source= or buffer= must be given")
        self._gen: Optional[Iterator[TaggedBatch]] = None
        self._stages: Optional[List[_Stage]] = None
        self._feeders = []
        self._feed_exc: Optional[BaseException] = None
        self.exhausted = False

    # ------------------------------------------------------------------ feed
    def feed_from(self, source: Source, *, close: bool = True,
                  put_timeout: Optional[float] = None) -> threading.Thread:
        """Spawn a daemon thread that puts ``source`` into the buffer
        (and closes it on exhaustion) — the producer half of buffer mode.
        Backpressure is the buffer's policy: ``block`` pauses the
        feeder, the drop policies clip per session."""
        if self.buffer is None:
            raise ValueError("feed_from() needs buffer mode")

        def _run():
            try:
                for sids, X in source:
                    self.buffer.put(sids, X, timeout=put_timeout)
            except BaseException as e:
                # surfaced by run(): a wire failure must not masquerade
                # as a clean end-of-stream with fewer items
                self._feed_exc = e
            finally:
                if close:
                    self.buffer.close()

        t = threading.Thread(target=_run, daemon=True)
        t.start()
        self._feeders.append(t)
        return t

    def _fixed_batches(self) -> Iterator[TaggedBatch]:
        """Repack ragged tagged batches into exactly-``batch``-sized ones
        (last one padded); per-session FIFO is order-preserving here."""
        B = self.batch
        d = self.pod.algo.f.d
        if self.buffer is not None:
            while True:
                got = self.buffer.get(B, pad_to=B, d=d,
                                      timeout=self.get_timeout,
                                      min_items=self.min_fill)
                if got is None:
                    return
                yield got
        stash: list = []
        count = 0
        for sids, X in self.source:
            if not count and len(sids) == B:
                yield sids, X  # aligned fast path: no copy
                continue
            stash.append((sids, X))
            count += len(sids)
            while count >= B:
                s = np.concatenate([p[0] for p in stash])
                x = np.concatenate([p[1] for p in stash])
                yield s[:B], x[:B]
                stash = [(s[B:], x[B:])] if count > B else []
                count -= B
        if count:
            s = np.concatenate([p[0] for p in stash])
            x = np.concatenate([p[1] for p in stash])
            pad = B - count
            yield (np.concatenate([s, np.full((pad,), PAD_SID, np.int32)]),
                   np.concatenate([x, np.zeros((pad, x.shape[1]),
                                               np.float32)]))

    # ------------------------------------------------------------------- run
    def _stage_slots(self) -> List[_Stage]:
        if self._stages is None:
            pod = self.pod
            self._stages = [_Stage(pod.sessions, pod.chunk, self.batch,
                                   pod.algo.f.d, pod.device)
                            for _ in range(2)]
        return self._stages

    def run(self, state, *, max_batches: Optional[int] = None):
        """Ingest up to ``max_batches`` device batches (None = until the
        feed ends); resumable — the feed position persists across calls.
        Returns ``(state, stats)``.

        ``stats`` carries the drop counters the routing observed
        (``dropped_unknown`` / ``dropped_overflow``).  A producer failure
        recorded by a ``feed_from`` thread re-raises from here: a broken
        wire must never look like a clean end-of-stream.
        """
        pod = self.pod
        on_card = pod.device.type == "cuda"
        sid_table = state.sid.cpu().numpy()
        active = state.active.cpu().numpy()
        C = pod.chunk
        stages = self._stage_slots()
        if self._gen is None:
            self._gen = self._fixed_batches()
        compute = torch.cuda.current_stream(pod.device) if on_card else None
        side = torch.cuda.Stream(pod.device) if on_card else None
        t_run = torch.cuda.Event(enable_timing=True) if on_card else None
        marks = []
        batches = items = padded = 0
        drop_unknown = drop_overflow = 0
        dev_drops = []  # device-route drop counts, read at the sync
        t0 = time.perf_counter()
        if on_card:
            t_run.record(compute)
        while max_batches is None or batches < max_batches:
            h0 = time.perf_counter()
            try:
                sids, X = next(self._gen)
            except StopIteration:
                self.exhausted = True
                if self.buffer is not None:
                    # buffer mode: a later run() must re-check the buffer
                    # (a handoff may inject relocated backlog after the
                    # stream closed); source mode keeps the spent
                    # generator (re-creating it would replay the source)
                    self._gen = None
                break
            h1 = time.perf_counter()
            stage = stages[batches % 2]
            if on_card and stage.used:
                stage.copied.synchronize()  # its pinned buffers are free
            host = stage.host
            if on_card:
                host["sids"].numpy()[...] = sids
                host["X"].numpy()[...] = X
            else:
                _, counts, unknown, overflow = host_route(
                    sid_table, active, sids, X, C,
                    out=host["chunks"].numpy())
                host["counts"].numpy()[...] = counts
                host["overflow"].numpy()[...] = overflow
                host["unknown"].numpy()[...] = unknown
                drop_unknown += int(unknown)
                drop_overflow += int(overflow.sum())
            mark = {"source_ms": (h1 - h0) * 1e3,
                    "stage_ms": (time.perf_counter() - h1) * 1e3}
            dev = stage.dev
            if on_card:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                with torch.cuda.stream(side):
                    if stage.used:
                        side.wait_event(stage.stepped)  # its device buffers
                    ev[0].record(side)
                    for k, t in host.items():
                        dev[k].copy_(t, non_blocking=True)
                    ev[1].record(side)
                    stage.copied.record(side)
                compute.wait_event(stage.copied)
                ev[2].record(compute)
            if on_card:
                routed = pod.route(state, dev["sids"], dev["X"])
                dev_drops.append((routed[2], routed[3].sum()))
            else:
                routed = (dev["chunks"], dev["counts"], dev["unknown"],
                          dev["overflow"])
            state, _ = pod.ingest_routed(state, *routed)
            if on_card:
                ev[3].record(compute)
                stage.stepped.record(compute)
                mark["events"] = ev
            stage.used = True
            marks.append(mark)
            # while the card runs this step, the next iteration stages the
            # following batch on the host and copies it on the side stream
            batches += 1
            n_pad = int((sids == PAD_SID).sum())
            items += len(sids) - n_pad
            padded += n_pad
        if on_card:
            torch.cuda.synchronize(pod.device)
        wall = time.perf_counter() - t0
        for unk, over in dev_drops:
            drop_unknown += int(unk)
            drop_overflow += int(over)
        if self.timings is not None:
            self.timings.extend(_stage_times(t_run, marks))
        # telemetry happens HERE and only here: the synchronize above is
        # the run's host-sync boundary (DESIGN.md §13)
        self._record_run(state, batches, items, padded, wall)
        stats = {"batches": batches, "items": items,
                 "padded": padded, "wall_s": wall,
                 "dropped_unknown": drop_unknown,
                 "dropped_overflow": drop_overflow}
        if self.on_sync is not None:
            # same sync boundary as the drain: everything this run
            # routed is in the pod state
            stats.update(self.on_sync(state) or {})
        if self._feed_exc is not None:
            exc, self._feed_exc = self._feed_exc, None
            raise RuntimeError(
                "ingest producer failed mid-stream (items already routed "
                "are in the pod state)") from exc
        return state, stats

    def _record_run(self, state, batches, items, padded, wall) -> None:
        """Flush one run()'s host-local tallies + the device ledgers into
        the metrics registry.  Host-only, post-sync."""
        reg = obs.get_registry(self.metrics)
        if not reg.enabled:
            return
        pod = str(self.pod_id)
        reg.counter("ingest_batches_total", "device batches dispatched",
                    ("pod",)).labels(pod=pod).inc(batches)
        reg.counter("ingest_items_total", "real (non-padding) items fed",
                    ("pod",)).labels(pod=pod).inc(items)
        reg.counter("ingest_padding_total",
                    "PAD_SID filler rows burned in partial batches",
                    ("pod",)).labels(pod=pod).inc(padded)
        reg.histogram("ingest_run_seconds", "wall time of run() calls",
                      ("pod",)).labels(pod=pod).observe(wall)
        obs.drain.drain_pod(state, pod=pod, registry=reg)
        if self.buffer is not None:
            obs.drain.drain_buffer(self.buffer, pod=pod, registry=reg)


def _stage_times(t_run, marks) -> List[dict]:
    """Per batch: the host's feed and staging ms and, on the card, the
    copy's and the step's (start, end) in ms from the run's first
    event."""
    out = []
    for m in marks:
        row = {"source_ms": m["source_ms"], "stage_ms": m["stage_ms"]}
        if "events" in m:
            ev = m["events"]
            row["h2d"] = (t_run.elapsed_time(ev[0]),
                          t_run.elapsed_time(ev[1]))
            row["step"] = (t_run.elapsed_time(ev[2]),
                           t_run.elapsed_time(ev[3]))
        out.append(row)
    return out


@dataclasses.dataclass
class PodRouter:
    """Fleet front-end: one tagged ingress, N pods, a host routing table.

    Each pod runs its own buffer-mode ``IngestPipeline``; the router owns
    the sid -> pod-id table and fans ``put`` batches out to the right
    pod's ``TaggedBuffer`` (per-session FIFO is preserved — a session's
    items all flow through one buffer at a time).  Items for sids with
    no table entry are counted in ``drops_unrouted`` per sid.

    The handoff protocol uses the two migration primitives:

      * ``quiesce(sids)`` — park the victims in their *current* pod's
        buffer (arrivals keep landing there, nothing drains, nothing is
        dropped);
      * ``migrate(sids, dst)`` — atomically flip the table and move the
        parked backlog into the target pod's buffer.  The router lock
        serializes this against ``put``, so per-session FIFO survives
        the handoff.
    """

    pipelines: Dict[int, IngestPipeline]

    def __post_init__(self):
        for pid, pipe in self.pipelines.items():
            if pipe.buffer is None:
                raise ValueError(
                    f"pod {pid}: PodRouter needs buffer-mode pipelines")
            pipe.pod_id = pid  # every pipe's metrics carry its fleet id
        self._table: Dict[int, int] = {}
        self._lock = make_lock("PodRouter._lock")
        self._feeders = []
        self.drops_unrouted: Dict[int, int] = {}

    # ------------------------------------------------------------- the table
    def assign(self, sids, pod_id: int) -> None:
        """Route ``sids`` to ``pod_id`` from now on (admission time)."""
        if pod_id not in self.pipelines:
            raise KeyError(f"unknown pod id {pod_id}")
        sids = np.asarray(sids).ravel()
        with obs.span("admit", layer="router", pod=str(pod_id),
                      sessions=len(sids)):
            with self._lock:
                for sid in sids:
                    self._table[int(sid)] = pod_id

    def unassign(self, sids) -> None:
        """Drop table entries (eviction time); later items count as
        unrouted."""
        sids = np.asarray(sids).ravel()
        with obs.span("evict", layer="router", sessions=len(sids)):
            with self._lock:
                for sid in sids:
                    self._table.pop(int(sid), None)

    def owner(self, sid: int) -> Optional[int]:
        with self._lock:
            return self._table.get(int(sid))

    def table(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._table)

    # ------------------------------------------------------------------ feed
    def put(self, sids, X, timeout: Optional[float] = None) -> None:
        """Fan one tagged batch out to the pods' buffers by table.

        The buffer writes happen OUTSIDE the router lock (a ``block``
        buffer may wait for space that only ``migrate`` frees, under this
        lock); rows that landed in a pod the table no longer points to
        are relocated to the new owner behind the migrated backlog, which
        keeps per-session FIFO.
        """
        sids = np.asarray(sids, np.int32).ravel()
        X = np.asarray(X, np.float32)
        with self._lock:
            dest = np.empty(len(sids), np.int64)
            for i, sid in enumerate(sids.tolist()):
                pid = self._table.get(sid, -1)
                dest[i] = pid
                if pid < 0:
                    self.drops_unrouted[sid] = \
                        self.drops_unrouted.get(sid, 0) + 1
        for pid in self.pipelines:
            m = dest == pid
            if not m.any():
                continue
            self.pipelines[pid].buffer.put(sids[m], X[m], timeout=timeout)
            with self._lock:  # repair: did a flip race the enqueue?
                stale = {sid for sid in set(sids[m].tolist())
                         if self._table.get(sid, pid) != pid}
                for sid in stale:
                    bs, bx = self.pipelines[pid].buffer.extract([sid])
                    if len(bs):
                        owner = self._table[sid]
                        self.pipelines[owner].buffer.inject(bs, bx)

    def feed_from(self, source: Source, *, close: bool = True,
                  put_timeout: Optional[float] = None) -> threading.Thread:
        """Producer thread: route ``source`` through the table; on
        exhaustion close every pod's buffer (end-of-stream fans out)."""

        def _run():
            try:
                for sids, X in source:
                    self.put(sids, X, timeout=put_timeout)
            except BaseException as e:
                for pipe in self.pipelines.values():
                    pipe._feed_exc = e  # surfaced by each pipe's run()
            finally:
                if close:
                    for pipe in self.pipelines.values():
                        pipe.buffer.close()

        t = threading.Thread(target=_run, daemon=True)
        t.start()
        self._feeders.append(t)
        return t

    # ------------------------------------------------------------- migration
    def quiesce(self, sids) -> None:
        """Park ``sids`` in their current pods' buffers (handoff step 1)."""
        with self._lock:
            for pid, group in self._by_pod(sids).items():
                self.pipelines[pid].buffer.quiesce(group)

    def release(self, sids) -> None:
        """Un-park ``sids`` in place (handoff aborted): their backlog
        resumes draining to the pod that already owns them."""
        with self._lock:
            for pid, group in self._by_pod(sids).items():
                self.pipelines[pid].buffer.release(group)

    def _by_pod(self, sids) -> Dict[int, list]:
        """{owner pod: [sid, ...]} of the routed ``sids`` (lock held)."""
        by_pod: Dict[int, list] = {}
        for sid in np.asarray(sids).ravel():
            pid = self._table.get(int(sid))
            if pid is not None:
                by_pod.setdefault(pid, []).append(int(sid))
        return by_pod

    def migrate(self, sids, dst: int) -> int:
        """Flip the table for ``sids`` and move their parked backlog to
        pod ``dst``'s buffer, atomically w.r.t. ``put``.  Returns the
        number of backlog items moved (zero dropped, by construction)."""
        if dst not in self.pipelines:
            raise KeyError(f"unknown pod id {dst}")
        moved = 0
        with self._lock:
            by_pod: Dict[int, list] = {}
            for sid in np.asarray(sids).ravel():
                pid = self._table.get(int(sid))
                if pid is not None and pid != dst:
                    by_pod.setdefault(pid, []).append(int(sid))
                self._table[int(sid)] = dst
            dst_buf = self.pipelines[dst].buffer
            for pid, group in by_pod.items():
                bs, bx = self.pipelines[pid].buffer.extract(group)
                if len(bs):
                    # inject, not put: the backlog was already admitted
                    # at the source — relocation must not block on the
                    # target's capacity or fail on a racing close
                    dst_buf.inject(bs, bx)
                    moved += len(bs)
        return moved
