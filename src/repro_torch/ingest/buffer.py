# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Bounded tagged buffer between producers and the pod's ingest loop (port of
``repro/ingest/buffer.py``).

The decoupling point of the ingest subsystem: producer threads (a socket
reader, a generator feeder) ``put`` tagged items in, the pipeline
``get``s fixed-size device batches out.  Because the stream is
unbounded and the device rate is finite, the buffer must answer the
only question that matters under overload — *who loses data, and is it
counted?* — which is Stream Clipper's (Zhou, 1606.00389) drop/defer
framing:

  * ``block``        defer: the producer waits for room (lossless; the
                     right policy when the producer can be paused —
                     e.g. a local generator);
  * ``drop-newest``  clip the arriving item (the classic admission
                     bound: what is in the buffer is older and already
                     paid for);
  * ``drop-oldest``  clip from the *longest* session queue's head (the
                     freshest view wins; heavy tenants lose first, so
                     one noisy stream cannot starve the quiet ones).

Drops are counted **per session** — under summarization, losing items
is semantically fine (the algorithms subsample by design) but losing
them *silently and unevenly* is not.

Ahead of the capacity wall sit two admission policies (``repro_torch.
ingest.shedding``): an optional per-session token-bucket ``rate_limit``
(items a hot producer sends beyond its budget are *throttled*) and an
optional ``shed`` watermark ladder that escalates admit-all ->
Bernoulli subsampling (1802.07098) -> Stream Clipper-style
two-threshold clipping (1606.00389) as fill crosses watermarks.  Their
ledgers (``throttled``, ``sheds``, per-policy shed counts) are kept
strictly separate from the overflow ``drops`` ledger: a shed is a
*policy* outcome with a stated guarantee, an overflow drop is the
accident the policies exist to prevent — ``drops_total{layer,reason}``
stays truthful because the two never mix (``total_drops()`` counts
overflow only; ``total_sheds()``/``total_throttled()`` the rest).

Fairness: items live in per-session FIFO queues; ``get`` drains them
round-robin, one item per live session per turn.  Per-session order is
therefore preserved end-to-end (the pod's routing contract); global
interleaving is deliberately NOT preserved — that is the fairness.

Quiesce (the autoscaler's handoff primitive, DESIGN.md §10): a session
marked ``quiesce``d keeps *receiving* items but ``get`` stops draining
it — its backlog parks in the buffer, uncounted as dropped, until
``release`` (resume draining here) or ``extract`` (hand the backlog to
another pod's buffer, FIFO intact).  The drop-oldest policy spares
quiesced queues while any other queue can pay instead: clipping a
session mid-migration would silently violate the handoff's
zero-drop contract.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.concurrency import make_lock

from .shedding import RateLimit, ShedPolicy, TokenBucket

POLICIES = ("block", "drop-newest", "drop-oldest")
PAD_SID = -1  # the pod's queue-padding sentinel


class TaggedBuffer:
    """Bounded, thread-safe, per-session-fair tagged item buffer.

    ``rate_limit`` installs a default per-session token bucket
    (override per sid via :meth:`set_rate_limit`); ``shed`` installs
    the watermark shedding ladder; ``clock`` injects time for the
    buckets (tests pin it — production uses ``time.monotonic``).
    """

    def __init__(self, capacity: int, policy: str = "block", *,
                 rate_limit: Optional[RateLimit] = None,
                 shed: Optional[ShedPolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        self.capacity = capacity
        self.policy = policy
        self.rate_limit = rate_limit
        self.shed = shed
        self._clock = clock
        self._q: "collections.OrderedDict[int, collections.deque]" = \
            collections.OrderedDict()  # sid -> FIFO of (d,) float32 rows
        self._size = 0
        self._quiesced: set = set()  # sids parked: fed, never drained
        self._closed = False
        self._lock = make_lock("TaggedBuffer._lock")
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self.drops: Dict[int, int] = {}  # sid -> items clipped (overflow)
        # the admission-policy ledgers — deliberate, per-policy losses,
        # NEVER mixed into ``drops`` (see module docstring)
        self.sheds: Dict[int, int] = {}  # sid -> items shed by the ladder
        self.throttled: Dict[int, int] = {}  # sid -> items rate-limited
        self._shed_by_policy: Dict[str, int] = {}  # rung -> items shed
        self._rung = "admit"
        self._rung_changes = 0
        self._buckets: Dict[int, TokenBucket] = {}
        self._rate_overrides: Dict[int, RateLimit] = {}

    # ------------------------------------------------------------- properties
    @property
    def size(self) -> int:
        with self._lock:
            return self._size

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def drop_counts(self) -> Dict[int, int]:
        with self._lock:
            return dict(self.drops)

    def total_drops(self) -> int:
        """Lifetime items clipped by the *overflow* policy, all
        sessions — monotone by construction (``drops`` only ever
        grows), so the telemetry drain
        (``repro_torch.obs.drain.drain_buffer``) can snapshot it as a counter
        without per-call bookkeeping.  Deliberate losses (shed-ladder
        sheds, rate-limit throttles) are NOT included — they have their
        own ledgers (``total_sheds``/``total_throttled``) and their own
        metric families, so ``drops_total{layer="buffer",
        reason="clipped"}`` keeps meaning what it always meant."""
        with self._lock:
            return sum(self.drops.values())

    def shed_counts(self) -> Dict[int, int]:
        with self._lock:
            return dict(self.sheds)

    def total_sheds(self) -> int:
        """Lifetime items shed by the watermark ladder (all rungs)."""
        with self._lock:
            return sum(self.sheds.values())

    def shed_policy_counts(self) -> Dict[str, int]:
        """Lifetime sheds by ladder rung (``subsample`` / ``clip``) —
        the ``shed_total{policy,...}`` drain source."""
        with self._lock:
            return dict(self._shed_by_policy)

    def throttled_counts(self) -> Dict[int, int]:
        with self._lock:
            return dict(self.throttled)

    def total_throttled(self) -> int:
        """Lifetime items refused by per-session token buckets."""
        with self._lock:
            return sum(self.throttled.values())

    def shed_rung(self) -> str:
        """The ladder rung the last admission decision ran under
        (``admit`` when no shed policy is installed)."""
        with self._lock:
            return self._rung

    def shed_rung_changes(self) -> int:
        """Lifetime rung transitions — escalations are control-plane
        events worth a counter, not one span per item."""
        with self._lock:
            return self._rung_changes

    def set_rate_limit(self, sid: int, limit: Optional[RateLimit]) -> None:
        """Override the default ``rate_limit`` for one session
        (``None`` = unlimited for that session, whatever the default)."""
        with self._lock:
            self._rate_overrides[int(sid)] = limit
            self._buckets.pop(int(sid), None)  # re-built at next put

    def depths(self) -> Dict[int, int]:
        """Per-session queue depth — the autoscaler's load signal (and
        the ``largest-queue`` victim policy's ranking key)."""
        with self._lock:
            return {sid: len(dq) for sid, dq in self._q.items()}

    def quiesced(self) -> set:
        with self._lock:
            return set(self._quiesced)

    def _avail(self) -> int:
        """Drainable items (excludes quiesced sessions' backlogs)."""
        return self._size - sum(
            len(self._q[s]) for s in self._quiesced if s in self._q)

    # ---------------------------------------------------------------- quiesce
    def quiesce(self, sids) -> None:
        """Park ``sids``: ``put`` keeps feeding their queues, ``get``
        stops draining them.  Step 1 of a pod handoff — the victims'
        items buffer here, none dropped, while their summary rows move."""
        with self._lock:
            self._quiesced.update(int(s) for s in np.asarray(sids).ravel())

    def release(self, sids) -> None:
        """Un-park ``sids``; their backlog drains again from here."""
        with self._lock:
            self._quiesced.difference_update(
                int(s) for s in np.asarray(sids).ravel())
            self._not_empty.notify_all()

    def inject(self, sids, rows) -> None:
        """Enqueue relocated items, bypassing capacity and closed checks.

        The migration counterpart of ``extract``: a handoff's parked
        backlog was already admitted (and counted against a buffer's
        capacity) at the source pod — re-admitting it at the target
        must neither block, drop, nor fail because the stream happened
        to close mid-handoff.  Not for producers; ``put`` is."""
        with self._lock:
            for sid, row in zip(
                    (int(s) for s in np.asarray(sids).ravel()), rows):
                self._q.setdefault(sid, collections.deque()).append(
                    np.asarray(row, np.float32))
                self._size += 1
            self._not_empty.notify_all()

    def extract(self, sids) -> Tuple[np.ndarray, list]:
        """Atomically remove and return every buffered item of ``sids``
        (per-session FIFO order) — the backlog-migration half of
        ``release``: the caller forwards it to the target pod's buffer.
        Also un-parks the sids here.  -> (sids (M,), [rows])."""
        out_s: list = []
        out_x: list = []
        with self._lock:
            for sid in (int(s) for s in np.asarray(sids).ravel()):
                self._quiesced.discard(sid)
                dq = self._q.pop(sid, None)
                if dq:
                    out_s.extend([sid] * len(dq))
                    out_x.extend(dq)
                    self._size -= len(dq)
            if out_s:
                self._not_full.notify_all()
        return np.asarray(out_s, np.int32), out_x

    # --------------------------------------------------------------- producer
    def _admit_rate(self, sid: int, now: float) -> bool:
        """Token-bucket check for one arriving item (under the lock)."""
        limit = self._rate_overrides.get(sid, self.rate_limit)
        if limit is None:
            return True
        bucket = self._buckets.get(sid)
        if bucket is None:
            bucket = self._buckets[sid] = TokenBucket(limit, now)
        return bucket.allow(now)

    def _admit_shed(self, sid: int) -> bool:
        """Watermark-ladder check for one arriving item (under the
        lock); counts the shed and the rung transition if any."""
        ok, rung = self.shed.decide(
            size=self._size, capacity=self.capacity,
            depth=len(self._q[sid]) if sid in self._q else 0,
            n_live=len(self._q))
        if rung != self._rung:
            self._rung = rung
            self._rung_changes += 1
        if not ok:
            self.sheds[sid] = self.sheds.get(sid, 0) + 1
            self._shed_by_policy[rung] = \
                self._shed_by_policy.get(rung, 0) + 1
        return ok

    def put(self, sids, X, timeout: Optional[float] = None) -> int:
        """Enqueue a tagged batch; returns the number of items *not*
        admitted (rate-limit throttles + ladder sheds + overflow drops
        — each counted in its own ledger).

        Admission order per item: token bucket (throttle), shed ladder
        (policy shed), then capacity.  ``block`` waits for room
        (``timeout`` seconds per stalled item, None = forever) and
        raises ``TimeoutError`` on expiry; the drop policies never
        wait.  Raises ``ValueError`` after ``close()``.
        """
        sids = np.asarray(sids, np.int32).ravel()
        X = np.asarray(X, np.float32)
        dropped = 0
        now = self._clock() if self.rate_limit or self._rate_overrides \
            else 0.0
        with self._lock:
            for sid, row in zip(sids.tolist(), X):
                if self._closed:
                    raise ValueError("put() on a closed TaggedBuffer")
                if not self._admit_rate(sid, now):
                    self.throttled[sid] = self.throttled.get(sid, 0) + 1
                    dropped += 1
                    continue
                if self.shed is not None and not self._admit_shed(sid):
                    dropped += 1
                    continue
                if self._size >= self.capacity:
                    if self.policy == "block":
                        if not self._not_full.wait_for(
                                lambda: self._size < self.capacity
                                or self._closed, timeout):
                            raise TimeoutError(
                                f"TaggedBuffer full ({self.capacity}) for "
                                f"{timeout}s")
                        if self._closed:
                            raise ValueError("put() on a closed TaggedBuffer")
                    elif self.policy == "drop-newest":
                        self.drops[sid] = self.drops.get(sid, 0) + 1
                        dropped += 1
                        continue
                    else:  # drop-oldest: clip the longest queue's head
                        # quiesced sessions are mid-migration: clipping
                        # them breaks the handoff's zero-drop contract,
                        # so they only pay when no one else can
                        pool = [s for s in self._q if s not in
                                self._quiesced] or list(self._q)
                        victim = max(pool, key=lambda s: len(self._q[s]))
                        self._q[victim].popleft()
                        if not self._q[victim]:
                            del self._q[victim]
                        self._size -= 1
                        self.drops[victim] = self.drops.get(victim, 0) + 1
                        dropped += 1
                self._q.setdefault(sid, collections.deque()).append(row)
                self._size += 1
                self._not_empty.notify_all()  # waiters may need min_items
        return dropped

    def close(self) -> None:
        """End-of-stream: wake every waiter; ``get`` drains what is left."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    # --------------------------------------------------------------- consumer
    def get(self, max_items: int, *, pad_to: Optional[int] = None,
            timeout: Optional[float] = None, d: Optional[int] = None,
            min_items: int = 1
            ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Dequeue up to ``max_items`` items, round-robin across sessions.

        Blocks until at least ``min_items`` are available (or the buffer
        is closed — then drains what is left, however little, and
        finally returns ``None``, the end-of-stream sentinel).  A
        ``min_items`` near the device batch size keeps a fast consumer
        from burning full pod steps on near-all-padding batches when
        the producer trickles; the default of 1 favors latency.
        ``timeout`` raises ``TimeoutError`` on an open-but-underfilled
        buffer.  ``pad_to`` right-pads the batch with (PAD_SID,
        zero-row) entries to a fixed length — the pipeline's fixed
        device batch (``d`` sizes the zero rows when the batch
        itself is empty).
        """
        need = max(1, min(min_items, max_items))
        with self._lock:
            # quiesced backlogs are invisible here: they neither satisfy
            # the fill threshold nor drain (they belong to a migrating
            # session and leave via extract/release)
            if not self._not_empty.wait_for(
                    lambda: self._avail() >= need or self._closed, timeout):
                raise TimeoutError(
                    f"TaggedBuffer below {need} items for {timeout}s")
            if self._avail() == 0:  # closed and drained (of drainables)
                return None
            out_s, out_x = [], []
            while len(out_s) < max_items and self._q:
                # one item per live session per round — the fairness turn
                took = 0
                for sid in list(self._q):
                    if len(out_s) >= max_items:
                        break
                    if sid in self._quiesced:
                        continue
                    dq = self._q[sid]
                    out_s.append(sid)
                    out_x.append(dq.popleft())
                    took += 1
                    if not dq:
                        del self._q[sid]
                if not took:  # only quiesced queues remain
                    break
            self._size -= len(out_s)
            self._not_full.notify_all()
        sids = np.asarray(out_s, np.int32)
        X = np.stack(out_x).astype(np.float32)
        if pad_to is not None and len(sids) < pad_to:
            n_pad = pad_to - len(sids)
            width = X.shape[1] if X.size else d
            if width is None:
                raise ValueError("empty batch needs ``d`` to size padding")
            sids = np.concatenate(
                [sids, np.full((n_pad,), PAD_SID, np.int32)])
            X = np.concatenate([X, np.zeros((n_pad, width), np.float32)])
        return sids, X
