# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Partitioned pub/sub front-end: many producers, offset logs, pod shards
(port of ``repro/ingest/pubsub.py``; host code, the same wire).

The last untrusted boundary of the serving stack.  ``SocketSource``
(one producer, one stream, no memory) assumes a polite producer;
production traffic is many producers that crash, reconnect and replay.
This module puts a partitioned, offset-addressed log between them and
the pod fleet:

    producers ──publish──▶ PubSubBroker (hash-partitioned offset logs)
       │  TCP (length-prefixed frames + seq handshake: PubSubListener)
       ▼
    PubSubFrontEnd.pump() ──▶ PodRouter.put ──▶ per-pod TaggedBuffer
                                                (rate limits + shed
    commit() at the pipeline's host-sync          ladder live here)
    boundary trims the logs

Pieces
------
* :class:`PubSubBroker` — N hash partitions (``partition_of``: a
  deterministic integer mix of the session id, so one session's items
  always land in one partition and per-session FIFO is free), each an
  append-only log with monotone offsets.  ``publish`` assigns offsets;
  ``read(partition, offset)`` replays from any retained offset;
  ``trim`` releases committed prefixes.

* :class:`PubSubListener` / :class:`Publisher` — the wire.  Framing is
  ``SocketSource``'s length-prefixed layout with a pub/sub header
  (magic, monotone per-producer ``seq``, N, d).  The handshake is the
  resume protocol: a (re)connecting producer says HELLO(producer_id),
  the listener answers ACK(last_seq it has durably published), and the
  producer replays exactly its frames after that — duplicates are
  detected by seq and skipped, gaps are protocol errors.  Every frame
  is ACKed after it lands in the broker, so a publisher prunes its
  replay window as it goes: exactly-once from producer to broker log.

* :class:`PubSubFrontEnd` — the consumer half.  ``pump()`` drains each
  partition from its position and fans the items to pod shards through
  ``PodRouter`` (single-threaded by design — one consumer per
  partition set, the Kafka consumer-group shape).  Offsets advance in
  two steps: *delivered* when handed to the shard buffers, *committed*
  at a host-sync boundary (``attach`` hooks ``commit()`` into
  ``IngestPipeline.run``'s final synchronize — DESIGN.md §13's
  "record at sync boundaries only" rule, which also makes it the spot
  where the pubsub gauges are recorded).  A restarted front-end
  constructed with ``start=committed()`` re-reads only what was never
  committed: at-least-once broker->pod, exactly-once producer->broker.

Overload never reaches this file: the per-pod ``TaggedBuffer`` applies
token-bucket rate limits and the watermark shed ladder
(``repro_torch.ingest.shedding`` — Bernoulli subsampling per 1802.07098,
Stream Clipper two-threshold clipping per 1606.00389) at admission, so
the broker log plus buffer capacity is the whole memory story.
"""
from __future__ import annotations

import collections
import socket
import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.concurrency import make_lock

from .sources import _as_tagged, _recv_exact

__all__ = ["partition_of", "PubSubBroker", "PubSubListener", "Publisher",
           "PubSubFrontEnd", "publish_frame", "MAGIC_PUB", "MAGIC_HELLO",
           "MAGIC_ACK"]

# ------------------------------------------------------------------ wire v2
# Little-endian, on top of SocketSource's length-prefixed framing idea:
#   HELLO  <IQ   (MAGIC_HELLO, producer_id)          producer -> listener
#   ACK    <IQ   (MAGIC_ACK, last_seq)               listener -> producer
#   PUB    <IQII (MAGIC_PUB, seq, N, d) + N*4 int32 sids + N*d*4 f32 X
# ``seq`` is per-producer, monotone from 1; the ACK after HELLO carries
# the last seq the broker holds (the resume point), the ACK after each
# PUB confirms that frame so the producer can prune its replay window.
MAGIC_PUB = 0x52505332  # "RPS2" — repro pub/sub v2 frames
MAGIC_HELLO = 0x52505348  # "RPSH"
MAGIC_ACK = 0x52505341  # "RPSA"
_PUB = struct.Struct("<IQII")
_HELLO = struct.Struct("<IQ")
_ACK = struct.Struct("<IQ")


def partition_of(sid: int, n_partitions: int) -> int:
    """Deterministic session-id -> partition hash (splitmix-style
    integer mix — stable across processes, unlike Python's ``hash``
    with randomization, and well-spread for sequential ids)."""
    x = (int(sid) * 0x9E3779B1) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x85EBCA77) & 0xFFFFFFFF
    x ^= x >> 13
    return x % n_partitions


class PubSubBroker:
    """Hash-partitioned, offset-addressed in-process log.

    Each partition is an append-only sequence of ``(sid, row)`` items;
    the offset of an item is its position in that sequence since the
    partition's creation (monotone, never reused).  ``retention``
    bounds the per-partition log length — when exceeded, the oldest
    *uncommitted* entries are evicted (counted in ``evicted``; a
    front-end that falls further behind than retention finds a gap and
    fails loudly in ``read`` rather than silently skipping).
    """

    def __init__(self, n_partitions: int = 8, *,
                 retention: Optional[int] = None):
        if n_partitions <= 0:
            raise ValueError(
                f"n_partitions must be positive, got {n_partitions}")
        if retention is not None and retention <= 0:
            raise ValueError(f"retention must be positive, got {retention}")
        self.n_partitions = n_partitions
        self.retention = retention
        self._logs: List[collections.deque] = [
            collections.deque() for _ in range(n_partitions)]
        self._base: List[int] = [0] * n_partitions  # offset of _logs[p][0]
        self._lock = make_lock("PubSubBroker._lock")
        self.evicted: List[int] = [0] * n_partitions  # retention evictions

    def partition(self, sid: int) -> int:
        return partition_of(sid, self.n_partitions)

    # -------------------------------------------------------------- publish
    def publish(self, sids, X) -> Dict[int, Tuple[int, int]]:
        """Append a tagged batch, each item to its sid's partition.
        Returns ``{partition: (first_offset, count)}`` for the touched
        partitions."""
        sids, X = _as_tagged(sids, X)
        placed: Dict[int, Tuple[int, int]] = {}
        with self._lock:
            for sid, row in zip(sids.tolist(), X):
                p = partition_of(sid, self.n_partitions)
                log = self._logs[p]
                off = self._base[p] + len(log)
                log.append((sid, row))
                if p not in placed:
                    placed[p] = (off, 1)
                else:
                    first, n = placed[p]
                    placed[p] = (first, n + 1)
                if self.retention is not None and len(log) > self.retention:
                    log.popleft()
                    self._base[p] += 1
                    self.evicted[p] += 1
        return placed

    # ---------------------------------------------------------------- read
    def high_water(self, partition: int) -> int:
        """Next offset ``publish`` will assign in ``partition``."""
        with self._lock:
            return self._base[partition] + len(self._logs[partition])

    def base(self, partition: int) -> int:
        """Oldest retained offset (reads below this raise)."""
        with self._lock:
            return self._base[partition]

    def read(self, partition: int, offset: int, max_items: int
             ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Read up to ``max_items`` items of ``partition`` starting at
        ``offset`` -> ``(sids, X, next_offset)``.  ``offset`` below the
        retained base means the consumer lost data to retention — that
        is a loud ``LookupError``, never a silent skip."""
        with self._lock:
            base = self._base[partition]
            log = self._logs[partition]
            if offset < base:
                raise LookupError(
                    f"partition {partition}: offset {offset} below retained "
                    f"base {base} — consumer outran retention "
                    f"({self.evicted[partition]} evicted)")
            lo = offset - base
            if lo >= len(log):
                return (np.empty((0,), np.int32),
                        np.empty((0, 0), np.float32), offset)
            items = [log[i] for i in range(lo, min(len(log),
                                                   lo + max_items))]
        sids = np.asarray([s for s, _ in items], np.int32)
        X = np.stack([r for _, r in items]).astype(np.float32)
        return sids, X, offset + len(items)

    def trim(self, partition: int, upto: int) -> int:
        """Release entries below offset ``upto`` (the commit edge);
        returns the number trimmed."""
        n = 0
        with self._lock:
            log = self._logs[partition]
            while log and self._base[partition] < upto:
                log.popleft()
                self._base[partition] += 1
                n += 1
        return n

    def depths(self) -> List[int]:
        """Retained items per partition (memory/lag signal)."""
        with self._lock:
            return [len(log) for log in self._logs]


# ------------------------------------------------------------------ the wire
def publish_frame(sock: socket.socket, seq: int, sids, X) -> None:
    """Write one PUB frame (no ACK wait — see :class:`Publisher`)."""
    sids, X = _as_tagged(sids, X)
    sock.sendall(_PUB.pack(MAGIC_PUB, seq, len(sids), X.shape[1])
                 + sids.astype("<i4").tobytes()
                 + X.astype("<f4").tobytes())


def _read_ack(sock: socket.socket) -> int:
    magic, last_seq = _ACK.unpack(_recv_exact(sock, _ACK.size))
    if magic != MAGIC_ACK:
        raise ValueError(f"bad ACK magic {magic:#010x} — is the consumer "
                         "speaking the pub/sub protocol?")
    return last_seq


class Publisher:
    """Producer half: exactly-once publishing over reconnects.

    Frames get monotone ``seq`` numbers and stay in a replay window
    until ACKed; ``connect()`` performs the HELLO/ACK resume handshake,
    prunes the window to what the listener already holds and re-sends
    the rest.  After a broken wire, call ``connect()`` again and keep
    publishing — the stream resumes exactly where the broker's log
    ends, no duplicates, no gaps (pinned by test).
    """

    def __init__(self, host: str, port: int, producer_id: int, *,
                 timeout: float = 30.0):
        self.host, self.port = host, port
        self.producer_id = int(producer_id)
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._next_seq = 1
        self._window: "collections.deque[Tuple[int, np.ndarray, np.ndarray]]" \
            = collections.deque()  # un-ACKed (seq, sids, X)
        self.reconnects = -1  # first connect() brings it to 0
        self.connect()

    # ------------------------------------------------------------- lifecycle
    def connect(self) -> int:
        """(Re)dial the listener, run the resume handshake, replay the
        un-ACKed window.  Returns the listener's last durable seq."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout)
        sock.settimeout(self.timeout)
        sock.sendall(_HELLO.pack(MAGIC_HELLO, self.producer_id))
        last_seq = _read_ack(sock)
        self._sock = sock
        self.reconnects += 1
        self._next_seq = max(self._next_seq, last_seq + 1)
        while self._window and self._window[0][0] <= last_seq:
            self._window.popleft()  # already durable at the broker
        for seq, sids, X in list(self._window):  # replay the rest, in order
            publish_frame(sock, seq, sids, X)
            if _read_ack(sock) != seq:
                raise ConnectionError("listener ACKed out of order during "
                                      "replay — desynced stream")
        return last_seq

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def __enter__(self) -> "Publisher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------------- publish
    def publish(self, sids, X) -> int:
        """Send one tagged batch; blocks for the ACK (so the replay
        window never grows beyond one in-flight frame).  Returns the
        frame's seq.  On a wire error the frame stays in the window —
        ``connect()`` replays it."""
        sids, X = _as_tagged(sids, X)
        seq = self._next_seq
        self._next_seq += 1
        self._window.append((seq, sids, X))
        publish_frame(self._sock, seq, sids, X)
        if _read_ack(self._sock) != seq:
            raise ConnectionError("listener ACKed out of order")
        self._window.popleft()
        return seq


class PubSubListener:
    """Consumer-side socket server: many producers -> one broker.

    Accepts any number of producer connections (one handler thread
    each), runs the HELLO/ACK resume handshake, deduplicates frames by
    per-producer seq (``duplicates`` counts what reconnect replays were
    already durable) and publishes the rest to the broker.  Every
    producer session is wrapped in a ``pubsub_producer`` span — connect
    churn is control-plane behavior worth a trace."""

    def __init__(self, broker: PubSubBroker, host: str = "127.0.0.1",
                 port: int = 0, *, timeout: float = 30.0,
                 max_frame_bytes: int = 256 * 1024 * 1024):
        self.broker = broker
        self.timeout = timeout
        self.max_frame_bytes = max_frame_bytes
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self._listener.settimeout(0.2)  # poll so close() can stop the loop
        self.host, self.port = self._listener.getsockname()[:2]
        self._lock = make_lock("PubSubListener._lock")
        self.last_seq: Dict[int, int] = {}  # producer_id -> durable seq
        self.duplicates = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def close(self) -> None:
        self._stop.set()
        self._listener.close()
        self._accept_thread.join(timeout=self.timeout)

    def __enter__(self) -> "PubSubListener":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------------- serve
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed
            conn.settimeout(self.timeout)
            t = threading.Thread(target=self._serve_producer, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_producer(self, conn: socket.socket) -> None:
        try:
            magic, pid = _HELLO.unpack(_recv_exact(conn, _HELLO.size))
            if magic != MAGIC_HELLO:
                raise ValueError(f"bad HELLO magic {magic:#010x}")
            with self._lock:
                durable = self.last_seq.get(pid, 0)
            with obs.span("pubsub_producer", producer=str(pid),
                          resume_seq=durable):
                conn.sendall(_ACK.pack(MAGIC_ACK, durable))
                self._frames_loop(conn, pid)
        except (ConnectionError, ValueError, socket.timeout, OSError):
            pass  # a broken producer wire is the producer's problem to
            #       retry; the seq handshake makes the retry exact
        finally:
            conn.close()

    def _frames_loop(self, conn: socket.socket, pid: int) -> None:
        while not self._stop.is_set():
            head = _recv_exact(conn, _PUB.size, allow_eof=True)
            if not head:
                return  # producer closed cleanly
            magic, seq, n, d = _PUB.unpack(head)
            if magic != MAGIC_PUB:
                raise ValueError(f"bad frame magic {magic:#010x}")
            frame_bytes = 4 * n + 4 * n * d
            if n == 0 or d == 0 or frame_bytes > self.max_frame_bytes:
                raise ValueError(
                    f"frame header announces N={n}, d={d} ({frame_bytes} "
                    f"bytes; cap {self.max_frame_bytes}) — corrupt or "
                    "desynced producer stream")
            sids = np.frombuffer(_recv_exact(conn, 4 * n),
                                 dtype="<i4").astype(np.int32)
            X = np.frombuffer(_recv_exact(conn, 4 * n * d), dtype="<f4"
                              ).astype(np.float32).reshape(n, d)
            with self._lock:
                durable = self.last_seq.get(pid, 0)
                fresh = seq > durable
                if fresh:
                    self.last_seq[pid] = seq
                else:
                    self.duplicates += 1
            if fresh:
                # outside the listener lock: publish takes the broker's
                self.broker.publish(sids, X)
            conn.sendall(_ACK.pack(MAGIC_ACK, seq if fresh else durable))


# ----------------------------------------------------------------- consumer
class PubSubFrontEnd:
    """Drain broker partitions into pod shards, offset-exactly.

    Single-consumer by design: ``pump()`` must not race itself (one
    front-end per partition set — scale by splitting partitions across
    front-ends, not by calling ``pump`` from two threads).  ``start``
    resumes from a previous front-end's ``committed()``; omitted
    partitions start at the broker's current base.
    """

    def __init__(self, broker: PubSubBroker, router, *,
                 read_batch: int = 256,
                 start: Optional[Dict[int, int]] = None,
                 metrics=None):
        self.broker = broker
        self.router = router
        self.read_batch = int(read_batch)
        self.metrics = metrics
        start = start or {}
        self._lock = make_lock("PubSubFrontEnd._lock")
        self._pos: Dict[int, int] = {
            p: start.get(p, broker.base(p))
            for p in range(broker.n_partitions)}
        self._committed: Dict[int, int] = dict(self._pos)
        self.delivered_items = 0  # lifetime, for the drain

    # ----------------------------------------------------------------- pump
    def pump(self, max_items: Optional[int] = None) -> int:
        """Deliver retained items from every partition position to the
        pod shards (via ``router.put``); returns items delivered.
        Delivered-but-uncommitted items re-deliver after a crash —
        commit happens at a host-sync boundary (:meth:`commit`)."""
        total = 0
        for p in range(self.broker.n_partitions):
            while max_items is None or total < max_items:
                with self._lock:
                    pos = self._pos[p]
                budget = self.read_batch if max_items is None else \
                    min(self.read_batch, max_items - total)
                sids, X, nxt = self.broker.read(p, pos, budget)
                if nxt == pos:
                    break  # partition drained
                # router.put outside our lock: a block-policy shard
                # buffer may wait, and position state must stay readable
                self.router.put(sids, X)
                with self._lock:
                    self._pos[p] = nxt
                total += len(sids)
        self.delivered_items += total
        return total

    # --------------------------------------------------------------- commit
    def commit(self) -> Dict[int, int]:
        """Mark everything delivered so far as committed and trim the
        broker logs behind it.  Called at host-sync boundaries only —
        ``attach()`` hooks it into ``IngestPipeline.run``'s final
        synchronize (its ``on_sync``), which also makes this the legal
        spot to record the pubsub metrics (DESIGN.md §13)."""
        with self._lock:
            delivered = dict(self._pos)
            self._committed = delivered
        with obs.span("pubsub_commit",
                      partitions=self.broker.n_partitions):
            for p, off in delivered.items():
                self.broker.trim(p, off)
        self._record()
        return delivered

    def committed(self) -> Dict[int, int]:
        """Partition -> committed offset; feed to a successor's
        ``start=`` to resume exactly."""
        with self._lock:
            return dict(self._committed)

    def positions(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._pos)

    def lag(self) -> int:
        """Published-but-undelivered items across partitions."""
        with self._lock:
            pos = dict(self._pos)
        return sum(self.broker.high_water(p) - off
                   for p, off in pos.items())

    def attach(self, pipeline) -> None:
        """Commit at ``pipeline``'s sync boundary: every
        ``IngestPipeline.run()`` ends with a synchronize and then calls
        its ``on_sync``, when the delivered items are in the pod state
        and the offsets may be durably committed.  The committed map is merged into the
        run's stats as ``pubsub_committed``."""
        pipeline.on_sync = lambda state: {"pubsub_committed": self.commit()}

    def _record(self) -> None:
        """Pubsub gauges/counters — called from ``commit`` only (a
        host-sync boundary; PL004/PL006 stay clean)."""
        reg = obs.get_registry(self.metrics)
        if not reg.enabled:
            return
        obs.drain.observe_total(
            "pubsub_delivered_total", {},
            self.delivered_items,
            help="items handed from broker partitions to pod shards",
            registry=reg)
        obs.drain.observe_total(
            "pubsub_evicted_total", {},
            sum(self.broker.evicted),
            help="items evicted by broker retention before delivery",
            registry=reg)
        reg.gauge("pubsub_lag_items",
                  "published-but-undelivered items", ()).set(self.lag())
        reg.gauge("pubsub_retained_items",
                  "items retained across broker partitions", ()).set(
            sum(self.broker.depths()))
