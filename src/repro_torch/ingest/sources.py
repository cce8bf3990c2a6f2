# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Tagged-stream sources: where the pod's ingest queue comes from (port of
``repro/ingest/sources.py``).

A *source* is anything that yields tagged host batches

    (sids (N,) int32, X (N, d) float32)      — numpy, host-resident

— the wire format of the SummarizerPod's ingest queue, kept on host
because the whole point of the ingest subsystem is to do the per-item
work (generation, thinning, framing, routing) off the device's critical
path and ship only routed fixed-shape chunk buffers down.  Batches may
be ragged (N varies per batch); the pipeline repacks them into the
fixed device batch size, so a source never worries about shapes.

Four implementations cover the serving regimes:

  * ``ReplaySource``    — in-memory arrays or ``.npy`` files, sliced
                          into batches (benchmarks, tests, backfills);
  * ``DriftSource``     — synthetic concept drift via
                          ``data.streams.session_stream`` (per-tenant
                          mixtures, drifting means — the stream51
                          regime, tagged);
  * ``SubsampleSource`` — Bernoulli thinning of any inner source: "Do
                          Less, Get More" (Feldman et al., 1802.07098)
                          shows a uniformly subsampled stream preserves
                          the submodular maximization guarantee in
                          expectation, which makes the sampling rate a
                          first-class throughput lever;
  * ``SocketSource``    — length-prefixed binary frames over TCP, so an
                          external producer process can feed a live pod
                          (``send_frame``/``connect_producer`` are the
                          producer half).
"""
from __future__ import annotations

import dataclasses
import itertools
import socket
import struct
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

TaggedBatch = Tuple[np.ndarray, np.ndarray]  # (sids (N,), X (N, d))


class Source:
    """Protocol: iterate tagged host batches.  Subclasses implement
    ``batches()``; iteration order IS stream order — every source must
    preserve per-session FIFO (the pod's routing contract)."""

    def batches(self) -> Iterator[TaggedBatch]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[TaggedBatch]:
        return self.batches()


def _as_tagged(sids, X) -> TaggedBatch:
    sids = np.asarray(sids, np.int32).ravel()
    X = np.asarray(X, np.float32)
    if X.ndim != 2 or len(sids) != len(X):
        raise ValueError(f"tagged batch shapes disagree: sids {sids.shape}, "
                         f"X {X.shape}")
    return sids, X


@dataclasses.dataclass
class ReplaySource(Source):
    """Replay in-memory arrays (or ``.npy`` files) as a tagged stream.

    ``sids``/``X`` may be arrays or paths; ``batch`` slices them into
    batches of that many items (the last one ragged).  Finite — the
    natural source for benchmarks (a pre-materialized feed replayed
    identically down two execution paths) and backfills.
    """

    sids: np.ndarray | str | Path
    X: np.ndarray | str | Path
    batch: int = 256

    def __post_init__(self):
        if isinstance(self.sids, (str, Path)):
            self.sids = np.load(self.sids)
        if isinstance(self.X, (str, Path)):
            self.X = np.load(self.X)
        self.sids, self.X = _as_tagged(self.sids, self.X)
        if self.batch <= 0:
            raise ValueError(f"batch must be positive, got {self.batch}")

    @classmethod
    def from_batches(cls, feed: Sequence[TaggedBatch]) -> "ReplaySource":
        """Concatenate a list of (sids, X) batches into one replay;
        batch size = the first batch's length (ragged feeds re-batch)."""
        sids = np.concatenate([np.asarray(s, np.int32) for s, _ in feed])
        X = np.concatenate([np.asarray(x, np.float32) for _, x in feed])
        return cls(sids=sids, X=X, batch=max(len(feed[0][0]), 1))

    def batches(self) -> Iterator[TaggedBatch]:
        for lo in range(0, len(self.sids), self.batch):
            hi = lo + self.batch
            yield self.sids[lo:hi], self.X[lo:hi]


@dataclasses.dataclass
class DriftSource(Source):
    """Tagged multi-tenant stream with per-tenant concept drift.

    A thin adapter over ``data.streams.session_stream`` (the generators
    stay the single source of truth for the paper's stream regimes):
    ``n_sessions`` tenants, each with a private mixture whose means
    random-walk by ``drift_per_batch`` per batch.  ``n_batches`` bounds
    the stream (None = infinite — callers bound via the pipeline's
    ``max_batches``).
    """

    seed: int
    n_sessions: int
    batch: int
    d: int = 16
    n_components: int = 8
    spread: float = 4.0
    noise: float = 0.5
    drift_per_batch: float = 0.0
    session_ids: Optional[np.ndarray] = None
    n_batches: Optional[int] = None

    def batches(self) -> Iterator[TaggedBatch]:
        from repro_torch.data.streams import MixtureSpec, session_stream

        spec = MixtureSpec(n_components=self.n_components, d=self.d,
                           spread=self.spread, noise=self.noise)
        gen = session_stream(self.seed, spec, self.n_sessions, self.batch,
                             drift_per_batch=self.drift_per_batch,
                             session_ids=self.session_ids, as_numpy=True)
        if self.n_batches is not None:
            # islice stops *before* drawing batch n_batches+1 — a bounded
            # replay must not generate-and-discard an extra batch
            gen = itertools.islice(gen, self.n_batches)
        yield from gen


@dataclasses.dataclass
class SubsampleSource(Source):
    """Bernoulli-thin an inner source: keep each item independently with
    probability ``rate`` (Feldman et al., 1802.07098 — subsampling as a
    throughput knob that preserves the guarantee in expectation).

    Thinned batches are ragged; empty ones are elided.  Per-session
    order is preserved (thinning is a monotone subsequence filter).
    Deterministic in ``seed``.
    """

    inner: Source
    rate: float
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")

    def batches(self) -> Iterator[TaggedBatch]:
        rng = np.random.default_rng(self.seed)
        for sids, X in self.inner:
            if self.rate >= 1.0:
                yield sids, X
                continue
            keep = rng.random(len(sids)) < self.rate
            if keep.any():
                yield sids[keep], X[keep]


# --------------------------------------------------------------------- socket
# Wire format (little-endian): one frame per tagged batch —
#   header  <III  = (MAGIC, N, d)
#   payload N*4 bytes int32 sids, then N*d*4 bytes float32 X
# The producer closes the connection to end the stream; an N=0 frame is a
# keepalive and yields nothing.
MAGIC = 0x52504931  # "RPI1" — repro ingest v1
_HEADER = struct.Struct("<III")


def send_frame(sock: socket.socket, sids, X) -> None:
    """Producer half: write one tagged batch as a wire frame."""
    sids, X = _as_tagged(sids, X)
    d = X.shape[1]
    sock.sendall(_HEADER.pack(MAGIC, len(sids), d)
                 + sids.astype("<i4").tobytes()
                 + X.astype("<f4").tobytes())


def connect_producer(host: str, port: int, *,
                     timeout: float = 30.0) -> socket.socket:
    """Dial a listening ``SocketSource``; returns the connected socket
    (use with ``send_frame``; ``close()`` ends the stream)."""
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(timeout)
    return sock


def _recv_exact(conn: socket.socket, n: int, *,
                allow_eof: bool = False) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            if allow_eof and not buf:
                return b""  # clean EOF at a frame boundary
            raise ConnectionError(
                f"stream truncated mid-frame ({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


class SocketSource(Source):
    """Listen for one external producer and stream its frames.

    The pod side binds ``host:port`` immediately (``port=0`` lets the OS
    pick — read it back from ``.port``), accepts a single producer
    connection, and yields one tagged batch per frame until the producer
    closes.  Every blocking socket operation carries ``timeout`` seconds
    — a dead producer (or a CI job with no producer at all) surfaces as
    ``socket.timeout`` (a ``TimeoutError`` subclass), never a hang.

    ``max_frame_bytes`` bounds the payload a single header may announce
    (default 256 MB): a corrupt or desynced header must surface as a
    protocol error, not as a multi-GB allocation that OOMs the pod.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 timeout: float = 30.0,
                 max_frame_bytes: int = 256 * 1024 * 1024):
        self.timeout = timeout
        self.max_frame_bytes = max_frame_bytes
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(1)
        self._listener.settimeout(timeout)
        self.host, self.port = self._listener.getsockname()[:2]

    def close(self) -> None:
        self._listener.close()

    def __enter__(self) -> "SocketSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def batches(self) -> Iterator[TaggedBatch]:
        conn, _ = self._listener.accept()
        conn.settimeout(self.timeout)
        try:
            while True:
                head = _recv_exact(conn, _HEADER.size, allow_eof=True)
                if not head:
                    return  # producer closed cleanly
                magic, n, d = _HEADER.unpack(head)
                if magic != MAGIC:
                    raise ValueError(
                        f"bad frame magic {magic:#010x} (want {MAGIC:#010x})"
                        " — is the producer speaking the ingest protocol?")
                if n == 0:
                    continue  # keepalive
                frame_bytes = 4 * n + 4 * n * d
                if d == 0 or frame_bytes > self.max_frame_bytes:
                    raise ValueError(
                        f"frame header announces N={n}, d={d} "
                        f"({frame_bytes} bytes; cap "
                        f"{self.max_frame_bytes}) — corrupt or desynced "
                        "producer stream")
                sids = np.frombuffer(
                    _recv_exact(conn, 4 * n), dtype="<i4").astype(np.int32)
                X = np.frombuffer(
                    _recv_exact(conn, 4 * n * d), dtype="<f4"
                ).astype(np.float32).reshape(n, d)
                yield sids, X
        finally:
            conn.close()
