# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Structured spans for control-plane operations (port of
``repro/obs/spans.py``).

The serving stack's control plane — admission at the fleet front-end,
``evict_sids``, the quiesce -> snapshot -> restore -> flip phases of a
pod handoff, checkpoint save/restore, drift resets — is host code that
runs at human-auditable cadence.  Each operation is wrapped in a
``span``: a context manager that records name, wall duration, nesting
(parent span id, depth), an *outcome* and free-form attributes, and
emits one JSON line per completed span.

Outcome contract: ``ok`` by default; an exception escaping the body
records ``outcome="error"`` (with the exception type) and re-raises —
a failed handoff must leave a span saying so, never a hole in the
timeline.  Domain refusals set their own outcome explicitly
(``sp.set_outcome("refused")``): a refusal is not an error, but it is
an event.

Durations are *dispatch* durations: spans never call
``torch.cuda.synchronize`` — instrumenting must not add device syncs
(DESIGN.md §13).  Wrap a span around code that already syncs (a
handoff's host gather, ``pipeline.run``'s final synchronize) and the
duration is honest; wrap it around bare launches and it measures
enqueue time, which is what the control plane actually waits for.

Spans are host-only by construction: entering one while
``torch.compile`` traces is a no-op (``torch.compiler.is_compiling()``;
a span recorded at trace time would fire once per compile with a
meaningless duration, then never again).

Thread-safety: the span stack is thread-local (producer threads,
checkpoint writers and the serve loop each get their own nesting) and
event emission takes the recorder lock only to append/write.

Hot spans (``hot_span``) are the same recorder's second mode, for the
ingest path.  Off (the default) ``hot_span`` is one flag check that
returns one shared no-op context manager: no allocation, no clock, no
lock, no registry.  ``get_recorder().trace_hot(True)`` turns them on:
each hot span then appends (name, parent, batch, enter and exit times)
to its thread's bounded buffer, which counts what it drops
(:data:`MAX_HOT_RECORDS`), and writes nothing to the registry, does no
I/O and never synchronises the device.  ``hot_count`` keeps a number,
a device scalar or a function that makes one beside the spans.
``trace_hot(False)`` reads the counters (the one device sync) and
returns every record, also kept in ``hot_records`` for ``dump_jsonl``.  A root span's batch is how many
roots of its name opened before it in the trace (the n-th ``route`` is
batch n); a child takes its root's.  Hot spans read
``time.perf_counter_ns()``; ``trace_hot(True)`` takes one
(``perf_counter_ns``, ``time_ns``) pair, so each record's ``start_ns``
/ ``end_ns`` is in Unix nanoseconds, the clock of ``torch.profiler``'s
Kineto events.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from repro_torch.concurrency import make_lock

from .registry import get_registry

MAX_BUFFERED_EVENTS = 10_000  # ring bound: telemetry must not be a leak
MAX_HOT_RECORDS = 1 << 18  # a thread's hot spans in one trace; more drop


class Span:
    """Mutable handle the ``with`` body can annotate."""

    __slots__ = ("name", "span_id", "parent_id", "depth", "attrs", "outcome",
                 "_t0")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 depth: int, attrs: Dict[str, object],
                 t0: Optional[float] = None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.depth = depth
        self.attrs = attrs
        self.outcome = "ok"
        self._t0 = time.perf_counter() if t0 is None else t0

    def set_outcome(self, outcome: str) -> None:
        self.outcome = str(outcome)

    def set(self, **attrs: object) -> None:
        self.attrs.update(attrs)


class _NoSpan:
    """The one span ``hot_span`` returns while hot tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


class _HotBuffer:
    """One thread's hot spans and counters of one trace."""

    __slots__ = ("gen", "thread", "spans", "counters", "stack", "roots",
                 "dropped")

    def __init__(self, gen: int):
        self.gen = gen
        self.thread = threading.get_native_id()
        self.spans: List[list] = []  # [name, parent, batch, t0_ns, t1_ns]
        self.counters: List[tuple] = []  # (name, batch, value)
        self.stack: List[int] = []
        self.roots: Dict[str, int] = {}
        self.dropped = 0


class _HotSpan:
    """A hot span's name; the open records live on the thread's buffer,
    so one of these serves every thread and every entry."""

    __slots__ = ("rec", "name")

    def __init__(self, rec: "SpanRecorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        buf = self.rec._hot_buffer()
        spans, stack = buf.spans, buf.stack
        if len(spans) >= MAX_HOT_RECORDS:
            buf.dropped += 1
            stack.append(-1)
            return None
        parent = stack[-1] if stack else -1
        if parent >= 0:
            batch = spans[parent][2]
        else:
            batch = buf.roots.get(self.name, 0)
            buf.roots[self.name] = batch + 1
        stack.append(len(spans))
        spans.append([self.name, parent, batch, time.perf_counter_ns(), 0])
        return None

    def __exit__(self, *exc) -> bool:
        t = time.perf_counter_ns()
        buf = getattr(self.rec._local, "hot", None)
        if buf is not None and buf.stack:
            i = buf.stack.pop()
            if i >= 0:
                buf.spans[i][4] = t
        return False


class SpanRecorder:
    """Collects span events; optionally streams them as JSONL.

    ``path=None`` buffers in memory only (``events`` keeps the most
    recent :data:`MAX_BUFFERED_EVENTS`); ``dump_jsonl(path)`` writes
    the buffer out later — the CI artifact path.
    """

    def __init__(self, path: Optional[str] = None, registry=None):
        self.events: List[dict] = []
        self._path = Path(path) if path else None
        self._fh = None
        self._lock = make_lock("SpanRecorder._lock")
        self._local = threading.local()
        self._next_id = 0
        self._registry = registry
        self.hot = False  # hot tracing on (``trace_hot``)
        self.hot_records: List[dict] = []  # the last hot trace's records
        self.hot_dropped = 0  # hot spans its bounds dropped
        self._hot_gen = 0
        self._hot_buffers: List[_HotBuffer] = []
        self._hot_spans: Dict[str, _HotSpan] = {}
        self._hot_clock = (0, 0)  # (perf_counter_ns, time_ns) at its start

    # ------------------------------------------------------------- plumbing
    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def configure(self, path: Optional[str] = None, registry=None) -> None:
        with self._lock:
            if path is not None:
                if self._fh is not None:
                    self._fh.close()
                    self._fh = None
                self._path = Path(path)
            if registry is not None:
                self._registry = registry

    def _emit(self, event: dict) -> None:
        reg = get_registry(self._registry)
        reg.counter("spans_total", "completed control-plane spans",
                    ("name", "outcome")).labels(
            name=event["name"], outcome=event["outcome"]).inc()
        reg.histogram("span_seconds", "span wall durations",
                      ("name",)).labels(name=event["name"]).observe(
            event["dur_s"])
        with self._lock:
            self.events.append(event)
            if len(self.events) > MAX_BUFFERED_EVENTS:
                del self.events[: len(self.events) - MAX_BUFFERED_EVENTS]
            if self._path is not None:
                if self._fh is None:
                    self._path.parent.mkdir(parents=True, exist_ok=True)
                    self._fh = self._path.open("a")
                self._fh.write(json.dumps(event, sort_keys=True,
                                          default=str) + "\n")
                self._fh.flush()

    # ----------------------------------------------------------------- span
    @contextlib.contextmanager
    def span(self, name: str, **attrs: object):
        if torch.compiler.is_compiling():  # inside a torch.compile trace
            yield Span(name, -1, None, -1, dict(attrs), t0=0.0)
            return
        stack = self._stack()
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
        sp = Span(name, span_id, stack[-1] if stack else None,
                  len(stack), dict(attrs))
        stack.append(span_id)
        t_wall = time.time()
        try:
            yield sp
        except BaseException as e:
            sp.outcome = "error"
            sp.attrs.setdefault("error", type(e).__name__)
            raise
        finally:
            stack.pop()
            self._emit({
                "name": sp.name,
                "span_id": sp.span_id,
                "parent_id": sp.parent_id,
                "depth": sp.depth,
                "outcome": sp.outcome,
                "t_wall": round(t_wall, 6),
                "dur_s": round(time.perf_counter() - sp._t0, 9),
                "thread": threading.current_thread().name,
                "attrs": sp.attrs,
            })

    # ------------------------------------------------------------ hot spans
    def _hot_buffer(self) -> _HotBuffer:
        buf = getattr(self._local, "hot", None)
        if buf is None or buf.gen != self._hot_gen:
            buf = self._local.hot = _HotBuffer(self._hot_gen)
            with self._lock:
                self._hot_buffers.append(buf)
        return buf

    def hot_span(self, name: str):
        """A span of the ingest path (module docstring); the shared no-op
        while hot tracing is off or ``torch.compile`` traces."""
        if not self.hot or torch.compiler.is_compiling():
            return NO_SPAN
        sp = self._hot_spans.get(name)
        if sp is None:
            sp = self._hot_spans[name] = _HotSpan(self, name)
        return sp

    def hot_count(self, name: str, value) -> None:
        """Keep ``value`` under ``name`` in the innermost open hot span's
        batch: a number, a device scalar, or a function of no arguments
        that returns one, called when tracing stops."""
        if not self.hot:
            return
        buf = self._hot_buffer()
        batch = buf.spans[buf.stack[-1]][2] if buf.stack else -1
        buf.counters.append((name, batch, value))

    def trace_hot(self, on: bool = True) -> Optional[List[dict]]:
        """Turn hot tracing on (a fresh trace: earlier records go) or off.
        Off returns the trace's records (also kept in ``hot_records``):
        spans ``{"kind": "hot_span", "name", "path", "span_id",
        "parent_id", "depth", "batch", "thread", "start_ns", "end_ns"}``
        with Unix-nanosecond times, counters ``{"kind": "hot_counter",
        "name", "batch", "thread", "value"}``.  Turn it off while the
        traced threads are between spans."""
        with self._lock:
            if on:
                self._hot_gen += 1
                self._hot_buffers = []
                self.hot_records, self.hot_dropped = [], 0
                self._hot_clock = (time.perf_counter_ns(), time.time_ns())
                self.hot = True
                return None
            was, self.hot = self.hot, False
            buffers, self._hot_buffers = self._hot_buffers, []
        if not was:
            return list(self.hot_records)
        records = _export(buffers, self._hot_clock, time.perf_counter_ns())
        with self._lock:
            self.hot_records = records
            self.hot_dropped = sum(b.dropped for b in buffers)
        return list(records)

    # ------------------------------------------------------------ inspection
    def find(self, name: Optional[str] = None,
             outcome: Optional[str] = None) -> List[dict]:
        with self._lock:
            return [e for e in self.events
                    if (name is None or e["name"] == name)
                    and (outcome is None or e["outcome"] == outcome)]

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self.hot_records = []

    def dump_jsonl(self, path: str) -> Path:
        """Write every buffered event, then the last hot trace's records,
        to ``path`` (the CI artifact)."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with self._lock:
            p.write_text("".join(
                json.dumps(e, sort_keys=True, default=str) + "\n"
                for e in self.events + self.hot_records))
        return p

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def _export(buffers: List[_HotBuffer], clock: tuple, t_end: int
            ) -> List[dict]:
    """The buffers' records as dicts on the Unix clock; device counters
    read with one copy to the host per dtype and device."""
    shift = clock[1] - clock[0]
    out, counters, base = [], [], 0
    for buf in buffers:
        paths, depths = [], []
        for i, (name, parent, batch, t0, t1) in enumerate(buf.spans):
            top = parent < 0
            paths.append(name if top else paths[parent] + "/" + name)
            depths.append(0 if top else depths[parent] + 1)
            out.append({"kind": "hot_span", "name": name, "path": paths[i],
                        "span_id": base + i,
                        "parent_id": None if top else base + parent,
                        "depth": depths[i], "batch": batch,
                        "thread": buf.thread, "start_ns": t0 + shift,
                        "end_ns": (t1 or t_end) + shift})
        base += len(buf.spans)
        counters += [(name, batch, buf.thread, v)
                     for name, batch, v in buf.counters]
        if buf.dropped:
            counters.append(("hot_spans_dropped", -1, buf.thread,
                             buf.dropped))
    values = [v() if callable(v) else v for *_, v in counters]
    groups: Dict[tuple, List[int]] = {}
    for k, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            groups.setdefault((v.device, v.dtype), []).append(k)
    for ks in groups.values():
        read = torch.stack([values[k].reshape(()) for k in ks]).tolist()
        for k, v in zip(ks, read):
            values[k] = v
    out += [{"kind": "hot_counter", "name": name, "batch": batch,
             "thread": thread, "value": v}
            for (name, batch, thread, _), v in zip(counters, values)]
    return out


_RECORDER = SpanRecorder()


def get_recorder() -> SpanRecorder:
    return _RECORDER


def span(name: str, **attrs: object):
    """``with obs.span("handoff", src=0, dst=1) as sp:`` on the default
    recorder — the one the instrumented serving modules use."""
    return _RECORDER.span(name, **attrs)


def hot_span(name: str):
    """``with obs.hot_span("route"):`` on the default recorder: one flag
    check while hot tracing is off (module docstring)."""
    if not _RECORDER.hot:
        return NO_SPAN
    return _RECORDER.hot_span(name)


def hot_count(name: str, value) -> None:
    """``obs.hot_count("pod_step_passes", fn)`` on the default recorder
    (``SpanRecorder.hot_count``)."""
    if _RECORDER.hot:
        _RECORDER.hot_count(name, value)


def hot_tracing() -> bool:
    """Whether the default recorder keeps hot spans and counters now."""
    return _RECORDER.hot
