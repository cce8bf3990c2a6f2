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

    def dump_jsonl(self, path: str) -> Path:
        """Write every buffered event to ``path`` (the CI artifact)."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with self._lock:
            p.write_text("".join(
                json.dumps(e, sort_keys=True, default=str) + "\n"
                for e in self.events))
        return p

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


_RECORDER = SpanRecorder()


def get_recorder() -> SpanRecorder:
    return _RECORDER


def span(name: str, **attrs: object):
    """``with obs.span("handoff", src=0, dst=1) as sp:`` on the default
    recorder — the one the instrumented serving modules use."""
    return _RECORDER.span(name, **attrs)
