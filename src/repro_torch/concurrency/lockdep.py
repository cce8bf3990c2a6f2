# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Runtime lock-order sanitizer ("lockdep", after the kernel facility) (port of
``repro/concurrency/lockdep.py``).

The static half (tools/podlint, PL007/PL008) predicts the repo's
acquired-before graph from source; this module *observes* it while the
code runs.  Every lock built through :func:`make_lock` under
``REPRO_LOCKDEP=1`` records, at each blocking acquire, one edge
``held -> acquiring`` per lock currently held by the thread — into one
process-global graph keyed by lock *name* (class granularity:
``"TaggedBuffer._lock"``), not instance.  Before the underlying
acquire can block, the new edge is checked against the graph: if the
acquiring name already reaches a held name, two call paths take these
locks in opposite orders and :class:`LockOrderError` is raised with
both witness stacks — on the *first* inversion ever executed, whether
or not the adverse interleaving happened this run.  Without the env
flag the factories return plain :mod:`threading` locks; the sanitizer
costs nothing in production.

Conventions (same as the kernel's lockdep):

- Name granularity: nesting two *instances* of the same name is an
  inversion (a self-edge) — there is no instance-order the analyser
  could verify.
- Non-blocking acquires (``acquire(False)``, used by
  ``Condition._is_owned``'s probe) neither record nor check: a trylock
  cannot deadlock.
- ``Condition(make_lock(...))`` works: the wrapper exposes
  ``acquire``/``release``/``_is_owned``, so ``wait()`` releases through
  the wrapper (popping the held stack) and the re-acquire is checked
  like any other.

tests/test_lockdep.py asserts the contract, and — the point of the
whole exercise — that every edge observed here is present in the
static graph (observed ⊆ predicted).
"""
from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple, Union

__all__ = [
    "LockOrderError", "LockdepLock", "LockdepRLock", "make_lock",
    "make_rlock", "enabled", "edges", "graph_snapshot", "reset",
]


class LockOrderError(RuntimeError):
    """A lock acquisition that closes a cycle in the acquired-before
    graph (or re-acquires a non-reentrant lock on the same thread)."""


# process-global order graph; _STATE_LOCK is a plain lock on purpose —
# the sanitizer must not instrument itself
_STATE_LOCK = threading.Lock()
_EDGES: Dict[Tuple[str, str], dict] = {}   # (src, dst) -> witness
_SUCC: Dict[str, Set[str]] = {}            # adjacency over names
_tls = threading.local()


def enabled() -> bool:
    """True when REPRO_LOCKDEP asks for instrumented locks."""
    return os.environ.get("REPRO_LOCKDEP", "").strip().lower() \
        not in ("", "0", "false", "no")


def make_lock(name: str) -> Union[threading.Lock, "LockdepLock"]:
    """A ``threading.Lock``, instrumented under REPRO_LOCKDEP=1.
    ``name`` is the acquired-before graph node — spell it exactly like
    the static key (``"ClassName._lock"``)."""
    return LockdepLock(name) if enabled() else threading.Lock()


def make_rlock(name: str) -> Union[threading.RLock, "LockdepRLock"]:
    """``threading.RLock`` counterpart of :func:`make_lock`."""
    return LockdepRLock(name) if enabled() else threading.RLock()


def _held() -> List[list]:
    """This thread's held stack: mutable ``[lock, name, count]`` rows."""
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _reaches(src: str, dst: str) -> bool:
    """DFS over _SUCC (caller holds _STATE_LOCK)."""
    seen: Set[str] = set()
    work = [src]
    while work:
        n = work.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        work.extend(_SUCC.get(n, ()))
    return False


def _fmt_witness(w: dict) -> str:
    return (f"  first taken in this order by thread "
            f"{w['thread']!r} at:\n{w['stack']}")


def _check_and_record(name: str, held: List[list]) -> None:
    """The edge check, BEFORE the underlying acquire can block."""
    stack = "".join(traceback.format_stack(limit=16)[:-2])
    me = threading.current_thread().name
    with _STATE_LOCK:
        for _lock, h, _count in held:
            if h == name:
                raise LockOrderError(
                    f"lock-order inversion: acquiring a lock named "
                    f"{name!r} while already holding one — same-name "
                    f"locks have no verifiable order\n"
                    f"  second acquisition at:\n{stack}")
            if _reaches(name, h):
                prior = next(
                    (w for (s, d), w in _EDGES.items()
                     if s == name and _reaches(d, h) or (s, d) == (name, h)),
                    None)
                msg = (f"lock-order inversion: acquiring {name!r} while "
                       f"holding {h!r}, but the graph already orders "
                       f"{name!r} before {h!r}\n"
                       f"  this acquisition (thread {me!r}) at:\n{stack}")
                if prior is not None:
                    msg += f"\n{_fmt_witness(prior)}"
                raise LockOrderError(msg)
        for _lock, h, _count in held:
            if (h, name) not in _EDGES:
                _EDGES[(h, name)] = {"thread": me, "stack": stack}
                _SUCC.setdefault(h, set()).add(name)


class LockdepLock:
    """``threading.Lock`` wrapper feeding the acquired-before graph."""

    _reentrant = False

    def __init__(self, name: str) -> None:
        self.name = name
        self._inner = self._make_inner()

    @staticmethod
    def _make_inner():
        return threading.Lock()

    def acquire(self, blocking: bool = True,
                timeout: Optional[float] = -1) -> bool:
        held = _held()
        mine = next((row for row in held if row[0] is self), None)
        if mine is not None:
            if self._reentrant:
                ok = self._inner.acquire(blocking, timeout)
                if ok:
                    mine[2] += 1
                return ok
            if blocking:
                raise LockOrderError(
                    f"self-deadlock: thread "
                    f"{threading.current_thread().name!r} re-acquiring "
                    f"non-reentrant lock {self.name!r} it already holds")
            return False
        if blocking:
            _check_and_record(self.name, held)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            held.append([self, self.name, 1])
        return ok

    def release(self) -> None:
        self._inner.release()
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                held[i][2] -= 1
                if held[i][2] == 0:
                    del held[i]
                return

    def locked(self) -> bool:
        return self._inner.locked()

    def _is_owned(self) -> bool:
        # accurate ownership for Condition (beats the stdlib's
        # acquire(False) probe, which misreads other-thread holders)
        return any(row[0] is self for row in _held())

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class LockdepRLock(LockdepLock):
    """``threading.RLock`` wrapper: re-entry is legal and recorded
    once; the outermost release drops the held entry."""

    _reentrant = True

    @staticmethod
    def _make_inner():
        return threading.RLock()


def edges() -> Set[Tuple[str, str]]:
    """The observed acquired-before edges so far."""
    with _STATE_LOCK:
        return set(_EDGES)


def graph_snapshot() -> dict:
    """JSON-shaped observed graph, same vocabulary as the static
    ``lockgraph.json`` artifact."""
    with _STATE_LOCK:
        names = sorted({n for e in _EDGES for n in e})
        return {"locks": names,
                "edges": [{"src": s, "dst": d, "thread": w["thread"]}
                          for (s, d), w in sorted(_EDGES.items())]}


def reset() -> None:
    """Forget every recorded edge (test isolation only)."""
    with _STATE_LOCK:
        _EDGES.clear()
        _SUCC.clear()
