# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Concurrency utilities: the lockdep runtime sanitizer (DESIGN.md §14;
port of ``repro/concurrency/__init__.py``).

``make_lock`` / ``make_rlock`` are drop-in :mod:`threading` factories;
under ``REPRO_LOCKDEP=1`` they return instrumented locks that raise
:class:`LockOrderError` on the first acquired-before cycle instead of
deadlocking.  The name passed to the factory is the lock's identity in
the order graph and matches the node spelling of the static graph built
by ``tools/podlint`` (``ClassName.attr``).
"""
from .lockdep import (  # noqa: F401
    LockdepLock,
    LockdepRLock,
    LockOrderError,
    edges,
    enabled,
    graph_snapshot,
    make_lock,
    make_rlock,
    reset,
)

__all__ = [
    "LockdepLock", "LockdepRLock", "LockOrderError", "edges", "enabled",
    "graph_snapshot", "make_lock", "make_rlock", "reset",
]
