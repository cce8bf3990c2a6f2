# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Dynamo compile events -> metrics registry bridge (port of
``repro/obs/jaxbridge.py``).

A fresh ``torch.compile`` mid-serve stalls its caller for the whole
compile, as an XLA retrace does in the JAX package.  The bridge counts
every compile Dynamo finishes in ``torch_compile_total`` and records its
duration in ``torch_compile_seconds``, so a run shows how many programs
it built and how long they took.  Cache hits fire no event and count
nothing.  The port's own builds, the ``nvcc`` runs of
``kernels/build.py``, are its other stall; that module counts them in
``kernel_build_total`` / ``kernel_build_seconds``.

Dynamo's ``callback_handler`` runs its start and end callbacks once for
the outermost compile of a thread.  Exactly ONE pair of module-level
listeners is registered, the first time :func:`install` runs
(``repro_torch.obs`` calls it at import); repeat calls are no-ops.  The
listeners resolve the *current* default registry when an event arrives,
so ``reset_default_registry()`` takes effect without registering again.
"""
from __future__ import annotations

import threading
import time

from repro_torch.concurrency import make_lock

from .registry import get_registry

_install_lock = make_lock("torchbridge._install_lock")
_installed = False
_registrations = 0  # how many times listeners were REGISTERED (tests: == 1)
_started = {}  # thread id -> perf_counter at its compile's start


def _on_start(args) -> None:
    _started[threading.get_ident()] = time.perf_counter()


def _on_end(args) -> None:
    t0 = _started.pop(threading.get_ident(), None)
    reg = get_registry()
    if not reg.enabled:
        return
    reg.counter("torch_compile_total",
                "fresh Dynamo compiles (cache hits do not count)").inc()
    if t0 is not None:
        reg.histogram("torch_compile_seconds",
                      "Dynamo compile durations").observe(
            time.perf_counter() - t0)


def install() -> bool:
    """Register the bridge listeners exactly once; True when this call
    registered them (False: already installed)."""
    global _installed, _registrations
    with _install_lock:
        if _installed:
            return False
        from torch._dynamo.callback import callback_handler

        callback_handler.register_start_callback(_on_start)
        callback_handler.register_end_callback(_on_end)
        _registrations += 1
        _installed = True
        return True


def installed() -> bool:
    return _installed


def registrations() -> int:
    return _registrations
