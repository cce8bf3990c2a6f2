import importlib.util
import os
import pathlib
import sys

# Smoke tests and benches must see exactly ONE device (the dry-run sets up
# its 512 placeholder devices itself, in a subprocess / separate entrypoint).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "0")

# Property tests use hypothesis when available; otherwise activate the
# deterministic fallback sampler so the suite runs without the dependency.
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    _spec = importlib.util.spec_from_file_location(
        "_hypothesis_fallback",
        pathlib.Path(__file__).parent / "_hypothesis_fallback.py")
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
    sys.modules["hypothesis"] = _mod
    sys.modules["hypothesis.strategies"] = _mod.strategies

import jax

jax.config.update("jax_default_prng_impl", "threefry2x32")

# --------------------------------------------------------------------------
# retrace_guard: a compile-count budget as a reusable fixture.
#
# "No recompile" is a serving-stack invariant (the admit/evict/drift
# lifecycle and the ingest loop must all run inside ONE compiled
# program), but until this fixture it was proven by exactly one bespoke
# counter in test_session_spec.py, for admit only.  jax.monitoring fires
# one /jax/core/compile/backend_compile_duration event per *fresh* XLA
# compile and none on a cache hit, so counting those events inside a
# scope is exactly "did anything retrace here".
#
# jax.monitoring has no unregister API, so ONE module-level listener is
# installed once and toggled by the guard; the fixture hands out a
# reset singleton per test.
# --------------------------------------------------------------------------
import contextlib

from jax import monitoring as _monitoring

_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


class RetraceGuard:
    """Counts fresh XLA compiles; ``budget(n)`` asserts at scope exit.

    Usage::

        def test_x(retrace_guard):
            step(state)                      # warmup: compiles happen here
            with retrace_guard.budget(0):    # the guarded region
                step(state)                  # must be served from cache
    """

    def __init__(self):
        self.compiles = 0
        self._active = False

    def _on_event(self, event, duration, **kwargs):
        if self._active and event == _COMPILE_EVENT:
            self.compiles += 1

    @contextlib.contextmanager
    def budget(self, max_compiles=0):
        start = self.compiles
        self._active = True
        try:
            yield self
        finally:
            self._active = False
        fresh = self.compiles - start
        assert fresh <= max_compiles, (
            f"retrace_guard: {fresh} fresh XLA compile(s) inside a "
            f"budget of {max_compiles} — something retraced (new shapes/"
            f"dtypes, a Python-constant hyperparameter, or an un-cached "
            f"jit wrapper)")


_RETRACE_GUARD = RetraceGuard()
_monitoring.register_event_duration_secs_listener(_RETRACE_GUARD._on_event)


def _fresh_retrace_guard():
    _RETRACE_GUARD.compiles = 0
    _RETRACE_GUARD._active = False
    return _RETRACE_GUARD


try:
    import pytest

    @pytest.fixture
    def retrace_guard():
        """Per-test compile-count budget (see RetraceGuard above)."""
        yield _fresh_retrace_guard()
except ImportError:  # pragma: no cover - pytest always present under test
    pass


def pytest_configure(config):
    # enforced by pytest-timeout when installed (CI); the socket sources
    # additionally carry their own socket-level timeouts, so a dead
    # socket fails fast either way
    config.addinivalue_line(
        "markers",
        "timeout(seconds): per-test timeout for tests that touch sockets")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (the PyTorch port's CUDA "
        "kernels); skipped where there is none")


def pytest_sessionfinish(session, exitstatus):
    """CI observability artifact: when REPRO_OBS_DUMP names a directory,
    write the suite's accumulated metrics snapshot + span JSONL there
    (uploaded by the tier-1 workflow; `make verify OBS_DUMP=dir`)."""
    out = os.environ.get("REPRO_OBS_DUMP")
    if not out:
        return
    try:
        from repro import obs
        d = pathlib.Path(out)
        d.mkdir(parents=True, exist_ok=True)
        (d / "metrics_snapshot.json").write_text(
            obs.get_registry().snapshot().to_json())
        (d / "metrics.prom").write_text(
            obs.get_registry().snapshot().to_prometheus())
        obs.get_recorder().dump_jsonl(d / "spans.jsonl")
    except Exception as e:  # telemetry must never fail the suite
        sys.stderr.write(f"REPRO_OBS_DUMP failed: {e}\n")
