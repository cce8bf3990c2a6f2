# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""repro_torch.obs — the fleet telemetry layer (port of ``repro/obs``).

Three pieces, one rule:

  * :mod:`~repro_torch.obs.registry` — counters / gauges / histograms
    with labels; lock-free snapshot reads; JSON snapshot + Prometheus
    text exposition; ``NULL`` (a no-op registry) switches a component
    off;
  * :mod:`~repro_torch.obs.spans` — structured spans for control-plane
    operations (admission, eviction, drift resets), emitted as JSONL
    with durations, nesting and outcomes; and hot spans and counters on
    the ingest path (``hot_span``, ``hot_count``);
  * :mod:`~repro_torch.obs.drain` — the device-counter drain:
    PodState's on-device accept/drop ledgers are harvested into host
    metrics at existing host-sync boundaries ONLY.

The CUDA builds are counted by ``kernels/build.py`` in
``kernel_build_total`` / ``kernel_build_seconds``.

The rule: **telemetry costs the hot path one check** — no ``.item()``,
no host copy, no metric recording inside the ingest step.  The ingest
path (``SummarizerPod.route``, ``ingest_routed``, ``reset_slots``, the
pod step, ``StackedSieve.run_slots``' rounds) holds hot spans, off by
default: each is one flag check returning a shared no-op.  The span API
no-ops while ``torch.compile`` traces.

Hot tracing, for an operator:

    rec = obs.get_recorder()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    rec.trace_hot(True)
    prof.start()
    ...  # ingests
    prof.stop()
    records = rec.trace_hot(False)
    rec.dump_jsonl("spans.jsonl")

Each span record's ``start_ns`` / ``end_ns`` is in Unix nanoseconds,
the clock of the profiler's Kineto events
(``prof.profiler.kineto_results.events()``, each ``start_ns()``), so a
kernel belongs to the innermost span open when its runtime launch record
(the same ``correlation_id``) started.  ``portbench/spans.py`` makes
that join, after putting the device's timestamps, which drift off that
clock by some microseconds a second, back on the launches'.  A span costs about 0.3-0.5 us off and 4 us on (two clock
reads and a list append) on the CPU of an H100 host.
"""
from . import drain
from .registry import (DEFAULT_BUCKETS, MetricFamily, MetricsRegistry,
                       MetricsSnapshot, NULL, NullRegistry, get_registry,
                       reset_default_registry)
from .spans import (Span, SpanRecorder, get_recorder, hot_count, hot_span,
                    hot_tracing, span)

__all__ = [
    "DEFAULT_BUCKETS", "MetricFamily", "MetricsRegistry", "MetricsSnapshot",
    "NULL", "NullRegistry", "get_registry", "reset_default_registry",
    "Span", "SpanRecorder", "get_recorder", "span", "hot_span", "hot_count",
    "hot_tracing", "drain",
]
