# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""repro_torch.obs — the fleet telemetry layer (port of ``repro/obs``).

Three pieces, one rule:

  * :mod:`~repro_torch.obs.registry` — counters / gauges / histograms
    with labels; lock-free snapshot reads; JSON snapshot + Prometheus
    text exposition; ``NULL`` (a no-op registry) switches a component
    off;
  * :mod:`~repro_torch.obs.spans` — structured spans for control-plane
    operations (admission, eviction, drift resets), emitted as JSONL
    with durations, nesting and outcomes;
  * :mod:`~repro_torch.obs.drain` — the device-counter drain:
    PodState's on-device accept/drop ledgers are harvested into host
    metrics at existing host-sync boundaries ONLY;
  * :mod:`~repro_torch.obs.torchbridge` — compile accounting (port of
    ``repro/obs/jaxbridge.py``): every Dynamo compile counted in
    ``torch_compile_total`` / ``torch_compile_seconds`` (installed once,
    below, at import); the CUDA builds are counted by ``kernels/build.py``
    in ``kernel_build_total`` / ``kernel_build_seconds``.

The rule: **telemetry never touches the hot path** — no ``.item()``, no
host copy, no metric recording inside the ingest step; the span API
no-ops while ``torch.compile`` traces.
"""
from . import drain
from .registry import (DEFAULT_BUCKETS, MetricFamily, MetricsRegistry,
                       MetricsSnapshot, NULL, NullRegistry, get_registry,
                       reset_default_registry)
from .spans import Span, SpanRecorder, get_recorder, span
from .torchbridge import install as install_torch_bridge

__all__ = [
    "DEFAULT_BUCKETS", "MetricFamily", "MetricsRegistry", "MetricsSnapshot",
    "NULL", "NullRegistry", "get_registry", "reset_default_registry",
    "Span", "SpanRecorder", "get_recorder", "span", "drain",
    "install_torch_bridge",
]

# always-on compile accounting: one listener pair, installed exactly once
install_torch_bridge()
