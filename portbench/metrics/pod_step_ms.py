"""Mean device time of ``SummarizerPod.ingest_routed`` an ingest (CUDA
events around the call, every ingest of the window)."""
import statistics


def read(ctx):
    ms = ctx["pod_step_ms"]
    return statistics.fmean(ms) if ms else None
