"""Mean device time of ``SummarizerPod.route`` an ingest (CUDA events
around the call, every ingest of the window)."""
import statistics


def read(ctx):
    return statistics.fmean(ctx["route_ms"]) if ctx["route_ms"] else None
