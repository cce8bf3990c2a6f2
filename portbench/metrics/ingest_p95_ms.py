"""95th percentile over the window's ingests of the time from when a batch
was due (the ingest two before it completed, freeing its place among the
two in flight; the window's start for the first two) to its completion,
on the device's clock (CUDA events)."""
import statistics


def read(ctx):
    lat = ctx["latency_ms"]
    return statistics.quantiles(lat, n=20)[18] if len(lat) >= 200 else None
