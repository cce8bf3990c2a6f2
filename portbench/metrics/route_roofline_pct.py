"""Share of the routing's roofline: its least bytes (tags, items and the
slot table read once; chunks, counts and drop counts written once) over
the peak bandwidth, against the traced ingests' route time (events)."""


def read(ctx):
    tr, work = ctx["trace"], ctx["work"]
    if not tr or not tr["ingests"]:
        return None
    ms = ctx["route_ms"][:tr["ingests"]]
    t = sum(ms) / 1e3
    if t <= 0:
        return None
    return 100.0 * work["route_bytes"] / ctx["peaks"].PEAK_BW / t
