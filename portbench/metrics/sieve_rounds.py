"""Rounds of ``StackedSieve.run_slots`` an ingest: grouped ``gain_traced``
launches (the kernel's launch counter) over the window's ingests."""


def read(ctx):
    n = ctx["launches"].get("gain_traced", 0)
    return n / ctx["ingests"] if ctx["ingests"] and n else None
