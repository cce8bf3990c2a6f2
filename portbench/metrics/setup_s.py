"""Process start to the first timed ingest: imports, the card, loading
(and in a first run building) the kernels, admitting the sessions,
making the pool and the warm-up ingests."""


def read(ctx):
    return ctx["setup_s"]
