"""All real items of the window's ingests over the window's whole time."""


def read(ctx):
    return ctx["items"] / ctx["window_s"] if ctx["window_s"] > 0 else None
