"""Session specs of a configuration: each key's values rotate over the
slots (``session_cycles``: slot i takes ``values[i % len]`` of every
cycle, later cycles overriding earlier ones)."""
from __future__ import annotations

SPEC_KEYS = ("K", "T", "eps", "lengthscale", "kernel_kind")


def specs(cfg) -> list:
    out = []
    for i in range(int(cfg["total_sessions"])):
        sp = {"T": 1, "kernel_kind": "rbf"}
        for cyc in cfg["session_cycles"]:
            vals = cyc["values"]
            sp.update(vals[i % len(vals)])
        missing = [k for k in SPEC_KEYS if k not in sp]
        if missing:
            raise ValueError(f"session {i} spec lacks {missing}")
        out.append(sp)
    return out
