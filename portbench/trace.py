"""Reading the profiler's timeline of the device: busy time, the busiest
device operations, and the idle gaps, each named by the operation the
device waited for (what the host was preparing when the device ran
dry)."""
from __future__ import annotations

import re


def short(name: str) -> str:
    """A kernel's name without its template arguments and signature."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", name, maxsplit=1)[0]
    return head.split("::")[-1].strip() or name[:40]


def read(prof) -> dict:
    """-> {"kernel_s": {name: seconds}, "busy_s", "window_s",
    "device_ops": [[name, s]], "idle_gaps": [[before what, s]]}.

    The window runs from the first to the last event the profiler
    recorded; busy time is the union of the device operations."""
    from torch.autograd import DeviceType

    kernels, lo, hi = [], None, None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        lo = a if lo is None else min(lo, a)
        hi = b if hi is None else max(hi, b)
        if e.device_type == DeviceType.CUDA and b > a:
            kernels.append((a, b, e.name))
    kernel_s = {}
    for a, b, name in kernels:
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) / 1e6
    busy, cur, idle = 0.0, lo, {}
    for a, b, name in sorted(kernels):
        if a > cur:
            label = "before " + short(name)
            idle[label] = idle.get(label, 0.0) + (a - cur) / 1e6
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if kernels and hi > cur:
        idle["after the last"] = (hi - cur) / 1e6
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return {"kernel_s": kernel_s, "busy_s": busy / 1e6,
            "window_s": (hi - lo) / 1e6 if kernels else 0.0,
            "device_ops": [[k[:160], v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}
