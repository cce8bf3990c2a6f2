"""The program's hot spans joined to the profiler's timeline of the device.

``repro_torch.obs`` records hot spans (``route``, ``pod_step``,
``sieve.round``, ``rearm`` and their children) on the Unix clock of the
profiler's Kineto events while hot tracing is on.  ``join`` puts each
device operation in the innermost span that was open on the host when
its runtime launch record (the same correlation id) started, counts the
synchronising runtime calls each span made and the time they blocked,
and labels each idle gap of the device by the span path open on the host
during it, split in proportion to overlap (``outside the program`` where
none was).  A trace that holds no span keeps the gaps' old names,
``before <the operation that ended the gap>``.

The per-layer readings of the spans are the functions of ``METRICS``:
each takes the benchmark's ``ctx`` with ``ctx["spans"]``, ``join``'s
result, and returns a number or ``None`` where it finds nothing to read.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Optional

from . import trace

OUTSIDE = "outside the program"
LEAD_US = 5.0  # the most a device operation may start before its launch
# runtime calls that block the host until the device has caught up: the
# stream, event and device synchronizes and the synchronous copies (a
# read to the host, ``.item()`` or ``nonzero``, is an async copy, then a
# stream sync); and ``is_blocking``'s copies
SYNC_CALLS = frozenset((
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cuStreamSynchronize", "cuCtxSynchronize",
    "cuEventSynchronize", "cuMemcpyDtoH_v2", "cuMemcpy"))


def is_blocking(call: "Event", op: Optional["Event"]) -> bool:
    """Whether the runtime ``call`` blocked the host until the device had
    caught up: a synchronize or synchronous copy, or an async copy to
    pageable host memory (``op``, the device operation it issued, reads
    ``Memcpy DtoH (Device -> Pageable)``), which the runtime completes
    before it returns."""
    if call.name in SYNC_CALLS:
        return True
    return (call.name.startswith("cudaMemcpy") and op is not None
            and "DtoH" in op.name and "Pageable" in op.name)


class Event(NamedTuple):
    """One record of the profiler: a device operation (``device``) or a
    host-side one (a runtime call), on the Unix nanosecond clock."""

    name: str
    device: bool
    start: int
    end: int
    corr: int


def kineto_events(prof) -> List[Event]:
    """The profiler's records as ``Event`` tuples."""
    from torch.autograd import DeviceType

    return [Event(e.name(), e.device_type() == DeviceType.CUDA,
                  e.start_ns(), e.start_ns() + e.duration_ns(),
                  e.correlation_id())
            for e in prof.profiler.kineto_results.events()]


def drift(kernels: List[Event], launches: Dict[int, Event],
          bin_ns: int = 100_000_000) -> tuple:
    """(t0, a, b): the device's timestamps are taken to run a + b (t - t0)
    ns later than the host's at device time t.

    CUPTI puts the device's timestamps on the host's clock with a rate
    that is off by some microseconds a second (more in some runs), so an
    operation can appear to start before the call that launched it.
    What a launch bounds is the operation's start: no earlier than the
    call.  In each ``bin_ns`` of the trace the smallest start-less-launch
    is the nearest the device came to that bound (an operation launched
    into an empty queue); the line is the Theil-Sen slope through those
    minima, set as high as lets every minimum sit on or above it."""
    low: Dict[int, tuple] = {}
    t0 = kernels[0].start if kernels else 0
    for e in kernels:
        launch = launches.get(e.corr)
        if launch is None:
            continue
        lag, k = e.start - launch.start, (e.start - t0) // bin_ns
        if k not in low or lag < low[k][1]:
            low[k] = (e.start - t0, lag)
    pts = sorted(low.values())
    if not pts:
        return t0, 0.0, 0.0
    slopes = sorted((l2 - l1) / (x2 - x1) for i, (x1, l1) in enumerate(pts)
                    for x2, l2 in pts[i + 1:] if x2 > x1)
    b = slopes[len(slopes) // 2] if slopes else 0.0
    a = min(lag - b * x for x, lag in pts)
    return t0, a, b


def _timeline(spans: List[dict]):
    """(segment starts, [(start, end, path)]) covering the spans' whole
    time: in each segment the innermost open span's path, else
    ``OUTSIDE``."""
    marks = []
    for k, s in enumerate(spans):
        marks.append((s["start_ns"], 1, k))
        marks.append((s["end_ns"], 0, k))
    marks.sort()
    segs, open_, t_prev = [], [], None
    for t, kind, k in marks:
        if t_prev is not None and t > t_prev:
            segs.append((t_prev, t, spans[open_[-1]]["path"] if open_
                         else OUTSIDE))
        if kind:
            open_.append(k)
        else:
            open_.remove(k)
        t_prev = t
    return [s[0] for s in segs], segs


def _path_at(starts, segs, t: int) -> str:
    i = bisect.bisect_right(starts, t) - 1
    if i < 0 or t >= segs[i][1]:
        return OUTSIDE
    return segs[i][2]


def _row(table, path):
    return table.setdefault(path, {
        "count": 0, "host_s": 0.0, "self_host_s": 0.0, "device_s": 0.0,
        "syncs": 0, "sync_wait_s": 0.0, "idle_s": 0.0})


def join(events: List[Event], records: List[dict]) -> dict:
    """-> {"table": {path: {count, host_s, self_host_s, device_s, syncs,
    sync_wait_s, idle_s}}, "idle_gaps": [[label, s]] (the ten longest),
    "idle_s", "counters": {name: [values]}, "raw_lead_us",
    "drift_us_per_s", "launch_lead_us", "leads_over_5us", "unlaunched_s",
    "device_ops"}.

    The window and the gaps are ``trace.read``'s: from the first record
    to the last, the gaps between the union of the device operations.
    ``device_s`` and the syncs of a path are its own (the innermost span
    at the launch), not its children's.  The device's timestamps are
    first put on the launches' clock (``drift``): ``raw_lead_us`` is the
    most any operation started before its launch record as recorded,
    ``drift_us_per_s`` the rate the device's clock ran off the host's,
    ``launch_lead_us`` and ``leads_over_5us`` (past ``LEAD_US``) the
    same lead on the joined clock."""
    spans = [r for r in records if r.get("kind") == "hot_span"]
    counters: Dict[str, list] = {}
    for r in records:
        if r.get("kind") == "hot_counter":
            counters.setdefault(r["name"], []).append(r["value"])
    table: Dict[str, dict] = {}
    by_id = {s["span_id"]: s for s in spans}
    for s in spans:
        row = _row(table, s["path"])
        dur = (s["end_ns"] - s["start_ns"]) / 1e9
        row["count"] += 1
        row["host_s"] += dur
        row["self_host_s"] += dur
        parent = by_id.get(s["parent_id"])
        if parent is not None:
            _row(table, parent["path"])["self_host_s"] -= dur
    starts, segs = _timeline(spans)

    # the runtime calls (cudaLaunchKernel, cudaMemcpyAsync, ...): the
    # profiler's own records (a buffer request, a module load) share the
    # correlation id of the call that set them off
    launches = {}
    for e in sorted((e for e in events
                     if not e.device and e.name.startswith("cu")),
                    key=lambda e: -e.start):
        launches[e.corr] = e
    raw = sorted((e for e in events if e.device and e.end > e.start),
                 key=lambda e: e.start)
    raw_lead = max(((launches[e.corr].start - e.start) / 1e3 for e in raw
                    if e.corr in launches), default=None)
    t0, off, rate = drift(raw, launches)

    def joined(t):
        return t - round(off + rate * (t - t0))

    kernels = [e._replace(start=joined(e.start), end=joined(e.end))
               for e in raw]
    lead, over, unlaunched = None, 0, 0.0
    for e in kernels:
        launch = launches.get(e.corr)
        if launch is None:
            unlaunched += (e.end - e.start) / 1e9
            continue
        lead_us = (launch.start - e.start) / 1e3
        lead = lead_us if lead is None else max(lead, lead_us)
        over += lead_us > LEAD_US
        row = _row(table, _path_at(starts, segs, launch.start))
        row["device_s"] += (e.end - e.start) / 1e9
    ops = {e.corr: e for e in kernels}
    for e in events:
        if not e.device and is_blocking(e, ops.get(e.corr)):
            row = _row(table, _path_at(starts, segs, e.start))
            row["syncs"] += 1
            row["sync_wait_s"] += (e.end - e.start) / 1e9

    # the gaps, as trace.read finds them
    lo = min((e.start for e in events), default=None)
    hi = max((e.end for e in events), default=None)
    gaps, cur = [], lo
    for e in kernels:
        if e.start > cur:
            gaps.append((cur, e.start, e.name))
        cur = max(cur, e.end)
    if kernels and hi > cur:
        gaps.append((cur, hi, None))
    idle: Dict[str, float] = {}
    for a, b, after in gaps:
        if not spans:
            label = ("before " + trace.short(after) if after
                     else "after the last")
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
            continue
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        covered = 0
        while i < len(segs) and segs[i][0] < b:
            s0, s1, path = segs[i]
            ov = min(b, s1) - max(a, s0)
            if ov > 0:
                idle[path] = idle.get(path, 0.0) + ov / 1e9
                _row(table, path)["idle_s"] += ov / 1e9
                covered += ov
            i += 1
        if b - a > covered:  # before the first span or after the last
            rest = (b - a - covered) / 1e9
            idle[OUTSIDE] = idle.get(OUTSIDE, 0.0) + rest
            _row(table, OUTSIDE)["idle_s"] += rest
    return {"table": table,
            "idle_gaps": [[k, v] for k, v in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
            "idle_s": sum(idle.values()), "counters": counters,
            "raw_lead_us": raw_lead, "drift_us_per_s": rate * 1e6,
            "launch_lead_us": lead, "leads_over_5us": over,
            "unlaunched_s": unlaunched,
            "device_ops": len(kernels)}


def under(table: dict, root: str, key: str) -> float:
    """``key`` summed over ``root`` and every path below it."""
    return sum(row[key] for path, row in table.items()
               if path == root or path.startswith(root + "/"))


def ending(table: dict, name: str, key: str) -> float:
    """``key`` summed over every path whose innermost span is ``name``."""
    return sum(row[key] for path, row in table.items()
               if path == name or path.endswith("/" + name))


def lines(joined: dict) -> List[str]:
    """The per-span table as ``info span.<path> ...`` lines."""
    out = []
    for path, r in sorted(joined["table"].items()):
        out.append(
            f"info span.{path.replace(' ', '_')} count {r['count']} "
            f"host_s {r['host_s']:.6f} self_host_s {r['self_host_s']:.6f} "
            f"device_s {r['device_s']:.6f} syncs {r['syncs']} "
            f"sync_wait_s {r['sync_wait_s']:.6f} idle_s {r['idle_s']:.6f}")
    return out


# ------------------------------------------------------------ the readings
def _count(table: dict, path: str) -> int:
    return table.get(path, {}).get("count", 0)


def _per(table: dict, total: float, path: str) -> Optional[float]:
    n = _count(table, path)
    return 1e3 * total / n if n else None


def _rounds(table: dict) -> int:
    return sum(r["count"] for p, r in table.items()
               if p == "sieve.round" or p.endswith("/sieve.round"))


def _device(sp: dict) -> bool:
    return sp["device_ops"] > 0


def route_host_ms(ctx) -> Optional[float]:
    """Host time in ``route`` an ingest."""
    t = ctx["spans"]["table"]
    return _per(t, t.get("route", {}).get("host_s", 0.0), "route")


def pod_step_host_ms(ctx) -> Optional[float]:
    """Host time in ``pod_step`` (``ingest_routed``) an ingest."""
    t = ctx["spans"]["table"]
    return _per(t, t.get("pod_step", {}).get("host_s", 0.0), "pod_step")


def pod_step_chain(ctx) -> Optional[float]:
    """The most fused gain passes any session made in an ingest
    (``pod_step_passes``), the mean over the traced ingests."""
    v = ctx["spans"]["counters"].get("pod_step_passes")
    return sum(v) / len(v) if v else None


def sieve_decide_host_ms(ctx) -> Optional[float]:
    """Host time in ``sieve.decide`` a round of ``run_slots``."""
    t = ctx["spans"]["table"]
    n = _rounds(t)
    return 1e3 * ending(t, "sieve.decide", "host_s") / n if n else None


def sieve_sync_wait_ms(ctx) -> Optional[float]:
    """Host time in ``sieve.sync`` (the read of which slots go on; the
    first ``nonzero`` counts too) a round."""
    t = ctx["spans"]["table"]
    n = _rounds(t)
    return 1e3 * ending(t, "sieve.sync", "host_s") / n if n else None


def rearm_ms(ctx) -> Optional[float]:
    """Device time of the operations launched in ``rearm``, an ingest."""
    sp = ctx["spans"]
    if not _device(sp):
        return None
    return _per(sp["table"], under(sp["table"], "rearm", "device_s"),
                "rearm")


def rearm_host_ms(ctx) -> Optional[float]:
    """Host time in ``rearm`` (``reset_slots``) an ingest."""
    t = ctx["spans"]["table"]
    return _per(t, t.get("rearm", {}).get("host_s", 0.0), "rearm")


def host_syncs(ctx) -> Optional[float]:
    """Synchronising runtime calls inside program spans, an ingest (the
    roots ``route`` or, without it, ``pod_step`` count the ingests)."""
    sp = ctx["spans"]
    t = sp["table"]
    n = _count(t, "route") or _count(t, "pod_step")
    if not _device(sp) or not n:
        return None
    return sum(r["syncs"] for p, r in t.items() if p != OUTSIDE) / n


METRICS = {f.__name__: f for f in (
    route_host_ms, pod_step_host_ms, pod_step_chain, sieve_decide_host_ms,
    sieve_sync_wait_ms, rearm_ms, rearm_host_ms, host_syncs)}
