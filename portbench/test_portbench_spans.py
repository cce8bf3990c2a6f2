"""The join of the program's hot spans to the device trace
(``spans.join``) on a made-up trace, its readings, and a traced run of
each tiny cell with hot tracing on (``spantrace.run_cell``), on the
CPU."""
from __future__ import annotations

import io

import pytest

from portbench import harness, spans, spantrace, trace

from .conftest import TINY, TRAFFIC, tiny_cell


def _span(sid, path, start, end, parent=None, batch=0):
    return {"kind": "hot_span", "name": path.rsplit("/", 1)[-1],
            "path": path, "span_id": sid, "parent_id": parent,
            "depth": path.count("/"), "batch": batch, "thread": 1,
            "start_ns": start, "end_ns": end}


RECORDS = [
    _span(0, "route", 1000, 5000),
    _span(1, "route/route.count", 3000, 5000, 0),
    _span(2, "pod_step", 6000, 9000),
    _span(3, "pod_step/pod_step.kernel", 6500, 8000, 2),
    _span(4, "rearm", 10000, 12000),
    _span(5, "rearm/rearm.init", 10000, 11000, 4),
    {"kind": "hot_counter", "name": "pod_step_passes", "batch": 0,
     "thread": 1, "value": 3},
    {"kind": "hot_counter", "name": "pod_step_passes", "batch": 1,
     "thread": 1, "value": 5},
]
E = spans.Event
EVENTS = [
    E("cudaLaunchKernel", False, 1200, 1300, 1), E("k_own", True, 1400, 2000, 1),
    E("cudaLaunchKernel", False, 3100, 3150, 2), E("k_hist", True, 3200, 3400, 2),
    E("cudaStreamSynchronize", False, 3500, 4500, 3),
    # a read to pageable memory blocks in the copy call itself; to pinned
    # memory it does not
    E("cudaMemcpyAsync", False, 4620, 4720, 8),
    E("Memcpy DtoH (Device -> Pageable)", True, 4620, 4640, 8),
    E("cudaMemcpyAsync", False, 4750, 4760, 9),
    E("Memcpy DtoH (Device -> Pinned)", True, 4770, 4780, 9),
    E("cudaLaunchKernel", False, 6600, 6700, 4), E("k_pod", True, 7000, 9500, 4),
    E("cudaLaunchKernel", False, 10100, 10150, 5),
    E("k_init", True, 10200, 10400, 5),
    E("cudaLaunchKernel", False, 13000, 13050, 6),
    E("k_late", True, 13100, 13200, 6),
    E("cudaDeviceSynchronize", False, 13300, 13400, 7),
    E("Memcpy DtoD", True, 13500, 13600, 99),  # no launch record
    # the profiler's own record, sharing a launch's correlation id
    E("Activity Buffer Request", False, 1250, 9000, 1),
]


def test_join_attributes_kernels_syncs_and_gaps_to_spans():
    j = spans.join(EVENTS, RECORDS)
    t = j["table"]
    ns = 1e-9
    assert t["route"]["device_s"] == pytest.approx(600 * ns)
    assert t["route/route.count"]["device_s"] == pytest.approx(230 * ns)
    assert t["pod_step/pod_step.kernel"]["device_s"] == pytest.approx(
        2500 * ns)
    assert t["rearm/rearm.init"]["device_s"] == pytest.approx(200 * ns)
    assert t[spans.OUTSIDE]["device_s"] == pytest.approx(100 * ns)
    assert j["unlaunched_s"] == pytest.approx(100 * ns)
    assert (t["route/route.count"]["syncs"],
            t[spans.OUTSIDE]["syncs"]) == (2, 1)
    assert t["route/route.count"]["sync_wait_s"] == pytest.approx(1100 * ns)
    assert j["raw_lead_us"] == j["launch_lead_us"] == 0.0
    assert j["drift_us_per_s"] == 0.0
    assert t["route"]["host_s"] == pytest.approx(4000 * ns)
    assert t["route"]["self_host_s"] == pytest.approx(2000 * ns)
    assert t["pod_step"]["count"] == 1
    idle = {k: v / ns for k, v in j["idle_gaps"]}
    want = {"route": 1200, "route/route.count": 1770, spans.OUTSIDE: 2900,
            "pod_step": 500, "pod_step/pod_step.kernel": 500,
            "rearm/rearm.init": 800, "rearm": 1000}
    assert idle == pytest.approx(want)
    # the window less the union of the device operations
    assert j["idle_s"] / ns == pytest.approx((13600 - 1200) - 3730)
    assert j["leads_over_5us"] == 0
    assert j["counters"] == {"pod_step_passes": [3, 5]}
    assert j["device_ops"] == 8


def test_join_puts_a_drifting_device_clock_on_the_launches():
    """Device timestamps that run 30 us a second fast against the launch
    records, from 3.5 us behind to 53.5 us ahead over two seconds, come
    back on the launches' clock: no operation before its launch."""
    evs, ms = [], 1_000_000
    for k in range(20):
        t = k * 100 * ms + 50 * ms
        lag = 5_000 - 30 * t // 1_000_000  # ns
        evs += [E("cudaLaunchKernel", False, t - lag, t - lag + 3_000, k),
                E(f"k{k}", True, t, t + 10_000, k)]
    j = spans.join(evs, [])
    assert j["raw_lead_us"] == pytest.approx(53.5, abs=0.1)
    assert j["drift_us_per_s"] == pytest.approx(-30.0, abs=0.1)
    assert j["launch_lead_us"] <= 0.01 and j["leads_over_5us"] == 0


def test_join_without_spans_names_gaps_by_the_next_operation():
    j = spans.join(EVENTS, [])
    names = {k for k, _ in j["idle_gaps"]}
    assert names == {"before " + trace.short(n) for n in
                     ("k_own", "k_hist", "Memcpy DtoH", "k_pod", "k_init",
                      "k_late", "Memcpy DtoD")}
    assert j["idle_s"] / 1e-9 == pytest.approx(8670)
    assert j["table"][spans.OUTSIDE]["syncs"] == 3


def test_readings_of_the_made_up_trace():
    ctx = {"spans": spans.join(EVENTS, RECORDS)}
    got = {name: f(ctx) for name, f in spans.METRICS.items()}
    assert got == pytest.approx({
        "route_host_ms": 0.004, "pod_step_host_ms": 0.003,
        "pod_step_chain": 4.0, "sieve_decide_host_ms": None,
        "sieve_sync_wait_ms": None, "rearm_ms": 0.0002,
        "rearm_host_ms": 0.002, "host_syncs": 2.0})
    lines = spans.lines(ctx["spans"])
    assert any(x.startswith("info span.route/route.count count 1 ")
               for x in lines)
    assert any(x.startswith("info span.outside_the_program ")
               for x in lines)


CELLS = [tiny_cell(name, t) for name in TINY for t in TRAFFIC]
HOST = {"route_host_ms", "pod_step_host_ms"}
BY_ALGO = {"threesieves": set(),
           "sievestreampp": {"sieve_decide_host_ms", "sieve_sync_wait_ms"}}


@pytest.fixture(scope="module")
def profiler_warm():
    """The profiler's first start in a process loads its library (about
    2 s on a CPU), which would eat a short window whole."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    prof.stop()


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_cell_reads_its_spans(tiny_root, profiler_warm, cell):
    """With hot tracing on, the host readings of the cell's layers have
    values; those needing the device's time are ``None`` on the CPU.
    The harness's result line keeps its keys, and every name the run
    wrapped is restored."""
    import torch.profiler

    base = (torch.profiler.profile, trace.read, harness.Cell.reader)
    out = spantrace.run_cell(tiny_root, cell, 2 ** 33 + 11, 0.5, hot=True,
                             device="cpu", log=io.StringIO())
    assert (torch.profiler.profile, trace.read,
            harness.Cell.reader) == base
    from repro_torch import obs

    assert not obs.hot_tracing()
    assert out["result"]["correct"], out["result"]["checks"]
    assert list(out["result"]) == ["correct", "attempted", "failed",
                                   "metrics", "device", "breakdown",
                                   "checks"]
    want = set(HOST) | BY_ALGO[cell.split("-")[0]]
    if cell.endswith(".tumbling"):
        want.add("rearm_host_ms")
    m = out["metrics"]
    assert {k for k, v in m.items() if v is not None} == want
    assert all(m[k] > 0 for k in want)
    assert out["records"] > 0 and out["dropped"] == 0
    assert out["traced"]["route_ms"] > 0


def test_tiny_traced_cell_with_hot_tracing_left_off(tiny_root,
                                                   profiler_warm):
    out = spantrace.run_cell(tiny_root, CELLS[0], 2 ** 33 + 11, 0.5,
                             hot=False, device="cpu", log=io.StringIO())
    assert out["result"]["correct"]
    assert out["records"] == 0
    assert all(v is None for v in out["metrics"].values())
