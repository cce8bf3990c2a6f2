# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The port's hot spans and counters (``repro_torch.obs.hot_span``): off
they are one shared no-op; on, the ingest path's layers record the spans
``portbench/spans.py`` joins to the device trace, on the Unix clock,
into a bounded buffer that counts its drops.  Importing the pod leaves
``torch._dynamo`` unloaded."""
import json
import subprocess
import sys
import threading
import time
import tracemalloc

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.obs import spans as spans_mod  # noqa: E402

ROUTE_CHILDREN = ["route.match", "route.sort", "route.position",
                  "route.scatter", "route.count"]


@pytest.fixture
def rec():
    r = obs.get_recorder()
    r.trace_hot(False)
    r.clear()
    yield r
    r.trace_hot(False)
    r.clear()


def _pod(algo="threesieves", sessions=3, chunk=8):
    from repro_torch.core import api
    from repro_torch.serve.summarize import SummarizerPod

    kw = dict(K=4, d=3, lengthscale=1.0, eps=0.3)
    if algo == "threesieves":
        kw["T"] = 5
    pod = SummarizerPod(algo=api.make(algo, backend="torch", device="cpu",
                                      **kw),
                        sessions=sessions, chunk=chunk, device="cpu")
    state = pod.init()
    for sid in (1, 2):
        state, _, _ = pod.admit(state, sid)
    g = torch.Generator().manual_seed(0)
    sids = torch.tensor([1, 1, 2, 1, 2, 9, -1, 1, 2, 2, 1, 1],
                        dtype=torch.int32)
    return pod, state, sids, torch.randn(12, 3, generator=g)


def _spans(records):
    return [r for r in records if r["kind"] == "hot_span"]


def _children(records, parent):
    return [r["name"] for r in _spans(records)
            if r["parent_id"] == parent["span_id"]]


def test_hot_span_off_is_one_shared_noop_that_allocates_nothing(rec):
    assert not obs.hot_tracing()
    first = obs.hot_span("route")
    assert obs.hot_span("pod_step") is first is spans_mod.NO_SPAN

    def spans():
        for _ in range(10_000):
            with obs.hot_span("route"):
                obs.hot_count("pod_step_passes", 1)

    def bare(cm=first):  # the loop and the ``with`` statement alone
        for _ in range(10_000):
            with cm:
                pass

    peaks = []
    for body in (spans, bare, spans, bare):
        tracemalloc.start()
        try:
            before = tracemalloc.get_traced_memory()[0]
            body()
            peaks.append(tracemalloc.get_traced_memory()[1] - before)
        finally:
            tracemalloc.stop()
    assert peaks[2] <= peaks[3]  # nothing beyond the statement's own
    assert rec.trace_hot(False) == [] and rec.hot_records == []


def test_route_records_one_route_span_with_its_five_children(rec):
    pod, state, sids, X = _pod()
    rec.trace_hot(True)
    pod.route(state, sids, X)
    pod.route(state, sids, X)
    records = rec.trace_hot(False)
    roots = [r for r in _spans(records) if r["parent_id"] is None]
    assert [r["name"] for r in roots] == ["route", "route"]
    assert [r["batch"] for r in roots] == [0, 1]
    for root in roots:
        kids = [r for r in _spans(records)
                if r["parent_id"] == root["span_id"]]
        assert [k["name"] for k in kids] == ROUTE_CHILDREN
        for k in kids:
            assert k["path"] == "route/" + k["name"] and k["depth"] == 1
            assert k["batch"] == root["batch"]
            assert root["start_ns"] <= k["start_ns"] <= k["end_ns"] \
                <= root["end_ns"]


@pytest.mark.parametrize("fused", [False, True])
def test_ingest_routed_records_pod_step_and_its_children(rec, monkeypatch,
                                                         fused):
    """The plain route's ``pod_step`` holds the two ledger spans; the
    fused route (its kernel stood in for by a fake that makes two passes
    a session) adds the tables, the kernel and the unpack, and keeps the
    ``pod_step_passes`` counter."""
    from repro_torch.kernels.pod_step import ops

    if fused:
        def fake(chunks, feats, L, Linv, ints, flts, *, a, tier, window):
            iout = ints[:, :5].clone()
            iout[:, 3] += 2
            return iout, flts[:, 0].clone()

        monkeypatch.setattr(ops, "resolve", lambda *a, **k: "cuda")
        monkeypatch.setattr(ops, "pod_step_cuda", fake)
    pod, state, sids, X = _pod()
    routed = pod.route(state, sids, X)
    rec.trace_hot(True)
    pod.ingest_routed(state, *routed)
    records = rec.trace_hot(False)
    (root,) = [r for r in _spans(records) if r["parent_id"] is None]
    assert root["name"] == "pod_step"
    want = (["pod_step.ledgers", "pod_step.tables", "pod_step.kernel",
             "pod_step.unpack", "pod_step.ledgers"] if fused
            else ["pod_step.ledgers", "pod_step.ledgers"])
    assert _children(records, root) == want
    counters = [r for r in records if r["kind"] == "hot_counter"]
    assert [(c["name"], c["value"], c["batch"]) for c in counters] == (
        [("pod_step_passes", 2, 0)] if fused else [])


def test_sieve_rounds_are_the_rounds_run_slots_made(rec, monkeypatch):
    from repro_torch.core.sieve_family import StackedSieve

    pod, state, sids, X = _pod("sievestreaming++")
    routed = pod.route(state, sids, X)
    calls = []
    gains = StackedSieve._gains_slots

    def counted(self, sub, xs):
        calls.append(xs.shape[0])
        return gains(self, sub, xs)

    monkeypatch.setattr(StackedSieve, "_gains_slots", counted)
    rec.trace_hot(True)
    pod.ingest_routed(state, *routed)
    records = rec.trace_hot(False)
    rounds = [r for r in _spans(records) if r["name"] == "sieve.round"]
    assert len(calls) >= 2 and len(rounds) == len(calls)
    assert {r["path"] for r in rounds} == {"pod_step/sieve.round"}
    for r in rounds:
        assert _children(records, r) == ["sieve.gain", "sieve.decide",
                                         "sieve.sync"]
    # the cursors and the first nonzero are a sync of pod_step's own
    assert sum(r["path"] == "pod_step/sieve.sync"
               for r in _spans(records)) == 1


def test_reset_slots_records_rearm(rec):
    pod, state, _, _ = _pod()
    rec.trace_hot(True)
    pod.reset_slots(state, state.active)
    records = rec.trace_hot(False)
    assert [r["path"] for r in _spans(records)] == [
        "rearm", "rearm/rearm.init", "rearm/rearm.select"]


def test_the_buffer_is_bounded_and_counts_its_drops(rec, monkeypatch):
    monkeypatch.setattr(spans_mod, "MAX_HOT_RECORDS", 5)
    rec.trace_hot(True)
    for _ in range(4):
        with obs.hot_span("outer"):
            with obs.hot_span("inner"):
                pass
    records = rec.trace_hot(False)
    assert len(_spans(records)) == 5
    assert rec.hot_dropped == 3
    (drop,) = [r for r in records if r["kind"] == "hot_counter"]
    assert drop["name"] == "hot_spans_dropped" and drop["value"] == 3


def test_spans_are_on_the_unix_clock_per_thread(rec, tmp_path):
    """``start_ns`` / ``end_ns`` on ``time.time_ns``'s clock; each thread
    nests in its own buffer; a fresh trace drops the last one's records;
    ``dump_jsonl`` writes them after the control-plane events."""
    rec.trace_hot(True)
    rec.trace_hot(False)
    lo = time.time_ns()
    rec.trace_hot(True)

    def work():
        with obs.hot_span("route"):
            with obs.hot_span("route.match"):
                time.sleep(0.002)

    t = threading.Thread(target=work)
    t.start()
    t.join()
    work()
    records = rec.trace_hot(False)
    hi = time.time_ns()
    assert len(records) == 4
    threads = {r["thread"] for r in records}
    assert len(threads) == 2
    for r in records:
        assert lo <= r["start_ns"] <= r["end_ns"] <= hi
        if r["name"] == "route.match":
            assert r["end_ns"] - r["start_ns"] >= 2_000_000
            assert r["path"] == "route/route.match"
    assert [r["batch"] for r in records if r["name"] == "route"] == [0, 0]
    with obs.span("handoff"):
        pass
    lines = [json.loads(x) for x in
             rec.dump_jsonl(str(tmp_path / "s.jsonl")).read_text()
             .splitlines()]
    assert [x.get("kind") for x in lines] == [None] + ["hot_span"] * 4


def test_importing_the_pod_leaves_dynamo_unloaded():
    code = ("import sys, repro_torch.serve.summarize, repro_torch.core.api,"
            " repro_torch.kernels.pod_step, repro_torch.kernels.rbf_gain; "
            "from repro_torch import obs; obs.hot_span('route'); "
            "print('torch._dynamo' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "False"
