# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of the telemetry layer (``repro/obs``: registry, spans, drain) and
the lockdep sanitizer (``repro/concurrency``), held against the JAX
package: the same calls give the same snapshot JSON and Prometheus text,
the drains read the port's ``PodState`` as the reference reads its own,
spans are a no-op while ``torch.compile`` traces, and lock inversions
raise as they do there."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.concurrency import lockdep as jlockdep  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.concurrency import lockdep as tlockdep  # noqa: E402

from _torch_port import compile_budget  # noqa: E402, F401  (fixture)


def pod_families(reg):
    """A snapshot's families without the compile and build accounting,
    which differs by package (``repro/obs/jaxbridge.py`` counts XLA
    compiles, the port's ``kernels/build.py`` nvcc builds)."""
    return [f for f in reg.snapshot().families
            if not f["name"].startswith(("jax_", "xla_", "torch_compile",
                                         "kernel_build"))]


@pytest.fixture
def fresh():
    regs = jobs.reset_default_registry(), tobs.reset_default_registry()
    for rec in (jobs.get_recorder(), tobs.get_recorder()):
        rec.clear()
    yield regs
    jobs.reset_default_registry()
    tobs.reset_default_registry()
    for rec in (jobs.get_recorder(), tobs.get_recorder()):
        rec.clear()


def _script(mod, reg):
    """The same registry calls on either package."""
    c = reg.counter("reqs_total", "requests", ("pod",))
    c.labels(pod="0").inc()
    c.labels(pod="0").inc(2.5)
    c.labels(pod="1").inc(5)
    g = reg.gauge("depth", "queue depth")
    g.set(7)
    g.dec(2)
    h = reg.histogram("lat_seconds", "latency", ("route",))
    for v in (0.004, 0.2, 99.0, 1e-9):
        h.labels(route="host").observe(v)
    reg.histogram("custom_seconds", "custom", (),
                  buckets=(0.5, 1.0)).observe(0.7)
    mod.drain.observe_total("led_total", {"pod": "0"}, 10, registry=reg)
    mod.drain.observe_total("led_total", {"pod": "0"}, 4, registry=reg)
    return reg.snapshot()


def test_registry_snapshot_and_prometheus_equal_jax(fresh):
    jreg, treg = fresh
    js, ts = _script(jobs, jreg), _script(tobs, treg)
    assert ts.families == js.families
    assert ts.to_json() == js.to_json()
    assert ts.to_prometheus() == js.to_prometheus()
    assert treg.to_prometheus() == jreg.to_prometheus()
    back = tobs.MetricsSnapshot.from_json(ts.to_json())
    assert back.families == ts.families
    assert ts.get("led_total", pod="0") == 14  # 10, then a reset to 4


def test_registry_contracts_and_null(fresh):
    _, reg = fresh
    fam = reg.counter("x_total", "x", ("pod",))
    with pytest.raises(ValueError, match="label"):
        fam.labels(shard="0")
    with pytest.raises(ValueError, match="cannot decrease"):
        fam.labels(pod="0").inc(-1)
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x_total", "x", ("pod",))
    n = tobs.NULL
    assert not n.enabled and n.snapshot().families == []
    assert tobs.get_registry(n) is n and tobs.get_registry(None) is not n


def test_spans_nest_and_record_like_jax(fresh):
    jreg, treg = fresh
    out = []
    for mod in (jobs, tobs):
        rec = mod.get_recorder()
        with rec.span("outer", src="0"):
            with rec.span("inner") as sp:
                sp.set(items=3)
            with rec.span("refusal") as sp:
                sp.set_outcome("refused")
        with pytest.raises(RuntimeError, match="boom"):
            with rec.span("failing"):
                raise RuntimeError("boom")
        # ids count every span of the process: compare them relative to
        # the first one of this script
        base = min(e["span_id"] for e in rec.events)
        out.append([{"name": e["name"], "span_id": e["span_id"] - base,
                     "parent_id": None if e["parent_id"] is None
                     else e["parent_id"] - base, "depth": e["depth"],
                     "outcome": e["outcome"], "attrs": e["attrs"]}
                    for e in rec.events])
    assert out[0] == out[1]
    snap = treg.snapshot()
    assert snap.get("spans_total", name="refusal", outcome="refused") == 1
    assert snap.get("spans_total", name="failing", outcome="error") == 1


def test_span_is_a_noop_while_torch_compile_traces(fresh, tmp_path):
    """Entering a span inside a ``torch.compile`` trace records nothing
    and breaks nothing; the same function run eagerly records once."""
    rec = tobs.get_recorder()

    def f(x):
        with tobs.span("traced-span"):
            return x * 2

    compiled = torch.compile(f, backend="eager", fullgraph=True)
    np.testing.assert_array_equal(compiled(torch.arange(3)).numpy(),
                                  [0, 2, 4])
    assert rec.find("traced-span") == []
    f(torch.arange(3))
    assert len(rec.find("traced-span")) == 1
    path = rec.dump_jsonl(str(tmp_path / "spans.jsonl"))
    assert path.read_text().count("traced-span") == 1


# ------------------------------------------------------- compile budget
def test_budget_fails_on_a_fresh_compile_and_passes_on_a_cache_hit(
        fresh, compile_budget):
    f = torch.compile(lambda x: x - 7, backend="eager")
    x = torch.arange(5)
    with pytest.raises(AssertionError, match="compile_budget: 1 fresh"):
        with compile_budget.budget(0):
            f(x)
    with compile_budget.budget(0):  # the same shapes: served from cache
        f(x)
        f(x + 1)
    assert compile_budget.compiles == 1


def test_kernel_builds_are_counted(fresh):
    """Each nvcc build is a counted stall, labelled by its source."""
    from repro_torch.kernels import build

    _, treg = fresh
    build._record_build("ssd_chunk.cu", 1.5)
    build._record_build("ssd_chunk.cu", 2.0)
    build._record_build("pod_step.cu", 0.5)
    snap = treg.snapshot()
    assert snap.get("kernel_build_total", source="ssd_chunk.cu") == 2
    assert snap.get("kernel_build_total", source="pod_step.cu") == 1
    assert snap.get("kernel_build_seconds", source="ssd_chunk.cu") == 3.5


def test_drain_pod_reads_the_ports_pod_state_like_jax(fresh):
    """``drain_pod`` on the port's PodState (torch ledgers) and on the
    JAX pod's, after the same admits and ingest: the same metrics."""
    import jax.numpy as jnp

    from repro.core import api as japi
    from repro.serve.summarize import SummarizerPod as JPod
    from repro_torch.core import api as tapi
    from repro_torch.serve.summarize import SummarizerPod as TPod

    jreg, treg = fresh
    kw = dict(K=4, d=3, lengthscale=1.0, eps=0.3)
    jp = JPod(algo=japi.make("sievestreaming", backend="jnp", **kw),
              sessions=3, chunk=4)
    tp = TPod(algo=tapi.make("sievestreaming", backend="torch",
                             device="cpu", **kw), sessions=3, chunk=4,
              device="cpu")
    js, ts = jp.init(), tp.init()
    for sid in (1, 2):
        js, _, _ = jp.admit(js, sid)
        ts, _, _ = tp.admit(ts, sid)
    rng = np.random.default_rng(0)
    sids = np.array([1, 1, 1, 1, 1, 2, 9, -1], np.int32)
    X = rng.standard_normal((8, 3)).astype(np.float32)
    js, _ = jp.ingest(js, jnp.asarray(sids), jnp.asarray(X))
    ts, _ = tp.ingest(ts, torch.from_numpy(sids), torch.from_numpy(X))
    jp.drain_metrics(js, pod="7")
    tp.drain_metrics(ts, pod="7")
    assert pod_families(treg) == pod_families(jreg)
    snap = treg.snapshot()
    assert snap.get("drops_total", layer="pod", reason="overflow",
                    pod="7") == 1
    assert snap.get("drops_total", layer="pod", reason="unknown",
                    pod="7") == 1
    assert snap.get("pod_active_sessions", pod="7") == 2


def test_drain_buffer_and_router_like_jax(fresh):
    from repro import ingest as jing
    from repro_torch import ingest as ting

    jreg, treg = fresh
    for mod, obsmod in ((jing, jobs), (ting, tobs)):
        buf = mod.TaggedBuffer(capacity=8, policy="drop-newest",
                               shed=mod.ShedPolicy(lo=0.25, hi=0.5,
                                                   p_floor=0.01,
                                                   clip_mult=1.0, seed=0))
        buf.put([0] * 20 + [1] * 3, np.zeros((23, 2), np.float32))
        obsmod.drain.drain_buffer(buf, pod="b")
    assert pod_families(treg) == pod_families(jreg)


# ------------------------------------------------------------- lockdep
@pytest.fixture
def lockdep_on(monkeypatch):
    monkeypatch.setenv("REPRO_LOCKDEP", "1")
    jlockdep.reset()
    tlockdep.reset()
    yield
    jlockdep.reset()
    tlockdep.reset()


def test_lockdep_factories_follow_the_env(monkeypatch):
    monkeypatch.delenv("REPRO_LOCKDEP", raising=False)
    assert not isinstance(tlockdep.make_lock("X"), tlockdep.LockdepLock)
    monkeypatch.setenv("REPRO_LOCKDEP", "1")
    assert isinstance(tlockdep.make_lock("X"), tlockdep.LockdepLock)
    assert isinstance(tlockdep.make_rlock("X"), tlockdep.LockdepRLock)


def test_lockdep_inversion_raises_like_jax(lockdep_on):
    """An ABBA order raises ``LockOrderError`` on the second order, and
    both packages record the same edges."""
    got = []
    for mod in (jlockdep, tlockdep):
        a, b = mod.make_lock("A._lock"), mod.make_lock("B._lock")
        with a:
            with b:
                pass
        with pytest.raises(mod.LockOrderError):
            with b:
                with a:
                    pass
        got.append(sorted(mod.edges()))
    assert got[0] == got[1] == [("A._lock", "B._lock")]


def test_lockdep_condition_and_rlock(lockdep_on):
    lock = tlockdep.make_lock("Buf._lock")
    cond = threading.Condition(lock)
    done = []

    def waiter():
        with cond:
            cond.wait_for(lambda: done, timeout=10.0)

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    with cond:
        done.append(True)
        cond.notify_all()
    t.join(timeout=10.0)
    assert not t.is_alive()
    r = tlockdep.make_rlock("R._lock")
    with r:
        with r:
            pass
    with pytest.raises(tlockdep.LockOrderError):
        plain = tlockdep.make_lock("P._lock")
        with plain:
            with plain:
                pass
