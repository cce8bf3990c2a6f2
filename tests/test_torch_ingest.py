# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of the ingest front end, held against the JAX package on the same
numpy inputs: ``host_route`` (the same four arrays, unknown ids, overflow
and padding included), the double-buffered ``IngestPipeline`` and
``SummarizerPod.serve`` (the same final pod state and stats, both routes),
the ``TaggedBuffer`` and the shedding ladder on one put/get script, the
sources, the fleet router and the socket wire.  Integers equal, floats
within rtol = atol = 1e-5."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ingest as jing  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.serve.summarize import SummarizerPod as JPod  # noqa: E402
from repro_torch import ingest as ting  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.serve.summarize import SummarizerPod as TPod  # noqa: E402

from _torch_port import assert_states_match  # noqa: E402

D = 5
SIDS = [10, 11, 12, 13]


def pods(name="threesieves", S=4, C=16, K=4):
    kw = dict(K=K, d=D, lengthscale=1.5, eps=0.3)
    if name == "threesieves":
        kw["T"] = 11
    ja = japi.make(name, backend="jnp", **kw)
    ta = tapi.make(name, backend="torch", device="cpu", **kw)
    jp, tp = JPod(algo=ja, sessions=S, chunk=C), TPod(algo=ta, sessions=S,
                                                      chunk=C, device="cpu")
    js, ts = jp.init(), tp.init()
    for sid in SIDS[:S]:
        js, _, _ = jp.admit(js, sid)
        ts, _, ok = tp.admit(ts, sid)
        assert bool(ok)
    return jp, tp, js, ts


def tagged(rng, n, sessions=SIDS):
    sids = rng.choice(np.asarray(sessions, np.int32), n).astype(np.int32)
    X = rng.randn(n, D).astype(np.float32)
    X[:, 0] = np.arange(n, dtype=np.float32)  # a fingerprint per item
    return sids, X


def ragged_feed(seed, sizes=(7, 32, 19, 40, 3, 26)):
    rng = np.random.RandomState(seed)
    return [tagged(rng, n) for n in sizes]


def no_wall(stats):
    return {k: v for k, v in stats.items() if k != "wall_s"}


# ------------------------------------------------------------- routing
@pytest.mark.parametrize("seed", range(6))
def test_host_route_matches_jax_host_route(seed):
    """Free and stale slots, unknown ids, padding, per-session overflow;
    also into a reused ``out`` buffer (rows past a count zeroed)."""
    rng = np.random.RandomState(seed)
    S, C = 6, 3
    sid_table = np.array([10, 11, -1, 12, 13, 14], np.int32)
    active = np.array([True, True, False, True, True, seed % 2 == 0])
    pool = np.asarray([10, 11, 12, 13, 14, 99, jing.PAD_SID], np.int32)
    sids = rng.choice(pool, 30).astype(np.int32)
    X = rng.randn(30, D).astype(np.float32)
    want = jing.host_route(sid_table, active, sids, X, C)
    got = ting.host_route(sid_table, active, sids, X, C)
    out = np.full((S, C, D), np.nan, np.float32)
    into = ting.host_route(sid_table, active, sids, X, C, out=out)
    assert into[0] is out
    for name, a, b, c in zip(("chunks", "counts", "unknown", "overflow"),
                             want, got, into):
        a, b, c = np.asarray(a), np.asarray(b), np.asarray(c)
        assert a.dtype == b.dtype == c.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, c, err_msg=name)
    assert int(got[2]) > 0 and int(got[3].sum()) > 0


def test_host_route_matches_the_pods_device_route():
    """The numpy twin gives what ``SummarizerPod.route`` gives."""
    _, tp, _, ts = pods(S=4, C=3)
    rng = np.random.RandomState(5)
    sids = rng.choice(np.asarray([10, 11, 12, 13, 99, -1], np.int32),
                      26).astype(np.int32)
    X = rng.randn(26, D).astype(np.float32)
    dev = tp.route(ts, torch.from_numpy(sids), torch.from_numpy(X))
    host = ting.host_route(ts.sid.numpy(), ts.active.numpy(), sids, X, 3)
    for a, b in zip(dev, host):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------ pipeline
@pytest.mark.parametrize("name", ["threesieves", "sievestreaming++",
                                  "quickstream"])
@pytest.mark.parametrize("feed_mode", ["source", "buffer"])
def test_pipeline_matches_jax_pipeline(name, feed_mode):
    """Ragged batches from a source repacked to the device batch, or
    drained from a filled and closed ``TaggedBuffer`` round-robin: the
    final pod state and the run's stats equal the JAX pipeline's."""
    feed = ragged_feed(2)
    jp, tp, js, ts = pods(name)

    def feed_of(pkg):
        if feed_mode == "source":
            return {"source": pkg.ReplaySource.from_batches(feed)}
        buf = pkg.TaggedBuffer(capacity=256, policy="block")
        for sids, X in feed:
            buf.put(sids, X)
        buf.close()
        return {"buffer": buf}

    jpipe = jing.IngestPipeline(jp, batch=32, metrics=None, **feed_of(jing))
    timings = []
    tpipe = ting.IngestPipeline(tp, batch=32, timings=timings,
                                **feed_of(ting))
    js, jstats = jpipe.run(js)
    ts, tstats = tpipe.run(ts)
    assert no_wall(jstats) == no_wall(tstats)
    assert tstats["batches"] == 4 and tstats["padded"] == 1
    assert_states_match(js, ts, f"{name} {feed_mode}")
    assert len(timings) == 4
    assert all(t["source_ms"] >= 0 and t["stage_ms"] >= 0 for t in timings)


def test_pipeline_equals_the_direct_ingest_loop():
    """Same stream, two strategies: the pipeline's final state (routed by
    ``host_route``) equals ``pod.ingest`` per batch (routed by
    ``SummarizerPod.route``), bit for bit."""
    _, tp, _, ts0 = pods("sievestreaming")
    feed = ragged_feed(3, sizes=(32,) * 5)
    direct = ts0
    for sids, X in feed:
        direct, _ = tp.ingest(direct, torch.from_numpy(sids),
                              torch.from_numpy(X))
    from repro_torch.tree import leaves_with_keys

    _, tp, _, ts = pods("sievestreaming")
    pipe = ting.IngestPipeline(tp, source=ting.ReplaySource.from_batches(
        feed), batch=32)
    ts, stats = pipe.run(ts)
    a, b = leaves_with_keys(direct), leaves_with_keys(ts)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert stats["items"] == 160


@pytest.mark.parametrize("name", ["threesieves", "salsa"])
def test_serve_matches_jax_serve(name):
    """``serve`` with a drift check every two batches and a batch cap:
    states, stats and the drift resets equal the JAX pod's."""
    feed = ragged_feed(4, sizes=(32,) * 7)
    jp, tp, js, ts = pods(name)
    jpipe = jing.IngestPipeline(jp, source=jing.ReplaySource.from_batches(
        feed), batch=32)
    tpipe = ting.IngestPipeline(tp, source=ting.ReplaySource.from_batches(
        feed), batch=32)
    # Salsa's three rules insert more per item than one sieve does
    kw = dict(max_batches=5, drift_every=2, min_items=4,
              min_rate={"salsa": 3.0}.get(name, 0.9))
    js, jstats = jp.serve(js, jpipe, **kw)
    ts, tstats = tp.serve(ts, tpipe, **kw)
    assert no_wall(jstats) == no_wall(tstats)
    assert tstats["batches"] == 5
    assert int(ts.resets.sum()) > 0
    assert_states_match(js, ts, "serve")
    # resumable: the rest of the feed, without drift checks
    js, jstats = jp.serve(js, jpipe)
    ts, tstats = tp.serve(ts, tpipe)
    assert no_wall(jstats) == no_wall(tstats) and tstats["batches"] == 2
    assert tpipe.exhausted
    assert_states_match(js, ts, "serve, rest")


def test_serve_takes_dict_stats_from_the_latest_run():
    _, tp, _, ts = pods()
    seen = []

    def on_sync(state):
        seen.append(int(state.items.sum()))
        return {"committed": {"items": seen[-1]}}

    pipe = ting.IngestPipeline(tp, source=ting.ReplaySource.from_batches(
        ragged_feed(5, sizes=(32,) * 4)), batch=32, on_sync=on_sync)
    ts, stats = tp.serve(ts, pipe, drift_every=1, min_items=10 ** 9)
    assert stats["batches"] == 4 and stats["items"] == 128
    assert stats["committed"] == {"items": seen[-1]} == {"items": 128}


def test_pipeline_buffer_mode_with_feeder_thread():
    _, tp, _, ts = pods()
    feed = ragged_feed(6)
    buf = ting.TaggedBuffer(capacity=64, policy="block")
    pipe = ting.IngestPipeline(tp, buffer=buf, batch=32, get_timeout=30.0)
    t = pipe.feed_from(ting.ReplaySource.from_batches(feed))
    ts, stats = pipe.run(ts)
    t.join(timeout=30.0)
    assert not t.is_alive()
    assert stats["items"] == sum(len(s) for s, _ in feed)
    assert int(ts.items.sum()) == stats["items"]


def test_pipeline_surfaces_producer_failure():
    _, tp, _, ts = pods()

    class Broken(ting.Source):
        def batches(self):
            yield tagged(np.random.RandomState(0), 8)
            raise ConnectionError("wire cut")

    buf = ting.TaggedBuffer(capacity=64, policy="block")
    pipe = ting.IngestPipeline(tp, buffer=buf, batch=8, get_timeout=30.0)
    pipe.feed_from(Broken())
    with pytest.raises(RuntimeError, match="producer failed"):
        pipe.run(ts)


def test_pipeline_refusals():
    _, tp, _, _ = pods()
    src = ting.ReplaySource.from_batches(ragged_feed(0))
    with pytest.raises(ValueError, match="exactly one"):
        ting.IngestPipeline(tp)
    with pytest.raises(ValueError, match="buffer mode"):
        ting.IngestPipeline(tp, source=src).feed_from(src)


def test_pipeline_records_at_the_sync_boundary():
    """The run's counters and the drained device ledgers land in the
    registry once per run, as the JAX pipeline's do."""
    reg = tobs.MetricsRegistry()
    _, tp, _, ts = pods()
    pipe = ting.IngestPipeline(tp, source=ting.ReplaySource.from_batches(
        ragged_feed(7)), batch=32, metrics=reg, pod_id="p0")
    ts, stats = pipe.run(ts)
    snap = reg.snapshot()
    assert snap.get("ingest_items_total", pod="p0") == stats["items"]
    assert snap.get("pod_items_total", pod="p0") == int(ts.items.sum())
    assert snap.get("drops_total", layer="pod", reason="unknown",
                    pod="p0") == 0


# ---------------------------------------------------- buffer, shedding
def buffer_script(mod, policy, shed, rate):
    """One put/get script with an injected clock -> everything the
    buffer reports, in host types."""
    clock = [0.0]
    # a block-policy buffer never fills here: no put waits on a consumer
    kw = dict(capacity=128 if policy == "block" else 16, policy=policy,
              clock=lambda: clock[0])
    if shed:
        kw["shed"] = mod.ShedPolicy(lo=0.25, hi=0.6, p_floor=0.05,
                                    clip_mult=1.0, seed=3)
    if rate:
        kw["rate_limit"] = mod.RateLimit(rate=4.0, burst=6.0)
    buf = mod.TaggedBuffer(**kw)
    rng = np.random.RandomState(9)
    out = []
    for step in range(8):
        clock[0] = 0.5 * step
        sids, X = tagged(rng, 11, [1, 2, 3, 3, 3])
        out.append(("put", buf.put(sids, X)))
        got = buf.get(5, pad_to=6, d=D, timeout=5.0)
        out.append(("get", got[0].tolist(), got[1].tolist()))
    buf.quiesce([3])
    buf.put(*tagged(rng, 6, [3, 1]))
    out.append(("quiesced", buf.get(20, timeout=5.0)[0].tolist()))
    buf.release([3])
    buf.close()
    while (got := buf.get(4)) is not None:
        out.append(("drain", got[0].tolist(), got[1].tolist()))
    out.append(("ledgers", buf.drop_counts(), buf.throttled_counts(),
                buf.shed_counts(), buf.shed_policy_counts(),
                buf.total_drops(), buf.total_throttled(),
                buf.shed_rung(), buf.shed_rung_changes()))
    return out


@pytest.mark.parametrize("policy", ["block", "drop-oldest", "drop-newest"])
@pytest.mark.parametrize("shed,rate", [(False, False), (True, False),
                                       (False, True), (True, True)])
def test_tagged_buffer_matches_jax(policy, shed, rate):
    want = buffer_script(jing, policy, shed, rate)
    got = buffer_script(ting, policy, shed, rate)
    assert got == want


def test_shed_policy_matches_jax():
    jp = jing.ShedPolicy(lo=0.5, hi=0.8, seed=0)
    tp = ting.ShedPolicy(lo=0.5, hi=0.8, seed=0)
    assert ting.RUNGS == jing.RUNGS
    for size in (0, 49, 50, 79, 80, 100):
        assert jp.rung(size, 100) == tp.rung(size, 100)
        for depth in (0, 3, 20):
            assert (jp.decide(size=size, capacity=100, depth=depth,
                              n_live=4)
                    == tp.decide(size=size, capacity=100, depth=depth,
                                 n_live=4))
    jb = jing.TokenBucket(jing.RateLimit(rate=2.0, burst=2.0), now=0.0)
    tb = ting.TokenBucket(ting.RateLimit(rate=2.0, burst=2.0), now=0.0)
    for t in (0.0, 0.0, 0.0, 0.4, 0.5, 10.0, 10.0, 10.0):
        assert jb.allow(t) == tb.allow(t)


# -------------------------------------------------------------- sources
def test_sources_match_jax():
    """Replay slicing, seeded drift (numpy's stream, value for value) and
    Bernoulli thinning give the reference's batches."""
    rng = np.random.RandomState(1)
    sids, X = tagged(rng, 50)
    pairs = [
        (jing.ReplaySource(sids, X, batch=12),
         ting.ReplaySource(sids, X, batch=12)),
        (jing.DriftSource(seed=4, n_sessions=5, batch=9, d=D,
                          drift_per_batch=0.3, n_batches=4),
         ting.DriftSource(seed=4, n_sessions=5, batch=9, d=D,
                          drift_per_batch=0.3, n_batches=4)),
        (jing.SubsampleSource(jing.ReplaySource(sids, X, batch=10),
                              rate=0.4, seed=2),
         ting.SubsampleSource(ting.ReplaySource(sids, X, batch=10),
                              rate=0.4, seed=2)),
    ]
    for js, ts in pairs:
        jb, tb = list(js), list(ts)
        assert len(jb) == len(tb) > 0
        for (a, b), (c, d) in zip(jb, tb):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
            assert c.dtype == np.int32 and d.dtype == np.float32


@pytest.mark.timeout(60)
def test_socket_source_roundtrip_localhost():
    """Frames of the port's producer half read back by the JAX
    ``SocketSource`` and the other way round (one wire format)."""
    rng = np.random.RandomState(3)
    frames = [tagged(rng, n) for n in (5, 0, 9)]
    for listen, speak in ((ting, jing), (jing, ting)):
        with listen.SocketSource(port=0, timeout=20.0) as src:
            def producer():
                with speak.connect_producer(src.host, src.port) as sock:
                    for s, x in frames:
                        speak.send_frame(sock, s, x)

            t = threading.Thread(target=producer, daemon=True)
            t.start()
            got = list(src)
            t.join(timeout=20.0)
            assert not t.is_alive()
        want = [f for f in frames if len(f[0])]
        assert len(got) == len(want)
        for (a, b), (c, d) in zip(want, got):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_pod_router_matches_jax():
    """The fleet front end: fan-out by table, unrouted drops, quiesce and
    migrate, the same buffers as the JAX router's."""
    routers = []
    for mod in (jing, ting):
        pipes = {}
        for pid in (0, 1):
            if mod is jing:
                jp, _, _, _ = pods()
                pod = jp
            else:
                _, pod, _, _ = pods()
            pipes[pid] = mod.IngestPipeline(
                pod, buffer=mod.TaggedBuffer(capacity=64, policy="block"),
                batch=8)
        r = mod.PodRouter(pipes)
        r.assign([10, 11], 0)
        r.assign([12, 13], 1)
        rng = np.random.RandomState(8)
        r.put(*tagged(rng, 20, [10, 11, 12, 13, 77]))
        r.quiesce([11])
        r.put(*tagged(rng, 10, [11, 12]))
        moved = r.migrate([11], 1)
        r.unassign([13])
        r.put(*tagged(rng, 6, [13, 10]))
        routers.append((r, moved))
    (jr, jm), (tr, tm) = routers
    assert jm == tm > 0
    assert jr.table() == tr.table()
    assert jr.drops_unrouted == tr.drops_unrouted
    for pid in (0, 1):
        a = jr.pipelines[pid].buffer.get(100)
        b = tr.pipelines[pid].buffer.get(100)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
