# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of the pub/sub front end (``ingest/pubsub.py``), held against the
JAX package on the CPU: the twins of tests/test_pubsub.py (the broker's
partitions, offsets, retention and trim; the wire's resume handshake and
duplicate handling; the front end's pump / commit / resume; commits at
the port pipeline's ``on_sync``; a producer reconnect mid-stream; the
overload ladder), the partition hash and the frames byte for byte, and
the same producer script through both packages' front ends into a pod
(the same final state)."""
import socket

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ingest as jing  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.serve.summarize import SummarizerPod as JPod  # noqa: E402
from repro_torch import ingest as ting  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.ingest.pubsub import _read_ack, publish_frame  # noqa
from repro_torch.serve.summarize import SummarizerPod as TPod  # noqa: E402

from _torch_port import assert_states_match  # noqa: E402


# ------------------------------------------------------------------- broker
def test_partition_of_matches_jax_stable_and_spread():
    for n in (1, 3, 8, 13):
        parts = [ting.partition_of(sid, n) for sid in range(-5, 300)]
        assert parts == [jing.partition_of(sid, n) for sid in range(-5, 300)]
    parts = [ting.partition_of(sid, 8) for sid in range(256)]
    assert all(0 <= p < 8 for p in parts) and len(set(parts)) == 8


def test_broker_offsets_fifo_and_read():
    br = ting.PubSubBroker(n_partitions=4)
    sids = np.array([5, 5, 9, 5], np.int32)
    X = np.arange(16, dtype=np.float32).reshape(4, 4)
    placed = br.publish(sids, X)
    assert placed == jing.PubSubBroker(n_partitions=4).publish(sids, X)
    p5 = ting.partition_of(5, 4)
    got_s, got_x, nxt = br.read(p5, 0, 16)
    assert np.array_equal(got_x[got_s == 5], X[sids == 5])
    assert nxt == br.high_water(p5)
    s2, _, n2 = br.read(p5, nxt, 16)
    assert len(s2) == 0 and n2 == nxt


def test_broker_trim_and_retention_are_loud():
    br = ting.PubSubBroker(n_partitions=1, retention=4)
    for i in range(8):
        br.publish(np.array([1], np.int32), np.full((1, 2), i, np.float32))
    assert br.depths() == [4] and br.evicted[0] == 4 and br.base(0) == 4
    with pytest.raises(LookupError, match="outran retention"):
        br.read(0, 0, 16)
    s, x, nxt = br.read(0, 4, 16)
    assert x[0, 0] == 4.0 and nxt == 8
    assert br.trim(0, 6) == 2 and br.base(0) == 6
    with pytest.raises(ValueError, match="n_partitions"):
        ting.PubSubBroker(n_partitions=0)
    with pytest.raises(ValueError, match="retention"):
        ting.PubSubBroker(retention=0)


# --------------------------------------------------------------------- wire
def test_publish_frame_bytes_match_jax():
    """The PUB frame on the wire is the JAX package's, byte for byte."""
    sids = np.array([3, 1, 4], np.int32)
    X = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    frames = []
    for fn in (ting.publish_frame, jing.publish_frame):
        a, b = socket.socketpair()
        with a, b:
            fn(a, 42, sids, X)
            frames.append(b.recv(1 << 16))
    assert frames[0] == frames[1] and len(frames[0]) == 20 + 12 + 60


@pytest.mark.timeout(60)
def test_publisher_reconnect_replays_exactly_once():
    br = ting.PubSubBroker(n_partitions=2)
    with ting.PubSubListener(br, timeout=10.0) as lis:
        pub = ting.Publisher("127.0.0.1", lis.port, producer_id=7,
                             timeout=10.0)
        total = 0
        for i in range(3):
            pub.publish(np.arange(4, dtype=np.int32),
                        np.full((4, 3), i, np.float32))
            total += 4
        pub._sock.close()  # the wire dies mid-stream
        frame = (np.array([9], np.int32), np.full((1, 3), 99, np.float32))
        with pytest.raises(OSError):
            pub.publish(*frame)  # stays in the replay window
        pub.connect()  # prunes seqs 1-3, replays seq 4
        assert pub.reconnects == 1
        pub.close()
        assert sum(br.high_water(p) for p in range(2)) == total + 1
        assert lis.last_seq[7] == 4


@pytest.mark.timeout(60)
def test_listener_skips_duplicate_seq_and_acks_durable():
    br = ting.PubSubBroker(n_partitions=1)
    with ting.PubSubListener(br, timeout=10.0) as lis:
        pub = ting.Publisher("127.0.0.1", lis.port, producer_id=3,
                             timeout=10.0)
        pub.publish(np.array([1, 1], np.int32), np.zeros((2, 2), np.float32))
        hw = br.high_water(0)
        publish_frame(pub._sock, 1, np.array([1, 1], np.int32),
                      np.zeros((2, 2), np.float32))
        assert _read_ack(pub._sock) == 1
        pub.close()
        assert br.high_water(0) == hw
        assert lis.duplicates == 1


@pytest.mark.timeout(60)
def test_two_producers_interleave_with_independent_seqs():
    br = ting.PubSubBroker(n_partitions=2)
    with ting.PubSubListener(br, timeout=10.0) as lis:
        a = ting.Publisher("127.0.0.1", lis.port, producer_id=1,
                           timeout=10.0)
        b = ting.Publisher("127.0.0.1", lis.port, producer_id=2,
                           timeout=10.0)
        for i in range(3):
            a.publish(np.array([10], np.int32),
                      np.full((1, 2), i, np.float32))
            b.publish(np.array([11], np.int32),
                      np.full((1, 2), 10 + i, np.float32))
        a.close()
        b.close()
        assert lis.last_seq == {1: 3, 2: 3}
        assert sum(br.high_water(p) for p in range(2)) == 6


# ----------------------------------------------------------------- frontend
class _RecordingRouter:
    def __init__(self):
        self.items = []

    def put(self, sids, X, timeout=None):
        for sid, row in zip(np.asarray(sids).tolist(), np.asarray(X)):
            self.items.append((sid, tuple(row.tolist())))


def _publish_rounds(br, n_rounds=4, batch=8, d=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_rounds):
        sids = rng.integers(0, 16, size=batch).astype(np.int32)
        X = rng.normal(size=(batch, d)).astype(np.float32)
        br.publish(sids, X)
        out += [(int(s), tuple(r.tolist())) for s, r in zip(sids, X)]
    return out


def test_frontend_pump_commit_trim_and_exact_resume():
    br = ting.PubSubBroker(n_partitions=4)
    published = _publish_rounds(br)
    router = _RecordingRouter()
    fe = ting.PubSubFrontEnd(br, router, read_batch=5)
    assert fe.pump(max_items=10) == 10
    committed = fe.commit()
    assert committed == fe.positions()
    assert sum(br.depths()) == len(published) - 10
    router2 = _RecordingRouter()
    fe2 = ting.PubSubFrontEnd(br, router2, start=fe.committed())
    fe2.pump()
    assert sorted(router.items + router2.items) == sorted(published)
    assert fe2.lag() == 0


def test_frontend_uncommitted_delivery_replays_after_crash():
    br = ting.PubSubBroker(n_partitions=2)
    published = _publish_rounds(br, n_rounds=2)
    router = _RecordingRouter()
    fe = ting.PubSubFrontEnd(br, router)
    fe.pump(max_items=6)  # delivered, never committed
    router2 = _RecordingRouter()
    fe2 = ting.PubSubFrontEnd(br, router2, start=fe.committed())
    fe2.pump()
    assert sorted(router2.items) == sorted(published)
    assert len(router.items) == 6


def test_frontend_below_retention_base_is_loud():
    br = ting.PubSubBroker(n_partitions=1, retention=4)
    fe = ting.PubSubFrontEnd(br, _RecordingRouter())
    for i in range(10):
        br.publish(np.array([1], np.int32), np.full((1, 2), i, np.float32))
    with pytest.raises(LookupError, match="outran retention"):
        fe.pump()


def test_frontend_delivers_in_the_jax_order():
    """The same broker contents pumped by both front ends reach the
    router in the same order, with the same positions and lag."""
    got = []
    for pkg in (jing, ting):
        br = pkg.PubSubBroker(n_partitions=3)
        _publish_rounds(br, n_rounds=5, seed=4)
        router = _RecordingRouter()
        fe = pkg.PubSubFrontEnd(br, router, read_batch=4)
        fe.pump(max_items=23)
        got.append((router.items, fe.positions(), fe.lag()))
    assert got[0] == got[1]


# ------------------------------------------------------ into a pod, on_sync
def _pods(S=4, d=8, C=16):
    kw = dict(d=d, K=4, T=64, eps=0.5)
    jp = JPod(japi.make("threesieves", backend="jnp", **kw), sessions=S,
              chunk=C)
    tp = TPod(tapi.make("threesieves", backend="torch", device="cpu", **kw),
              sessions=S, chunk=C, device="cpu")
    js, ts = jp.init(), tp.init()
    for sid in range(S):
        js, _, _ = jp.admit(js, jnp.int32(sid))
        ts, _, _ = tp.admit(ts, sid)
    return jp, tp, js, ts


def _fvals_by_sid(pod, state):
    sid = np.asarray(state.sid)
    fv = np.asarray(pod.readout(state).fval)
    return {int(s): fv[i] for i, s in enumerate(sid) if s >= 0}


def test_frontend_commit_merges_into_pipeline_stats():
    """``attach`` sets the port pipeline's ``on_sync``: the committed
    offsets come back in ``run()``'s stats and the logs are trimmed."""
    d, batch, S = 4, 8, 2
    _, tp, _, ts = _pods(S=S, d=d, C=batch)
    pipe = ting.IngestPipeline(tp, buffer=ting.TaggedBuffer(1024),
                               batch=batch, get_timeout=30.0)
    router = ting.PodRouter({0: pipe})
    router.assign(np.arange(S), 0)
    br = ting.PubSubBroker(n_partitions=2)
    fe = ting.PubSubFrontEnd(br, router)
    fe.attach(pipe)
    rng = np.random.default_rng(0)
    br.publish(rng.integers(0, S, 16).astype(np.int32),
               rng.normal(size=(16, d)).astype(np.float32))
    fe.pump()
    pipe.buffer.close()
    ts, stats = pipe.run(ts)
    assert stats["pubsub_committed"] == fe.committed()
    assert sum(fe.committed().values()) == 16
    assert sum(br.depths()) == 0


def _wire_run(pkg, pod, state, frames, S, kill_after=None, restart=False):
    """producer -> listener -> broker -> front end -> router -> pod; the
    producer's socket killed after ``kill_after`` frames, the front end
    restarted from ``committed()`` halfway when ``restart``."""
    pipe = pkg.IngestPipeline(pod, buffer=pkg.TaggedBuffer(4096), batch=16,
                              get_timeout=30.0)
    router = pkg.PodRouter({0: pipe})
    router.assign(np.arange(S), 0)
    br = pkg.PubSubBroker(n_partitions=3)
    fe = pkg.PubSubFrontEnd(br, router)
    fe.attach(pipe)
    with pkg.PubSubListener(br, timeout=10.0) as lis:
        pub = pkg.Publisher("127.0.0.1", lis.port, producer_id=1,
                            timeout=10.0)
        for i, (sids, X) in enumerate(frames):
            if i == kill_after:
                pub._sock.close()
                with pytest.raises(OSError):
                    pub.publish(sids, X)
                pub.connect()  # replays the lost frame exactly
            else:
                pub.publish(sids, X)
            if restart and i == len(frames) // 2:
                fe.pump()
                state, _ = pipe.run(state, max_batches=1)  # commits
                fe = pkg.PubSubFrontEnd(br, router, start=fe.committed())
                fe.attach(pipe)
        pub.close()
    fe.pump()
    pipe.buffer.close()
    state, stats = pipe.run(state)
    return state, np.asarray(state.items).copy(), stats["pubsub_committed"]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("case", ["clean", "reconnect", "restart"])
def test_wire_into_the_pod_matches_jax(case):
    """The same frames through both packages' wire and front end end in
    the same pod state and committed offsets; a reconnect or a restarted
    front end changes nothing."""
    d, S = 8, 4
    rng = np.random.default_rng(11)
    frames = [(rng.integers(0, S, size=12).astype(np.int32),
               rng.normal(size=(12, d)).astype(np.float32))
              for _ in range(8)]
    kw = {"reconnect": {"kill_after": 4}, "restart": {"restart": True}}.get(
        case, {})
    jp, tp, js, ts = _pods(S=S, d=d)
    js, jitems, jcommit = _wire_run(jing, jp, js, frames, S, **kw)
    ts, titems, tcommit = _wire_run(ting, tp, ts, frames, S, **kw)
    assert_states_match(js, ts, case)
    np.testing.assert_array_equal(jitems, titems)
    assert jcommit == tcommit
    assert int(titems.sum()) == 8 * 12
    if case != "clean":
        clean, _, _ = _wire_run(ting, tp, _pods(S=S, d=d)[3], frames, S)
        assert _fvals_by_sid(tp, ts) == _fvals_by_sid(tp, clean)


@pytest.mark.timeout(120)
def test_overload_quiet_tenants_bit_equal_hot_within_bound():
    """At 4x offered load the shed ladder thins the hot tenant only:
    quiet tenants' f-values are bit-equal to the unloaded run."""
    d, batch = 8, 16
    rng = np.random.default_rng(5)
    offered = []
    for _ in range(24):
        sids = [0] * 61 + [1, 2, 3]
        offered.append((np.asarray(sids, np.int32),
                        rng.normal(size=(len(sids), d)).astype(np.float32)))
    _, pod, _, state = _pods(d=d, C=batch)
    base = ting.IngestPipeline(pod, buffer=ting.TaggedBuffer(65536),
                               batch=batch, get_timeout=30.0)
    for sids, X in offered:
        base.buffer.put(sids, X)
    base.buffer.close()
    state, _ = base.run(state)
    f_base = _fvals_by_sid(pod, state)

    _, pod2, _, state2 = _pods(d=d, C=batch)
    buf = ting.TaggedBuffer(64, policy="drop-newest",
                            shed=ting.ShedPolicy(lo=0.25, hi=0.6,
                                                 p_floor=0.1, clip_mult=2.0,
                                                 seed=1))
    pipe = ting.IngestPipeline(pod2, buffer=buf, batch=batch,
                               get_timeout=30.0)
    max_depth = 0
    for sids, X in offered:
        buf.put(sids, X)
        max_depth = max(max_depth, buf.size)
        state2, _ = pipe.run(state2, max_batches=1)
    buf.close()
    state2, _ = pipe.run(state2)
    f_shed = _fvals_by_sid(pod2, state2)
    assert max_depth <= buf.capacity and buf.total_drops() == 0
    sheds = buf.shed_counts()
    for q in (1, 2, 3):
        assert sheds.get(q, 0) == 0 and f_shed[q] == f_base[q]
    assert sheds.get(0, 0) > 0 and f_shed[0] >= 0.90 * f_base[0]
    assert buf.shed_rung_changes() > 0
