# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of the pod autoscaler (``serve/autoscale.py``), held against the
JAX package on the CPU: the twins of tests/test_autoscale.py (a live
two-pod handoff under an ``IngestPipeline`` fleet bit-equal to the run
that never moved, with zero drops; FIFO of the parked backlog; a handoff
after end-of-stream and one mid-drift-reset; the refusals, atomic; the
unknown victims counted; the three victim policies; signals and
``maybe_rebalance``), plus the same handoff driven through both packages
on one script (the moved tenants equal the JAX fleet's), its span tree
and counters, and a failed handoff re-raised after ``release``.

Integers equal, floats within rtol = atol = 1e-5 across the packages;
bit for bit inside the port.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ingest as jing  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro_torch import ingest as ting  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.tree import leaves_with_keys  # noqa: E402

from _torch_port import assert_states_match  # noqa: E402

D = 5


def _pod(S=4, C=16, K=4, T=11, pkg="torch"):
    kw = dict(K=K, d=D, lengthscale=1.5, eps=0.1, T=T)
    if pkg == "jax":
        return jserve.SummarizerPod(algo=japi.make("threesieves",
                                                   backend="jnp", **kw),
                                    sessions=S, chunk=C)
    return tserve.SummarizerPod(
        algo=tapi.make("threesieves", backend="torch", device="cpu", **kw),
        sessions=S, chunk=C, device="cpu")


def _admit_all(pod, state, sids):
    for sid in sids:
        state, _, ok = pod.admit(state, sid)
        assert bool(ok)
    return state


def _tagged(rng, n, sessions):
    sids = rng.choice(np.asarray(sessions, np.int32), n)
    X = rng.randn(n, D).astype(np.float32)
    X[:, 0] = np.arange(n, dtype=np.float32)  # per-item fingerprint
    return sids.astype(np.int32), X


def _per_session(batches):
    per = {}
    for sids, X in batches:
        for sid, x in zip(sids.tolist(), X):
            per.setdefault(int(sid), []).append(x)
    return per


def _assert_summary_equals_standalone(pod, state, sid, items, label=""):
    """The tenant's summary is bit-equal to ``run_batched`` over the same
    item order (the run that never moved)."""
    slot = pod.routing_table(state)[sid]
    ro = pod.readout(state)
    algo = pod.algo
    ref = algo.run_batched(algo.init(), torch.from_numpy(np.stack(items)))
    rf, rn, rfv = algo.summary(ref)
    assert int(ro.n[slot]) == int(rn), f"{label} session {sid}"
    assert torch.equal(ro.feats[slot], rf), f"{label} session {sid}"
    assert torch.equal(ro.fval[slot], rfv), f"{label} session {sid}"


def _snapshot(state):
    return {k: v.clone() for k, v in leaves_with_keys(state).items()}


def _assert_unchanged(state, snap, msg=""):
    for k, v in leaves_with_keys(state).items():
        assert torch.equal(v, snap[k]), f"{msg} leaf {k} differs"


def _fleet(pods, batch=16, capacity=2048, pkg=ting):
    pipes = {i: pkg.IngestPipeline(p, buffer=pkg.TaggedBuffer(capacity),
                                   batch=batch, get_timeout=30.0)
             for i, p in enumerate(pods)}
    return pkg.PodRouter(pipelines=pipes), pipes


# ------------------------------------------------------------- end-to-end
def test_live_handoff_bit_equal_zero_drops():
    """A mid-stream two-pod migration under a live pipeline fleet is
    invisible in the summaries, and not one item is lost."""
    podA, podB = _pod(S=4), _pod(S=4)
    sids_all = [100, 101, 102, 103]
    rng = np.random.RandomState(7)
    feed = [_tagged(rng, n, sids_all)
            for n in (24, 17, 31, 24, 9, 28, 24, 15, 24, 20, 24, 16)]
    per = _per_session(feed)
    n_total = sum(len(s) for s, _ in feed)

    router, pipes = _fleet([podA, podB])
    states = {0: _admit_all(podA, podA.init(), sids_all), 1: podB.init()}
    router.assign(sids_all, 0)
    asc = tserve.PodAutoscaler(router=router, pods={0: podA, 1: podB},
                               policy=tserve.ScalePolicy(max_occupancy=0.5,
                                                         victims=2))
    gate = threading.Event()

    class Gated(ting.Source):
        def batches(self):
            for i, b in enumerate(feed):
                if i == 6:
                    gate.wait(timeout=30.0)
                yield b

    feeder = router.feed_from(Gated())
    states[0], s1 = pipes[0].run(states[0], max_batches=3)
    states, rep = asc.handoff(states, 0, 1, [100, 102])
    assert rep.ok and rep.moved == [100, 102] and not rep.skipped
    gate.set()
    states[0], s2 = pipes[0].run(states[0])
    states[1], s3 = pipes[1].run(states[1])
    feeder.join(timeout=30.0)
    assert pipes[0].exhausted and pipes[1].exhausted

    for st in (s1, s2, s3):
        assert st["dropped_unknown"] == 0 and st["dropped_overflow"] == 0
    assert not router.drops_unrouted
    for pipe in pipes.values():
        assert not pipe.buffer.drop_counts()
        assert pipe.buffer.size == 0
    assert s1["items"] + s2["items"] + s3["items"] == n_total
    routedA = {s: int(states[0].items[i])
               for s, i in podA.routing_table(states[0]).items()}
    routedB = {s: int(states[1].items[i])
               for s, i in podB.routing_table(states[1]).items()}
    assert sorted(routedA) == [101, 103] and sorted(routedB) == [100, 102]
    for sid, cnt in {**routedA, **routedB}.items():
        assert cnt == len(per[sid]), f"session {sid} lost items"
    for sid in (100, 102):
        _assert_summary_equals_standalone(podB, states[1], sid, per[sid],
                                          "migrated")
    for sid in (101, 103):
        _assert_summary_equals_standalone(podA, states[0], sid, per[sid],
                                          "resident")


def _scripted_fleet(pkg_name):
    """One deterministic fleet script (no threads): feed, run, hand off
    two victims by policy, feed, run -> (states, report)."""
    pkg, serve = (jing, jserve) if pkg_name == "jax" else (ting, tserve)
    podA, podB = (_pod(S=4, C=64, pkg=pkg_name),
                  _pod(S=4, C=64, pkg=pkg_name))
    router, pipes = _fleet([podA, podB], batch=64, pkg=pkg)
    sids_all = [100, 101, 102, 103]
    states = {0: _admit_all(podA, podA.init(), sids_all),
              1: _admit_all(podB, podB.init(), [200])}
    router.assign(sids_all, 0)
    router.assign([200], 1)
    asc = serve.PodAutoscaler(
        router=router, pods={0: podA, 1: podB},
        policy=serve.ScalePolicy(max_occupancy=0.9, victims=2,
                                 victim_policy="fewest-insertions"))
    rng = np.random.RandomState(21)
    for n in (40, 33):
        router.put(*_tagged(rng, n, sids_all + [200]))
    states[0], _ = pipes[0].run(states[0], max_batches=1)
    states[1], _ = pipes[1].run(states[1], max_batches=1)
    # waits in the buffers: the move forwards the victims' share
    router.put(*_tagged(rng, 30, sids_all + [200]))
    states, rep = asc.maybe_rebalance(states)
    router.put(*_tagged(rng, 37, sids_all + [200]))
    for pipe in pipes.values():
        pipe.buffer.close()
    states[0], _ = pipes[0].run(states[0])
    states[1], _ = pipes[1].run(states[1])
    return states, rep


def test_handoff_moves_the_tenants_the_jax_fleet_moves():
    """The same fleet script through both packages: the same victims, the
    same backlog forwarded, and both pods' final states equal."""
    jstates, jrep = _scripted_fleet("jax")
    tstates, trep = _scripted_fleet("torch")
    assert trep.ok and jrep.ok and trep.moved == jrep.moved
    assert len(trep.moved) == 2
    assert trep.backlog_items == jrep.backlog_items > 0
    assert trep.reason == jrep.reason
    for pid in (0, 1):
        assert_states_match(jstates[pid], tstates[pid], f"pod {pid}")


def test_handoff_quiesce_preserves_fifo_backlog():
    podA, podB = _pod(S=2, C=32), _pod(S=2, C=32)
    router, pipes = _fleet([podA, podB], batch=32)
    states = {0: _admit_all(podA, podA.init(), [5]), 1: podB.init()}
    router.assign([5], 0)
    asc = tserve.PodAutoscaler(router=router, pods={0: podA, 1: podB})
    rng = np.random.RandomState(1)
    pre = rng.randn(8, D).astype(np.float32)
    router.put(np.full(8, 5, np.int32), pre)
    states[0], _ = pipes[0].run(states[0], max_batches=1)
    backlog = rng.randn(6, D).astype(np.float32)
    router.quiesce([5])
    router.put(np.full(6, 5, np.int32), backlog)
    assert pipes[0].buffer.depths() == {5: 6}
    states, rep = asc.handoff(states, 0, 1, [5])
    assert rep.ok and rep.backlog_items == 6
    post = rng.randn(4, D).astype(np.float32)
    router.put(np.full(4, 5, np.int32), post)
    states[1], stats = pipes[1].run(states[1], max_batches=1)
    assert stats["items"] == 10
    _assert_summary_equals_standalone(
        podB, states[1], 5, list(pre) + list(backlog) + list(post))


def test_handoff_after_stream_close_still_delivers_backlog():
    podA, podB = _pod(S=2, C=32), _pod(S=2, C=32)
    router, pipes = _fleet([podA, podB], batch=32)
    states = {0: _admit_all(podA, podA.init(), [5]), 1: podB.init()}
    router.assign([5], 0)
    asc = tserve.PodAutoscaler(router=router, pods={0: podA, 1: podB})
    rng = np.random.RandomState(2)
    items = rng.randn(12, D).astype(np.float32)
    router.put(np.full(6, 5, np.int32), items[:6])
    states[0], _ = pipes[0].run(states[0], max_batches=1)
    router.quiesce([5])
    router.put(np.full(6, 5, np.int32), items[6:])
    for pipe in pipes.values():
        pipe.buffer.close()
    states[1], st = pipes[1].run(states[1])
    assert pipes[1].exhausted and st["items"] == 0
    states, rep = asc.handoff(states, 0, 1, [5])
    assert rep.ok and rep.backlog_items == 6
    states[1], st2 = pipes[1].run(states[1])
    assert st2["items"] == 6
    _assert_summary_equals_standalone(podB, states[1], 5, list(items))


def test_handoff_mid_drift_reset():
    podA, podB = _pod(S=2, T=5), _pod(S=2, T=5)
    router, pipes = _fleet([podA, podB])
    states = {0: _admit_all(podA, podA.init(), [40, 41]), 1: podB.init()}
    router.assign([40, 41], 0)
    asc = tserve.PodAutoscaler(router=router, pods={0: podA, 1: podB})
    rng = np.random.RandomState(3)
    pre = _tagged(rng, 48, [40, 41])
    states[0], _ = podA.ingest(states[0], torch.from_numpy(pre[0]),
                               torch.from_numpy(pre[1]))
    slot40 = podA.routing_table(states[0])[40]
    mask = torch.zeros(2, dtype=torch.bool)
    mask[slot40] = True
    states[0] = podA.reset_slots(states[0], mask)
    assert int(states[0].resets[slot40]) == 1
    states, rep = asc.handoff(states, 0, 1, [40])
    assert rep.ok and rep.moved == [40]
    slotB = podB.routing_table(states[1])[40]
    assert int(states[1].resets[slotB]) == 1  # the ledger travels
    post = _tagged(rng, 24, [40])
    states[1], _ = podB.ingest(states[1], torch.from_numpy(post[0]),
                               torch.from_numpy(post[1]))
    post_items = [x for s, x in zip(post[0].tolist(), post[1]) if s == 40]
    _assert_summary_equals_standalone(podB, states[1], 40, post_items,
                                      "mid-drift-reset")


# ---------------------------------------------------------------- refusals
def test_handoff_unknown_or_evicted_sid_is_counted_noop():
    podA, podB = _pod(S=3), _pod(S=3)
    router, _ = _fleet([podA, podB])
    stA = _admit_all(podA, podA.init(), [1, 2])
    stA = podA.evict(stA, 2)  # raced eviction
    states = {0: stA, 1: podB.init()}
    router.assign([1], 0)
    asc = tserve.PodAutoscaler(router=router, pods={0: podA, 1: podB})
    states, rep = asc.handoff(states, 0, 1, [1, 2, 777])
    assert rep.ok and rep.moved == [1] and rep.skipped == [2, 777]
    assert asc.skipped_unknown == 2
    before = {k: _snapshot(v) for k, v in states.items()}
    states, rep2 = asc.handoff(states, 0, 1, [888, 999])
    assert rep2.ok and not rep2.moved and rep2.skipped == [888, 999]
    assert asc.skipped_unknown == 4
    for k in before:
        _assert_unchanged(states[k], before[k], f"pod {k}")


def test_handoff_capacity_refusal_is_atomic():
    podA, podB = _pod(S=3), _pod(S=2)
    router, pipes = _fleet([podA, podB])
    stB = _admit_all(podB, podB.init(), [900])  # 1 free slot on B
    states = {0: _admit_all(podA, podA.init(), [10, 11, 12]), 1: stB}
    router.assign([10, 11, 12], 0)
    router.assign([900], 1)
    asc = tserve.PodAutoscaler(router=router, pods={0: podA, 1: podB})
    before0, before1 = _snapshot(states[0]), _snapshot(states[1])
    table_before = router.table()
    states, rep = asc.handoff(states, 0, 1, [10, 11])
    assert not rep.ok and "free slots" in rep.reason
    _assert_unchanged(states[0], before0, "source pod")
    _assert_unchanged(states[1], before1, "target pod")
    assert router.table() == table_before
    assert not pipes[0].buffer.quiesced()
    # the clash: a sid live on both ends
    stX = _admit_all(podA, podA.init(), [77])
    stY = _admit_all(podB, podB.init(), [77])
    sX, sY = _snapshot(stX), _snapshot(stY)
    st3, rep3 = asc.handoff({0: stX, 1: stY}, 0, 1, [77])
    assert not rep3.ok and "already live" in rep3.reason
    _assert_unchanged(st3[0], sX, "clash source")
    _assert_unchanged(st3[1], sY, "clash target")
    # the refused victims keep streaming to the source, zero loss
    X = np.random.RandomState(5).randn(8, D).astype(np.float32)
    router.put(np.full(8, 11, np.int32), X)
    states[0], stats = pipes[0].run(states[0], max_batches=1)
    assert stats["items"] == 8 and stats["dropped_unknown"] == 0
    # an exactly fitting victim set goes through
    _, repc = asc.handoff(states, 0, 1, [10])
    assert repc.ok


def test_handoff_src_equals_dst_refused():
    podA, podB = _pod(S=2), _pod(S=2)
    router, _ = _fleet([podA, podB])
    states = {0: _admit_all(podA, podA.init(), [1]), 1: podB.init()}
    router.assign([1], 0)
    asc = tserve.PodAutoscaler(router=router, pods={0: podA, 1: podB})
    _, rep = asc.handoff(states, 0, 0, [1])
    assert not rep.ok and rep.reason == "src == dst"


def test_failed_handoff_reraises_after_release(monkeypatch):
    """A fault inside the quiesce window re-raises after ``release``: the
    victims' stream resumes at the source, nothing is parked, and the
    handoff is counted as an error."""
    podA, podB = _pod(S=2), _pod(S=2)
    router, pipes = _fleet([podA, podB])
    states = {0: _admit_all(podA, podA.init(), [1]), 1: podB.init()}
    router.assign([1], 0)
    asc = tserve.PodAutoscaler(router=router, pods={0: podA, 1: podB})
    reg = obs.reset_default_registry()

    def broken(*a, **kw):
        raise RuntimeError("restore failed")

    monkeypatch.setattr(type(podB), "restore", broken)
    with pytest.raises(RuntimeError, match="restore failed"):
        asc.handoff(states, 0, 1, [1])
    assert not pipes[0].buffer.quiesced()
    assert router.owner(1) == 0
    assert reg.snapshot().get("handoffs_total", outcome="error") == 1


def test_handoff_span_tree_and_counters():
    """The audit trail: a handoff span with one child per phase, a refusal
    with ``outcome="refused"`` and no children, and the counters."""
    podA, podB = _pod(S=2), _pod(S=2)
    router, _ = _fleet([podA, podB])
    states = {0: _admit_all(podA, podA.init(), [1, 2]), 1: podB.init()}
    router.assign([1, 2], 0)
    asc = tserve.PodAutoscaler(router=router, pods={0: podA, 1: podB})
    reg = obs.reset_default_registry()
    rec = obs.get_recorder()
    rec.clear()
    router.quiesce([2])
    router.put(np.full(3, 2, np.int32), np.zeros((3, D), np.float32))
    router.release([2])
    states, rep = asc.handoff(states, 0, 1, [1, 2])
    assert rep.ok and rep.backlog_items == 3
    _, refused = asc.handoff(states, 0, 0, [1])
    assert not refused.ok
    top = rec.find("handoff")
    assert [s["outcome"] for s in top] == ["ok", "refused"]
    kids = [s["name"] for s in rec.events
            if s["parent_id"] == top[0]["span_id"]]
    assert kids == ["quiesce", "snapshot", "restore", "evict", "flip"]
    assert not [s for s in rec.events if s["parent_id"] == top[1]["span_id"]]
    snap = reg.snapshot()
    assert snap.get("handoffs_total", outcome="ok") == 1
    assert snap.get("handoffs_total", outcome="refused") == 1
    assert snap.get("sessions_migrated_total") == 2
    assert snap.get("backlog_items_migrated_total") == 3


# ----------------------------------------------------------------- policy
def test_victim_policies_rank_as_documented():
    podA, podB = _pod(S=4), _pod(S=4)
    router, pipes = _fleet([podA, podB])
    stA = _admit_all(podA, podA.init(), [30, 31, 32, 33])
    rng = np.random.RandomState(9)
    sids = np.asarray([31] * 24 + [30] * 4 + [32] * 2 + [33] * 2, np.int32)
    X = (rng.randn(32, D) * 3).astype(np.float32)
    stA, _ = podA.ingest(stA, torch.from_numpy(sids), torch.from_numpy(X))
    router.assign([30, 31, 32, 33], 0)

    def asc_with(policy):
        return tserve.PodAutoscaler(
            router=router, pods={0: podA, 1: podB},
            policy=tserve.ScalePolicy(victim_policy=policy, victims=2))

    accepts = {s: int(stA.accepts[podA.routing_table(stA)[s]])
               for s in (30, 31, 32, 33)}
    want = sorted(accepts, key=lambda s: (accepts[s], s))[:2]
    assert asc_with("fewest-insertions").pick_victims(0, stA, 2) == want
    pipes[0].buffer.put([32] * 5 + [30] * 2, np.zeros((7, D), np.float32))
    assert asc_with("largest-queue").pick_victims(0, stA, 2) == [32, 30]
    rr = asc_with("round-robin")
    assert rr.pick_victims(0, stA, 2) == [30, 31]
    assert rr.pick_victims(0, stA, 2) == [32, 33]
    assert rr.pick_victims(0, stA, 2) == [30, 31]
    with pytest.raises(ValueError, match="victim policy"):
        tserve.ScalePolicy(victim_policy="loudest")


def test_signals_and_maybe_rebalance():
    podA, podB = _pod(S=2, C=4), _pod(S=4, C=4)
    router, _ = _fleet([podA, podB], batch=8)
    states = {0: _admit_all(podA, podA.init(), [50, 51]), 1: podB.init()}
    router.assign([50, 51], 0)
    asc = tserve.PodAutoscaler(
        router=router, pods={0: podA, 1: podB},
        policy=tserve.ScalePolicy(max_occupancy=0.6, max_overflow_delta=4))
    rng = np.random.RandomState(11)
    states[0], _ = podA.ingest(
        states[0], torch.full((10,), 50, dtype=torch.int32),
        torch.from_numpy(rng.randn(10, D).astype(np.float32)))
    sig = asc.signals(0, states[0])
    assert sig.occupancy == 1.0 and sig.overflow_delta == {50: 6}
    hot, reason = asc.hot(sig)
    assert hot and "occupancy" in reason
    assert asc.signals(0, states[0]).overflow_delta == {}
    states, rep = asc.maybe_rebalance(states)
    assert isinstance(rep, tserve.HandoffReport) and rep.ok
    assert rep.src == 0 and rep.dst == 1 and len(rep.moved) == 1
    assert "hot" in rep.reason
    states, rep2 = asc.maybe_rebalance(states)
    assert rep2 is None


@pytest.mark.parametrize("kw,match", [
    ({"victims": 0}, "victims"), ({"max_occupancy": 1.5}, "max_occupancy"),
    ({"victim_policy": "loudest"}, "victim policy")])
def test_scale_policy_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        tserve.ScalePolicy(**kw)
    with pytest.raises(ValueError, match=match):
        jserve.ScalePolicy(**kw)


def test_autoscaler_needs_a_pipeline_per_pod():
    podA = _pod(S=2)
    router, _ = _fleet([podA])
    with pytest.raises(ValueError, match="no router pipeline"):
        tserve.PodAutoscaler(router=router, pods={0: podA, 3: podA})
