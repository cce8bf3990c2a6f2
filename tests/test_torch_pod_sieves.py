# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The pod hosting every algorithm the JAX pod hosts (SieveStreaming,
SieveStreaming++, Salsa, QuickStream), held against a JAX pod fed the
same tagged batches: heterogeneous specs, a drift reset, readout and the
accept counters.  Also the grouped gain pass (a pod's slots in one
``gain_traced`` call) and the batched stacked-sieve step
(``StackedSieve.run_slots``) against the per-slot loop ``pod_step_ref``.
Integers equal, floats within rtol = atol = 1e-5 (f32, another
summation order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import api as japi  # noqa: E402
from repro.core.spec import SessionSpec as JSpec  # noqa: E402
from repro.serve.summarize import SummarizerPod as JPod  # noqa: E402
from repro_torch import kernelmath as tkm  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core.sieve_family import stack_states  # noqa: E402
from repro_torch.core.spec import SessionSpec as TSpec  # noqa: E402
from repro_torch.kernels.pod_step import pod_step, pod_step_ref  # noqa
from repro_torch.kernels.rbf_gain import gain_traced_ref  # noqa: E402
from repro_torch.serve.summarize import SummarizerPod as TPod  # noqa: E402
from repro_torch.tree import leaves_with_keys, tree_map  # noqa: E402

from _torch_port import (ATOL, RTOL, assert_leaves_match,  # noqa: E402
                         assert_states_match, jax_leaves, torch_leaves)

K, D, S, C = 6, 5, 4, 12
STACKED = ["sievestreaming", "sievestreaming++", "salsa"]
SIDS = [10, 11, 12]
# tenants of one pod: own budgets, ladders and kernels (the pod is built
# with the smallest eps and the largest K, so every ladder fits its axis)
SPECS = [dict(K=3, eps=0.4, lengthscale=0.8),
         dict(K=6, eps=0.3, lengthscale=1.2, kernel_kind="linear_norm"),
         dict(K=5, eps=0.35, lengthscale=1.0)]


def algos(name, **kw):
    kw = dict(K=K, d=D, lengthscale=1.0, eps=0.3, **kw)
    return (japi.make(name, backend="jnp", **kw),
            tapi.make(name, backend="torch", device="cpu", **kw))


def pods(name):
    ja, ta = algos(name)
    return (JPod(algo=ja, sessions=S, chunk=C),
            TPod(algo=ta, sessions=S, chunk=C, device="cpu"))


def admit_all(name, jp, tp, js, ts, specs=True):
    for sid, sp in zip(SIDS, SPECS):
        jspec = JSpec(algo=name, d=D, **sp) if specs else None
        tspec = TSpec(algo=name, d=D, **sp) if specs else None
        js, jslot, jok = jp.admit(js, sid, spec=jspec)
        ts, tslot, tok = tp.admit(ts, sid, spec=tspec)
        assert (int(jslot), bool(jok)) == (int(tslot), bool(tok))
        assert bool(tok)
    return js, ts


def batch(seed, n=30, pool=(10, 11, 12, 99, -1)):
    rng = np.random.default_rng(seed)
    sids = rng.choice(pool, size=n).astype(np.int32)
    return sids, (0.7 * rng.standard_normal((n, D))).astype(np.float32)


def feed(jp, tp, js, ts, seed, what):
    sids, X = batch(seed)
    js, jinfo = jax.jit(jp.ingest)(js, jnp.asarray(sids), jnp.asarray(X))
    ts, tinfo = tp.ingest(ts, torch.from_numpy(sids), torch.from_numpy(X))
    for k in jinfo:
        np.testing.assert_array_equal(np.asarray(jinfo[k]),
                                      tinfo[k].numpy(), err_msg=k)
    assert_states_match(js, ts, what)
    return js, ts


def assert_readouts_match(jr, tr):
    for name in ("feats", "n", "fval", "active"):
        a, b = np.asarray(getattr(jr, name)), getattr(tr, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    for k in ("overflow", "unknown"):
        np.testing.assert_array_equal(np.asarray(jr.drops[k]),
                                      tr.drops[k].numpy())


# ------------------------------------------------------------- the pods
@pytest.mark.parametrize("name", STACKED)
def test_stacked_sieve_pod_matches_jax(name):
    """Heterogeneous specs -> ingest x2 -> drift reset -> ingest ->
    readout, leaf by leaf against the JAX pod throughout; the accept
    counters only rise."""
    jp, tp = pods(name)
    js, ts = admit_all(name, jp, tp, jp.init(), tp.init())
    assert_states_match(js, ts, "admit")
    prev = torch.zeros(S, dtype=torch.int32)
    for seed in (1, 2):
        js, ts = feed(jp, tp, js, ts, seed, f"ingest {seed}")
        assert bool((ts.accepts >= prev).all())
        prev = ts.accepts.clone()
    # insertions count every rung's appends: the bar re-arms the small
    # tenant (slot 0) and keeps the others
    rate = {"salsa": 4.0}.get(name, 1.5)
    js, jmask = jp.drift_check(js, min_items=5, min_rate=rate)
    ts, tmask = tp.drift_check(ts, min_items=5, min_rate=rate)
    np.testing.assert_array_equal(np.asarray(jmask), tmask.numpy())
    assert bool(tmask[0]) and not bool(tmask[1])
    assert_states_match(js, ts, "drift reset")
    js, ts = feed(jp, tp, js, ts, 3, "ingest after reset")
    jr, tr = jp.readout(js), tp.readout(ts)
    assert_readouts_match(jr, tr)
    assert_leaves_match(jax_leaves(jr.specs), torch_leaves(tr.specs))
    assert int(tr.n.sum()) > 0


def test_quickstream_pod_matches_jax():
    """QuickStream tenants (no per-slot hyperparameters): admit without
    a spec, ingest, drift reset, readout, against the JAX pod."""
    jp, tp = pods("quickstream")
    js, ts = admit_all("quickstream", jp, tp, jp.init(), tp.init(),
                       specs=False)
    assert_states_match(js, ts, "admit")
    for seed in (4, 5, 6):
        js, ts = feed(jp, tp, js, ts, seed, f"ingest {seed}")
    js, jmask = jp.drift_check(js, min_items=5, min_rate=0.5)
    ts, tmask = tp.drift_check(ts, min_items=5, min_rate=0.5)
    np.testing.assert_array_equal(np.asarray(jmask), tmask.numpy())
    assert_states_match(js, ts, "drift reset")
    js, ts = feed(jp, tp, js, ts, 7, "ingest after reset")
    jr, tr = jp.readout(js), tp.readout(ts)
    assert_readouts_match(jr, tr)
    assert jr.specs is None and tr.specs is None
    assert bool((ts.accepts >= 0).all()) and int(ts.accepts.sum()) > 0


@pytest.mark.parametrize("name", STACKED + ["quickstream"])
def test_pod_sessions_equal_standalone_run_batched(name):
    """Every session of the port's pod is its standalone ``run_batched``
    on the items routed to it (the JAX pod's headline claim)."""
    _, ta = algos(name)
    tp = TPod(algo=ta, sessions=3, chunk=16, device="cpu")
    st = tp.init()
    for sid in (5, 6, 7):
        st, _, ok = tp.admit(st, sid)
        assert bool(ok)
    rng = np.random.RandomState(11)
    per = {s: [] for s in (5, 6, 7)}
    for _ in range(4):
        sids = rng.choice([5, 6, 7], 12).astype(np.int32)
        X = (rng.randn(12, D) * 2).astype(np.float32)
        for sid, x in zip(sids, X):
            per[int(sid)].append(x)
        st, _ = tp.ingest(st, torch.from_numpy(sids), torch.from_numpy(X))
    ro = tp.readout(st)
    for i, sid in enumerate((5, 6, 7)):
        ref = ta.run_batched(ta.init(), torch.from_numpy(np.stack(per[sid])))
        rf, rn, rfv = ta.summary(ref)
        assert int(ro.n[i]) == int(rn)
        np.testing.assert_allclose(ro.fval[i].numpy(), rfv.numpy(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ro.feats[i].numpy(), rf.numpy(),
                                   rtol=RTOL, atol=ATOL)
        assert int(st.accepts[i]) == int(ta.insertions(ref))


# ------------------------------------------- the four repaired faults
def test_quickstream_pod_admits_without_a_spec():
    """Fault 1: ``admit`` called ``init(None)``, which QuickStream does
    not take."""
    _, ta = algos("quickstream")
    tp = TPod(algo=ta, sessions=2, chunk=4, device="cpu")
    st, slot, ok = tp.admit(tp.init(), 3)
    assert bool(ok) and int(slot) == 0 and bool(st.active[0])


@pytest.mark.parametrize("name", STACKED)
def test_drift_reset_rebuilds_each_slot_from_its_own_spec(name):
    """Fault 2: a reset took every slot's fresh rows from the pod's
    default ``init()``, so a small tenant got the K_max ladder's mask."""
    jp, tp = pods(name)
    js, ts = admit_all(name, jp, tp, jp.init(), tp.init())
    mask = np.array([True, True, True, False])
    js = jp.reset_slots(js, jnp.asarray(mask))
    ts = tp.reset_slots(ts, torch.from_numpy(mask))
    assert_states_match(js, ts, "reset")
    for i in range(3):
        row = tree_map(lambda l, i=i: l[i], ts.algo)
        fresh = tp.algo.init(row.hp)
        assert torch.equal(row.alive, fresh.alive), i
    assert not bool(ts.algo.alive[0].all())  # K=3: a short ladder


def test_quickstream_drift_reset():
    """Fault 2: QuickStream state has no ``hp`` to carry over."""
    jp, tp = pods("quickstream")
    js, ts = admit_all("quickstream", jp, tp, jp.init(), tp.init(),
                       specs=False)
    js, ts = feed(jp, tp, js, ts, 8, "ingest")
    mask = np.array([True, False, True, False])
    js = jp.reset_slots(js, jnp.asarray(mask))
    ts = tp.reset_slots(ts, torch.from_numpy(mask))
    assert_states_match(js, ts, "reset")
    assert int(ts.algo.nA[0]) == 0 and int(ts.resets.sum()) == 2


@pytest.mark.parametrize("name", STACKED)
def test_readout_and_insertions_are_per_slot(name):
    """Fault 3: ``summary`` and ``insertions`` ran on the stacked state
    with no slot axis (an argmax over every slot's instances, a sum over
    every slot's rungs).  Slots filled from standalone runs read out as
    those runs do."""
    _, ta = algos(name)
    tp = TPod(algo=ta, sessions=3, chunk=8, device="cpu")
    rows = []
    for s in range(3):
        X = torch.from_numpy(batch(20 + s, n=6 + 4 * s)[1])
        rows.append(ta.run_batched(ta.init(), X))
    state = tp.init()
    state = type(state)(**{**state.__dict__, "algo": tree_map(
        lambda *xs: torch.stack(xs), *rows)})
    ro = tp.readout(state)
    ins = tp.algo.insertions(state.algo)  # what ingest_routed calls
    for s, row in enumerate(rows):
        feats, n, fval = ta.summary(row)
        assert int(ro.n[s]) == int(n)
        assert torch.equal(ro.feats[s], feats) and torch.equal(ro.fval[s],
                                                               fval)
        assert int(ins[s]) == int(ta.insertions(row))


def test_quickstream_readout_has_no_specs_and_refuses_a_spec():
    """Fault 4: ``readout`` read ``state.algo.hp``, which QuickStream has
    not, and a spec for an algorithm outside the sieve family passed
    ``_hyper_of``."""
    _, ta = algos("quickstream")
    tp = TPod(algo=ta, sessions=2, chunk=4, device="cpu")
    st, _, _ = tp.admit(tp.init(), 1)
    assert tp.readout(st).specs is None
    for spec in (TSpec(algo="quickstream", K=3, d=D),
                 TSpec(algo="threesieves", K=3, d=D)):
        with pytest.raises(ValueError, match="per-session specs need a "
                                             "sieve-family algorithm"):
            tp.admit(st, 2, spec=spec)


# ---------------------------------------------- the grouped gain pass
@pytest.mark.parametrize("kind", ["rbf", "linear_norm"])
def test_grouped_gain_traced_ref_matches_jax_per_slot(kind):
    """Grouped candidates (one chunk and one kernel per slot) against the
    JAX oracle vmapped over each slot's instances, and G = 1 against the
    ungrouped call bit for bit."""
    jf_algo, ta = algos("sievestreaming")
    jf = jf_algo.f
    G, I, B = 3, 4, 7
    rng = np.random.default_rng(3)
    feats = (0.6 * rng.standard_normal((G * I, K, D))).astype(np.float32)
    ns = rng.integers(0, K + 1, G * I).astype(np.int32)
    ls = np.array([0.8, 1.1, 1.7], np.float32)
    kid = {"rbf": 0, "linear_norm": 1}[kind]
    X = (0.6 * rng.standard_normal((G, B, D))).astype(np.float32)
    # a Cholesky state per instance, factored by the port's LogDet
    st = ta.f.refactor(torch.from_numpy(feats), torch.from_numpy(ns))
    Linv = st.Linv.numpy()
    inv2l2 = (1.0 / (2.0 * ls * ls)).astype(np.float32)
    kern = tkm.KernelParams(torch.from_numpy(inv2l2),
                            torch.full((G,), kid, dtype=torch.int32))
    got = gain_traced_ref(torch.from_numpy(X), st.feats, st.Linv, st.n,
                          kern, a=1.0)
    assert got.shape == (G * I, B)
    from repro import kernelmath as jkm

    for g in range(G):
        jk = jkm.KernelParams(inv2l2=jnp.float32(inv2l2[g]),
                              kind_id=jnp.int32(kid))
        for i in range(g * I, (g + 1) * I):
            ld = jf.init()
            ld = type(ld)(feats=jnp.asarray(st.feats[i].numpy()),
                          L=ld.L, Linv=jnp.asarray(Linv[i]),
                          n=jnp.int32(ns[i]), fval=ld.fval,
                          n_queries=ld.n_queries)
            want = np.asarray(jf.gains(ld, jnp.asarray(X[g]), jk))
            np.testing.assert_allclose(got[i].numpy(), want, rtol=RTOL,
                                       atol=ATOL)
    one = tkm.KernelParams(kern.inv2l2[:1], kern.kind_id[:1])
    g1 = gain_traced_ref(torch.from_numpy(X[:1]), st.feats[:I],
                         st.Linv[:I], st.n[:I], one, a=1.0)
    flat = gain_traced_ref(torch.from_numpy(X[0]), st.feats[:I],
                           st.Linv[:I], st.n[:I],
                           tkm.KernelParams(kern.inv2l2[0],
                                            kern.kind_id[0]), a=1.0)
    assert torch.equal(g1, flat)
    with pytest.raises(ValueError, match="equal runs per group"):
        gain_traced_ref(torch.from_numpy(X[:2]), st.feats[:5], st.Linv[:5],
                        st.n[:5], tkm.KernelParams(kern.inv2l2[:2],
                                                   kern.kind_id[:2]), a=1.0)


# --------------------------------------- the batched stacked-sieve step
def tiered_state(ta, n_slots):
    rows = []
    for s in range(n_slots):
        sp = SPECS[s % len(SPECS)]
        rows.append(ta.init(ta.hyper(**sp)))
    return tree_map(lambda *xs: torch.stack(xs), *rows)


@pytest.mark.parametrize("name", STACKED)
def test_run_slots_equals_the_per_slot_loop(name):
    """``StackedSieve.run_slots`` (all slots at once, one grouped gain
    call per round) against ``pod_step_ref`` (a loop of ``run_batched``)
    over three rounds with ragged counts (0, C and between): integers
    equal and, as the same plain gains price the same rows, floats bit
    for bit."""
    _, ta = algos(name)
    n_slots = 5
    fast = tiered_state(ta, n_slots)
    slow = tree_map(lambda t: t.clone(), fast)
    rng = np.random.default_rng(7)
    for r in range(3):
        chunks = torch.from_numpy(
            (0.7 * rng.standard_normal((n_slots, C, D))).astype(np.float32))
        counts = torch.tensor([0, C, 5, 9, 1][r:] + [0, C, 5, 9, 1][:r],
                              dtype=torch.int32)
        out = ta.run_slots(fast, chunks, counts)
        assert out is fast  # in place
        slow = pod_step_ref(ta, slow, chunks, counts)
        a, b = leaves_with_keys(fast), leaves_with_keys(slow)
        for k in a:
            assert torch.equal(a[k], b[k]), (r, k)
    assert int(fast.lds.n.sum()) > 0


def test_pod_step_dispatch_and_refusals():
    """``pod_step`` routes by algorithm; backend ``cuda`` refuses CPU
    tensors and an algorithm with no kernel."""
    _, ta = algos("sievestreaming++")
    st = tiered_state(ta, 3)
    ref = tree_map(lambda t: t.clone(), st)
    chunks = torch.from_numpy(
        (0.7 * np.random.default_rng(1).standard_normal((3, C, D))
         ).astype(np.float32))
    counts = torch.tensor([C, 4, 0], dtype=torch.int32)
    pod_step(ta, st, chunks, counts)  # auto: run_slots, plain gains
    pod_step(ta, ref, chunks, counts, backend="torch")  # the loop
    a, b = leaves_with_keys(st), leaves_with_keys(ref)
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pod_step(ta, st, chunks, counts, backend="cuda")
    _, qa = algos("quickstream")
    qs = stack_states(qa.init(), 3)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pod_step(qa, qs, chunks, counts, backend="cuda")


@pytest.mark.parametrize("name", STACKED + ["quickstream"])
def test_convert_carries_every_pod_across(name):
    """A JAX pod of any algorithm, flattened to numpy, loads into the
    port's ``PodState`` (the algorithm state's class read from its
    leaves) and takes the next batch as the JAX pod does."""
    from repro_torch import convert
    from repro_torch.serve.summarize import PodState

    jp, tp = pods(name)
    js, _ = admit_all(name, jp, tp, jp.init(), tp.init(),
                      specs=name != "quickstream")
    sids, X = batch(30)
    js, _ = jax.jit(jp.ingest)(js, jnp.asarray(sids), jnp.asarray(X))
    flat = jax_leaves(js)
    ts = convert.state_from_numpy(PodState, flat, device="cpu")
    assert set(convert.state_to_numpy(ts)) == set(flat)
    feed(jp, tp, js, ts, 31, "after the carried-over state")
