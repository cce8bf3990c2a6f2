# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of the algorithm family beyond ThreeSieves: SieveStreaming,
SieveStreaming++ and Salsa (the stacked sieves), the baselines (ISI,
Preemption, QuickStream, Random) and the registry, held against the JAX
package on the same numpy streams; Random on properties, since its draws
come from a ``torch.Generator``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import api as japi  # noqa: E402
from repro.core.spec import SessionSpec as JSpec  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core.baselines import (ISIState, QSState,  # noqa: E402
                                        RandomState)
from repro_torch.core.functions import LogDetState  # noqa: E402
from repro_torch.core.sieves import SieveState  # noqa: E402
from repro_torch.core.spec import SessionSpec as TSpec  # noqa: E402

from _torch_port import (assert_clear_margins, assert_leaves_match,  # noqa
                         assert_states_match, jax_leaves, stream,
                         torch_leaves)

D, C = 6, 16
STACKED = ("sievestreaming", "sievestreaming++", "salsa")
CASES = {
    # name: (spec kwargs, chunk scale, n_valid per chunk)
    "rbf": (dict(K=6, eps=0.3, lengthscale=1.0), 0.5, [16, 7, 0, 16, 16]),
    "saturated": (dict(K=3, eps=0.25, lengthscale=0.5), 2.0,
                  [16, 16, 16]),
    "linear_norm": (dict(K=5, eps=0.2, lengthscale=1.0,
                         kernel_kind="linear_norm"), 0.5, [16, 16, 9]),
}


def pair(name, **kw):
    """The JAX algorithm (backend jnp) and its port (backend torch)."""
    return (japi.make(JSpec(algo=name, d=D, backend="jnp", **kw)),
            tapi.make(TSpec(algo=name, d=D, backend="torch", **kw),
                      device="cpu"))


# ------------------------------------------------------- the stacked sieves
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", STACKED)
def test_stacked_run_batched_matches_jax(name, case):
    kw, scale, counts = CASES[case]
    ja, ta = pair(name, **kw)
    step = jax.jit(ja.run_batched)
    js, ts = ja.init(), ta.init()
    margins = []
    for i, nv in enumerate(counts):
        X = stream(300 + i, C, D, scale)
        js = step(js, jnp.asarray(X), jnp.int32(nv))
        margins.append({})
        ts = ta.run_batched(ts, torch.from_numpy(X), nv, margins=margins[-1])
        assert_states_match(js, ts, msg=f"{name} {case} chunk {i}")
    assert_clear_margins(margins)
    assert int(ta.insertions(ts)) == int(ja.insertions(js)) > 0
    assert int(ta.memory_elements(ts)) == int(ja.memory_elements(js))
    jf, jn, jv = ja.summary(js)
    tf, tn, tv = ta.summary(ts)
    assert int(tn) == int(jn)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", STACKED)
def test_stacked_run_matches_jax(name):
    kw, scale, counts = CASES["rbf"]
    ja, ta = pair(name, **kw)
    run = jax.jit(ja.run)
    js, ts = ja.init(), ta.init()
    for i, nv in enumerate(counts[:3]):
        X = stream(310 + i, C, D, scale)
        js = run(js, jnp.asarray(X), jnp.int32(nv))
        ts = ta.run(ts, torch.from_numpy(X), nv)
        assert_states_match(js, ts, msg=f"{name} run chunk {i}")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", STACKED)
def test_stacked_run_equals_run_batched(name, case):
    kw, scale, counts = CASES[case]
    _, ta = pair(name, **kw)
    a, b = ta.init(), ta.init()
    for i, nv in enumerate(counts):
        X = torch.from_numpy(stream(320 + i, C, D, scale))
        a = ta.run(a, X, nv)
        b = ta.run_batched(b, X, nv)
    assert_leaves_match(torch_leaves(a), torch_leaves(b), f"{name} {case}")


@pytest.mark.parametrize("name", STACKED)
def test_stacked_smaller_hyper_budget_matches_jax(name):
    """``init(hyper(K, eps))``: a smaller budget occupies a prefix of the
    rung axis; a larger ladder than the stack holds is refused."""
    ja, ta = pair(name, K=6, eps=0.2, lengthscale=1.0)
    js = ja.init(ja.hyper(K=3, eps=0.4))
    ts = ta.init(ta.hyper(K=3, eps=0.4))
    assert_states_match(js, ts, msg="init")
    assert int(ts.alive.sum()) < ts.alive.numel()
    for i in range(3):
        X = stream(330 + i, C, D, 0.5)
        js = ja.run_batched(js, jnp.asarray(X))
        ts = ta.run_batched(ts, torch.from_numpy(X))
        assert_states_match(js, ts, msg=f"{name} hyper chunk {i}")
    assert int(ts.lds.n.max()) <= 3
    with pytest.raises(ValueError, match="rungs"):
        ta.hyper(eps=0.05)
    with pytest.raises(ValueError, match="capacity"):
        ta.hyper(K=7)


# ------------------------------------------------------------- baselines
BASELINES = {
    "independentsetimprovement": dict(K=4, lengthscale=0.8),
    "preemptionstreaming": dict(K=4, lengthscale=0.8),
    "quickstream": dict(K=3, lengthscale=0.8, c=2),
}


@pytest.mark.parametrize("kind", ["rbf", "linear_norm"])
@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_run_matches_jax(name, kind):
    ja, ta = pair(name, kernel_kind=kind, **BASELINES[name])
    js, ts = ja.init(), ta.init()
    for i in range(3):
        X = stream(340 + i, 20, D, 0.8)
        js = ja.run(js, jnp.asarray(X))
        ts = ta.run_batched(ts, torch.from_numpy(X))
        assert_states_match(js, ts, msg=f"{name} chunk {i}")
    jf, jn, jv = ja.summary(js)
    tf, tn, tv = ta.summary(ts)
    assert int(tn) == int(jn) > 0
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5, atol=1e-5)
    assert ta.memory_elements(ts) == ja.memory_elements(js)


def test_quickstream_ragged_prefix_matches_jax():
    ja, ta = pair("quickstream", **BASELINES["quickstream"])
    js, ts = ja.init(), ta.init()
    for i, nv in enumerate([20, 5, 0, 13]):
        X = stream(350 + i, 20, D, 0.8)
        js = ja.run(js, jnp.asarray(X), jnp.int32(nv))
        ts = ta.run(ts, torch.from_numpy(X), nv)
        assert_states_match(js, ts, msg=f"chunk {i}")
    assert int(ta.insertions(ts)) == int(ja.insertions(js))


# ---------------------------------------------------------------- Random
def test_random_fills_in_order_then_keeps_k():
    ta = tapi.make(TSpec(algo="random", K=4, d=D), device="cpu")
    X = torch.from_numpy(stream(360, 16, D))
    st = ta.init(seed=5)
    for i, x in enumerate(X):
        st = ta.step(st, x)
        assert int(st.n) == min(i + 1, 4) and int(st.seen) == i + 1
        if i < 4:
            assert torch.equal(st.feats[:i + 1], X[:i + 1])
    # every kept row is an item of the stream, each at most once
    kept = [int(torch.nonzero((X == r).all(-1))[0, 0]) for r in st.feats]
    assert len(set(kept)) == 4
    feats, n, fval = ta.summary(st)
    assert torch.equal(fval, ta.f.evaluate(st.feats, st.n))
    assert ta.memory_elements(st) == 4


def test_random_draws_are_uniform():
    """Reservoir sampling keeps each of the 16 items with probability
    K/16: over 2,000 seeds every position's frequency is within 4 sigma."""
    K, N, seeds = 4, 16, 2000
    ta = tapi.make(TSpec(algo="random", K=K, d=1), device="cpu")
    X = torch.arange(N, dtype=torch.float32)[:, None] + 1.0
    counts = np.zeros(N)
    for seed in range(seeds):
        st = ta.run(ta.init(seed=seed), X)
        counts[st.feats[:, 0].long().numpy() - 1] += 1
    p = K / N
    sigma = np.sqrt(p * (1 - p) / seeds)
    assert np.all(np.abs(counts / seeds - p) <= 4 * sigma), counts / seeds
    assert counts.sum() == K * seeds


# ---------------------------------------------------------------- registry
@pytest.mark.parametrize("name", sorted(japi.ALGORITHMS) + sorted(
    japi._ALIASES))
def test_make_and_algo_name_round_trip(name):
    ja = japi.make(JSpec(algo=name, K=4, d=3))
    ta = tapi.make(TSpec(algo=name, K=4, d=3), device="cpu")
    assert type(ta).__name__ == type(ja).__name__
    assert tapi.algo_name(ta) == japi.algo_name(ja)
    assert tapi.make(TSpec(algo=tapi.algo_name(ta), K=4, d=3),
                     device="cpu") == ta


def test_registry_matches_jax():
    assert tapi.ALGORITHMS == japi.ALGORITHMS
    assert tapi.SIEVE_FAMILY == japi.SIEVE_FAMILY
    assert tapi._ALIASES == japi._ALIASES


# ----------------------------------------------------------------- convert
def _mid_stream(name, **kw):
    ja, _ = pair(name, **kw)
    st = ja.init()
    for i in range(2):
        st = ja.run(st, jnp.asarray(stream(370 + i, 12, D, 0.8)))
    return ja, st


@pytest.mark.parametrize("name,cls,kw", [
    ("sievestreaming++", SieveState, dict(K=5, eps=0.3, lengthscale=1.0)),
    ("salsa", SieveState, dict(K=4, eps=0.3, lengthscale=1.0)),
    ("independentsetimprovement", ISIState, dict(K=3, lengthscale=0.8)),
    ("quickstream", QSState, dict(K=3, lengthscale=0.8, c=2)),
    ("preemptionstreaming", LogDetState, dict(K=3, lengthscale=0.8)),
])
def test_convert_round_trips_and_continues_mid_stream(name, cls, kw):
    """A JAX state travels into the port leaf for leaf, back unchanged,
    and both packages continue from it to the same state."""
    ja, js = _mid_stream(name, **kw)
    flat = jax_leaves(js)
    ts = convert.state_from_numpy(cls, flat, device="cpu")
    assert_leaves_match(flat, convert.state_to_numpy(ts), name)
    _, ta = pair(name, **kw)
    X = stream(380, 12, D, 0.8)
    js = ja.run(js, jnp.asarray(X))
    ts = ta.run(ts, torch.from_numpy(X))
    assert_states_match(js, ts, msg=f"{name} after the hand-over")


def test_convert_random_state_carries_counters_only():
    ja = japi.make(JSpec(algo="random", K=3, d=D))
    js = ja.run(ja.init(seed=1), jnp.asarray(stream(390, 7, D)))
    flat = {k: v for k, v in jax_leaves(js).items() if k != "key"}
    ts = convert.state_from_numpy(RandomState, flat, device="cpu", seed=4)
    assert set(convert.state_to_numpy(ts)) == {"feats", "n", "seen"}
    assert_leaves_match(flat, convert.state_to_numpy(ts), "random")
    with pytest.raises(KeyError, match="unknown leaves"):
        convert.state_from_numpy(RandomState, jax_leaves(js), device="cpu")
    ta = tapi.make(TSpec(algo="random", K=3, d=D), device="cpu")
    ts = ta.step(ts, torch.from_numpy(stream(391, 1, D)[0]))
    assert (int(ts.n), int(ts.seen)) == (3, 8)
