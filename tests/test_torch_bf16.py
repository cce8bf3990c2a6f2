# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""bf16 summarization state in the port, held against the JAX package on
the CPU: the four bf16 pins of the reference (ThreeSieves' carry, the
stacked sieves' thresholds, ISI's weight carry, the pod step's bf16
carry) run through both packages on the same numpy inputs.

Tolerances: integers (n, j, t, n_fused, n_queries, the accepts) equal;
floats within 0.05, the reference's own bf16 pin of the pod step
(tests/test_pod_step_kernel.py: fused vs unfused fval, rtol = atol =
0.05), since the two frameworks round bf16 at different points (one bf16
ulp is 2^-7 of a value near 1, 2^-6 near 2).  Fixtures keep every
decision further than ``TIE_BF16`` (relative) from its threshold, so one
bf16 rounding cannot flip an accept.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import KernelConfig as JKernel  # noqa: E402
from repro.core import LogDet as JLogDet  # noqa: E402
from repro.core.baselines import IndependentSetImprovement as JISI  # noqa
from repro.core.sieves import SieveStreaming as JSieve  # noqa: E402
from repro.core.threesieves import ThreeSieves as JThree  # noqa: E402
from repro.kernels.pod_step import pod_step as jax_pod_step  # noqa: E402
from repro_torch.core.baselines import \
    IndependentSetImprovement as TISI  # noqa: E402
from repro_torch.core.functions import KernelConfig as TKernel  # noqa: E402
from repro_torch.core.functions import LogDet as TLogDet  # noqa: E402
from repro_torch.core.sieves import SieveStreaming as TSieve  # noqa: E402
from repro_torch.core.threesieves import ThreeSieves as TThree  # noqa: E402
from repro_torch.kernels.pod_step import pod_step, pod_step_ref  # noqa
from repro_torch.tree import tree_map  # noqa: E402

from _torch_port import assert_clear_margins, stream  # noqa: E402

BF16_TOL = 0.05  # tests/test_pod_step_kernel.py's bf16 pin
TIE_BF16 = 1e-2  # > one bf16 ulp relative (2^-7 = 7.8e-3)


def logdets(K, d, lengthscale, kind="rbf"):
    """The same bf16 LogDet in both packages (the port's on the CPU)."""
    return (JLogDet(K=K, d=d, kernel=JKernel(kind, lengthscale),
                    dtype=jnp.bfloat16),
            TLogDet(K=K, d=d, kernel=TKernel(kind, lengthscale),
                    dtype=torch.bfloat16, device="cpu"))


def as_f32(x):
    """A bf16 leaf of either package as a float32 numpy array (exact)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_ld_close(jld, tld, msg=""):
    """LogDet states: n and n_queries equal, every float leaf bf16 in both
    packages and within BF16_TOL."""
    assert int(jld.n) == int(tld.n), msg
    assert int(jld.n_queries) == int(tld.n_queries), msg
    for name in ("feats", "L", "Linv", "fval"):
        a, b = getattr(jld, name), getattr(tld, name)
        assert a.dtype == jnp.bfloat16 and b.dtype == torch.bfloat16, name
        np.testing.assert_allclose(as_f32(a), as_f32(b), rtol=BF16_TOL,
                                   atol=BF16_TOL, err_msg=f"{msg} {name}")


def test_threesieves_bf16_matches_jax():
    """The reference's bf16 ThreeSieves pin (test_threesieves.py,
    run == run_batched for a bf16 LogDet) through both packages: the
    port's run_batched tracks JAX's, and run == run_batched bit for bit
    inside the port, with the carry in bf16."""
    jf, tf = logdets(K=6, d=4, lengthscale=1.5)
    ja, ta = JThree(f=jf, T=9, eps=0.1), TThree(f=tf, T=9, eps=0.1)
    X = np.random.default_rng(12).standard_normal((80, 4)).astype(np.float32)
    js = jax.jit(ja.run_batched)(ja.init(), jnp.asarray(X))
    margins = {}
    tb = ta.run_batched(ta.init(), torch.from_numpy(X), margins=margins)
    tr = ta.run(ta.init(), torch.from_numpy(X))
    assert_clear_margins([margins], TIE_BF16)
    assert_ld_close(js.ld, tb.ld, "run_batched")
    assert (int(js.j), int(js.t), int(js.n_fused)) == (
        int(tb.j), int(tb.t), int(tb.n_fused))
    assert int(tb.ld.n) == int(tr.ld.n) > 0
    for name in ("feats", "L", "Linv", "fval"):
        assert torch.equal(getattr(tb.ld, name), getattr(tr.ld, name)), name
    # the threshold the accept compares with follows f.dtype
    assert ta._threshold(tb.ld, tb.j, tb.hp).dtype == torch.bfloat16


@pytest.mark.parametrize("plus_plus", [False, True])
def test_stacked_sieves_bf16_thresholds_follow_dtype(plus_plus):
    """The reference's stacked-sieve bf16 pin (test_session_spec.py):
    SieveStreaming(++) with a bf16 LogDet, port against JAX, and
    run == run_batched inside the port; the state and SS++'s lower bound
    stay bf16."""
    jf, tf = logdets(K=5, d=4, lengthscale=1.0)
    ja = JSieve(f=jf, eps=0.2, plus_plus=plus_plus)
    ta = TSieve(f=tf, eps=0.2, plus_plus=plus_plus)
    X = np.random.default_rng(9).standard_normal((50, 4)).astype(np.float32)
    js = jax.jit(ja.run_batched)(ja.init(), jnp.asarray(X))
    margins = {}
    tb = ta.run_batched(ta.init(), torch.from_numpy(X), margins=margins)
    tr = ta.run(ta.init(), torch.from_numpy(X))
    assert_clear_margins([margins], TIE_BF16)
    assert tb.lds.fval.dtype == tb.lb.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(js.lds.n), tb.lds.n.numpy())
    np.testing.assert_array_equal(np.asarray(js.alive), tb.alive.numpy())
    assert int(js.n_queries) == int(tb.n_queries)
    for name in ("feats", "Linv", "fval"):
        np.testing.assert_allclose(
            as_f32(getattr(js.lds, name)), as_f32(getattr(tb.lds, name)),
            rtol=BF16_TOL, atol=BF16_TOL, err_msg=name)
    np.testing.assert_allclose(as_f32(js.lb), as_f32(tb.lb), rtol=BF16_TOL,
                               atol=BF16_TOL)
    (fj, nj, vj), (fb, nb, vb) = ja.summary(js), ta.summary(tb)
    fr, nr, vr = ta.summary(tr)
    assert int(nj) == int(nb) == int(nr) > 0
    assert torch.equal(fb, fr) and torch.equal(vb, vr)
    np.testing.assert_allclose(as_f32(vj), as_f32(vb), rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_isi_weight_carry_follows_dtype():
    """The reference's ISI pin (test_algorithms.py): the insertion-time
    weights follow f.dtype and a bf16 gain lands in them exactly; the
    port's ISI then fills a bf16 summary item by item, as JAX's
    LogDet.append does.  A replacement refactors by Cholesky, which JAX
    cannot run in bf16 on the CPU (no LAPACK kernel); the port factors a
    bf16 state in float32 and stores it in bf16, so its ISI runs on past
    the fill, replacing, with the state bf16."""
    jf, tf = logdets(K=6, d=5, lengthscale=1.5)
    ja, ta = JISI(f=jf), TISI(f=tf)
    js, ts = ja.init(), ta.init()
    assert js.w.dtype == jnp.bfloat16 and ts.w.dtype == torch.bfloat16
    g = torch.tensor(0.625, dtype=torch.bfloat16)  # exact in bf16
    w2 = ts.w.clone()
    w2[0] = g
    assert w2.dtype == torch.bfloat16 and w2[0] == g
    X = stream(3, 6, 5)
    jld = js.ld
    for x in X:
        ts = ta.step(ts, torch.from_numpy(x))
        jld = jf.append(jld, jnp.asarray(x))
    assert ts.w.dtype == torch.bfloat16 and int(ts.ld.n) == 6
    assert bool(torch.isfinite(ts.w).all())
    assert int(jld.n) == int(ts.ld.n)
    for name in ("feats", "L", "Linv", "fval"):
        np.testing.assert_allclose(
            as_f32(getattr(jld, name)), as_f32(getattr(ts.ld, name)),
            rtol=BF16_TOL, atol=BF16_TOL, err_msg=name)
    # refill with near-duplicates (small insertion gains), then items far
    # apart, whose gains exceed twice the smallest weight: replacements
    ts = ta.init()
    for x in stream(5, 1, 5)[0] + stream(6, 6, 5, 0.05):
        ts = ta.step(ts, torch.from_numpy(x))
    filled = ts.ld.feats.clone()
    for x in stream(4, 20, 5, 3.0):
        ts = ta.step(ts, torch.from_numpy(x))
    assert not torch.equal(ts.ld.feats, filled)  # it replaced
    for name in ("feats", "L", "Linv", "fval"):
        assert getattr(ts.ld, name).dtype == torch.bfloat16, name
    assert ts.w.dtype == torch.bfloat16 and int(ts.ld.n) == 6
    # the refactored factors are those of the float64 Cholesky, rounded
    ref = TLogDet(K=6, d=5, kernel=tf.kernel, dtype=torch.float64,
                  device="cpu").refactor(ts.ld.feats.double(), ts.ld.n)
    np.testing.assert_allclose(as_f32(ts.ld.fval), ref.fval.numpy(),
                               rtol=BF16_TOL, atol=BF16_TOL)


def _mixed(algo):
    """Stacked states of four sessions with heterogeneous (K, T, eps,
    lengthscale, kind), the reference's ``_mixed_stack``."""
    hps = [algo.hyper(K=6, T=10, eps=0.2, lengthscale=1.5),
           algo.hyper(K=4, T=3, eps=0.5, lengthscale=0.7),
           algo.hyper(K=8, T=20, eps=0.1, lengthscale=2.0,
                      kernel_kind="linear_norm"),
           algo.hyper(K=3, T=5, eps=0.3, lengthscale=1.0)]
    return [algo.init(h) for h in hps]


def test_pod_step_bf16_mixed_stack_matches_jax():
    """The reference's bf16 pod-step pin (test_pod_step_kernel.py: three
    rounds of a mixed stack, n equal, fval within 0.05, the carry bf16):
    the port's pod step (its plain per-slot loop on the CPU) against the
    JAX pod step's ``jnp`` reference."""
    jf, tf = logdets(K=8, d=5, lengthscale=1.5)
    ja, ta = JThree(f=jf, eps=0.2, T=10), TThree(f=tf, eps=0.2, T=10)
    js = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *_mixed(ja))
    ts = tree_map(lambda *x: torch.stack(x), *_mixed(ta))
    S, C, d = 4, 12, 5
    margins = []
    for rnd in range(3):
        chunks = np.stack([stream(40 + 4 * rnd + s, C, d, 1.0)
                           for s in range(S)])
        counts = np.full((S,), C, np.int32)
        js = jax_pod_step(ja, js, jnp.asarray(chunks), jnp.asarray(counts),
                          backend="jnp")
        before = tree_map(lambda t: t.clone(), ts)
        ts = pod_step(ta, ts, torch.from_numpy(chunks),
                      torch.from_numpy(counts))
        # the same round again, with its decision margins recorded
        rnd_margins = [{} for _ in range(S)]
        pod_step_ref(ta, before, torch.from_numpy(chunks),
                     torch.from_numpy(counts), margins=rnd_margins)
        margins += rnd_margins
    assert_clear_margins(margins, TIE_BF16)
    for name in ("feats", "L", "Linv", "fval"):
        assert getattr(ts.ld, name).dtype == torch.bfloat16, name
    for name in ("n", "n_queries"):
        np.testing.assert_array_equal(np.asarray(getattr(js.ld, name)),
                                      getattr(ts.ld, name).numpy(), name)
    for name in ("j", "t", "n_fused"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name).numpy(), name)
    assert int(ts.ld.n.sum()) > 0
    np.testing.assert_allclose(as_f32(js.ld.fval), as_f32(ts.ld.fval),
                               rtol=BF16_TOL, atol=BF16_TOL)
    for name in ("feats", "Linv"):
        np.testing.assert_allclose(
            as_f32(getattr(js.ld, name)), as_f32(getattr(ts.ld, name)),
            rtol=BF16_TOL, atol=BF16_TOL, err_msg=name)


@pytest.mark.parametrize("stacked", [False, True])
def test_bf16_gains_route_to_f32_kernels(monkeypatch, stacked):
    """A bf16 LogDet reaches the float32 gain kernels through the
    wrappers' upcast, as the JAX wrappers upcast before ``pallas_call``.
    No card here, so the route is forced and each kernel is replaced by a
    recorder that checks what it was handed (float32, contiguous, the
    shapes and launch geometry of a float32 summary) and returns the plain
    float32 gains; the oracle casts them to bf16.  ThreeSieves (one
    summary: ``gain_traced``), SieveStreaming (I = 49 stacked summaries:
    ``gain_traced``) and ISI (``gain_static``) on that route against the
    plain route: integers equal, floats within BF16_TOL."""
    from repro_torch.kernels.rbf_gain import gain_grid, ops
    from repro_torch.kernels.rbf_gain.ref import gain_ref, gain_traced_ref

    seen = []

    def check(x, feats, linv):
        for t in (x, feats, linv):
            assert t.dtype == torch.float32 and t.is_contiguous()
        B, d = x.shape
        I = feats.shape[0] if feats.dim() == 3 else 1
        K = feats.shape[-2]
        assert feats.shape[-1] == d and linv.shape[-2:] == (K, K)
        bt, grid, smem = gain_grid(B, I, K)
        assert grid == (-(-B // bt), I) and smem <= 232448
        seen.append((feats.dim(), B, I, K))

    def traced(x, feats, linv, n, inv2l2, kind_id, *, a):
        check(x, feats, linv)
        assert n.dtype == kind_id.dtype == torch.int32
        from repro_torch.kernelmath import KernelParams
        kern = KernelParams(inv2l2=inv2l2.reshape(()),
                            kind_id=kind_id.reshape(()))
        return gain_traced_ref(x, feats, linv,
                               n.reshape(()) if feats.dim() == 2 else n,
                               kern, a=a)

    def static(x, feats, linv, n, *, a, inv2l2, kind="rbf"):
        check(x, feats, linv)
        mask = (torch.arange(feats.shape[0]) < n).to(torch.float32)
        return gain_ref(x, feats, linv, mask[None, :], a=a, inv2l2=inv2l2,
                        kind=kind)[:, 0]

    jf, tf = logdets(K=6, d=4, lengthscale=1.5)
    X = torch.from_numpy(
        np.random.default_rng(12).standard_normal((80, 4)).astype(np.float32))
    algos = ([TSieve(f=tf, eps=0.2)] if stacked
             else [TThree(f=tf, T=9, eps=0.1), TISI(f=tf)])
    plain = [a.run(a.init(), X) if isinstance(a, TISI)
             else a.run_batched(a.init(), X) for a in algos]
    monkeypatch.setattr(ops, "on_card", lambda x: True)
    monkeypatch.setattr(ops, "gain_traced", traced)
    monkeypatch.setattr(ops, "gain_static", static)
    routed = [a.run(a.init(), X) if isinstance(a, TISI)
              else a.run_batched(a.init(), X) for a in algos]
    assert {s[0] for s in seen} == ({3} if stacked else {2})
    for a, p, r in zip(algos, plain, routed):
        (fp, np_, vp), (fr, nr, vr) = a.summary(p), a.summary(r)
        assert torch.equal(np_, nr) and int(nr.sum()) > 0
        assert fr.dtype == vr.dtype == torch.bfloat16
        np.testing.assert_allclose(fp.float().numpy(), fr.float().numpy(),
                                   rtol=BF16_TOL, atol=BF16_TOL)
        np.testing.assert_allclose(vp.float().numpy(), vr.float().numpy(),
                                   rtol=BF16_TOL, atol=BF16_TOL)
