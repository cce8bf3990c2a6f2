# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of the gain path: kernel rows, both gain kernels' plain versions
(traced and static, stacked summaries included), the gain oracle and the
LogDet Cholesky state (appends, stacked appends, refactor), held against
the JAX package on the same numpy inputs (the JAX gains also through
their Pallas kernels in interpret mode)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import kernelmath as jkm  # noqa: E402
from repro.core import oracle as jorc  # noqa: E402
from repro.core.functions import KernelConfig as JKC  # noqa: E402
from repro.core.functions import LogDet as JLogDet  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import kernelmath as tkm  # noqa: E402
from repro_torch.core import oracle as torc  # noqa: E402
from repro_torch.core.functions import KernelConfig as TKC  # noqa: E402
from repro_torch.core.functions import LogDet as TLogDet  # noqa: E402
from repro_torch.core.functions import LogDetState as TLogDetState  # noqa
from repro_torch.core.functions import naive_logdet  # noqa: E402
from repro_torch.kernels.rbf_gain import (fused_gains_traced,  # noqa: E402
                                          gain_traced_ref)

from _torch_port import (ATOL, RTOL, assert_states_match,  # noqa: E402
                         jax_leaves, stream)

K, D, B = 8, 6, 16
KINDS = {"rbf": 0, "linear_norm": 1}


def kern_pair(kind, ls=1.3):
    inv2l2 = 1.0 / (2.0 * ls * ls)
    return (jkm.KernelParams(inv2l2=jnp.float32(inv2l2),
                             kind_id=jnp.int32(KINDS[kind])),
            tkm.KernelParams(inv2l2=torch.tensor(inv2l2, dtype=torch.float32),
                             kind_id=torch.tensor(KINDS[kind],
                                                  dtype=torch.int32)))


def summary(kind, n, seed=0, ls=1.3):
    """A JAX LogDet state with n appended rows, and its numpy leaves."""
    jk, _ = kern_pair(kind, ls)
    f = JLogDet(K=K, d=D, kernel=JKC(kind, ls), backend="jnp")
    st = f.init()
    for x in stream(seed, n, D):
        st = f.append(st, jnp.asarray(x), jk)
    return f, st


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pairwise_traced_matches(kind):
    x, y = stream(1, B, D), stream(2, K, D)
    jk, tk = kern_pair(kind)
    want = np.asarray(jkm.pairwise_traced(jnp.asarray(x), jnp.asarray(y), jk))
    got = tkm.pairwise_traced(torch.from_numpy(x), torch.from_numpy(y), tk)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [0, 3, K])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_traced_gain_rows_match_jnp_and_interpret(kind, n):
    jk, tk = kern_pair(kind)
    _, st = summary(kind, n)
    X = stream(3, B, D)
    mask = (np.arange(K) < n).astype(np.float32)[None, :]
    want = np.asarray(jkm.traced_gain_rows(
        jnp.asarray(X), st.feats, st.Linv, jnp.asarray(mask), a=1.0,
        kern=jk))[:, 0]
    interp = np.asarray(jorc.GainOracle(
        kernel=JKC(kind, 1.3), backend="pallas-interpret").gains(
        st.feats, st.Linv, st.n, jnp.asarray(X), kern=jk))
    feats, linv = (torch.from_numpy(np.array(st.feats)),
                   torch.from_numpy(np.array(st.Linv)))
    got = tkm.traced_gain_rows(torch.from_numpy(X), feats, linv,
                               torch.from_numpy(mask), a=1.0, kern=tk)[:, 0]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), interp, rtol=RTOL, atol=ATOL)
    # the CPU wrapper of the gain_traced kernel is its plain version
    nt = torch.tensor(n, dtype=torch.int32)
    wrapped = fused_gains_traced(torch.from_numpy(X), feats, linv, nt, tk,
                                 a=1.0)
    assert torch.equal(wrapped, gain_traced_ref(torch.from_numpy(X), feats,
                                                linv, nt, tk, a=1.0))


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_oracle_gains_and_gain1_match(kind, backend):
    jk, tk = kern_pair(kind)
    _, st = summary(kind, 5)
    X = stream(4, B, D)
    jo = jorc.GainOracle(kernel=JKC(kind, 1.3), backend="jnp")
    to = torc.GainOracle(kernel=TKC(kind, 1.3), backend=backend)
    args_j = (st.feats, st.Linv, st.n)
    args_t = tuple(torch.from_numpy(np.array(a)) for a in args_j)
    for kj, kt in ((jk, tk), (None, None)):  # traced and static forms
        want = np.asarray(jo.gains(*args_j, jnp.asarray(X), kern=kj))
        got = to.gains(*args_t, torch.from_numpy(X), kern=kt)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        w1 = float(jo.gain1(*args_j, jnp.asarray(X[2]), kern=kj))
        g1 = float(to.gain1(*args_t, torch.from_numpy(X[2]), kern=kt))
        assert math.isclose(g1, w1, rel_tol=RTOL, abs_tol=ATOL)


def test_oracle_backends_have_no_fallback():
    _, tk = kern_pair("rbf")
    f = torch.zeros(K, D)
    eye = torch.eye(K)
    n = torch.tensor(0, dtype=torch.int32)
    X = torch.zeros(2, D)
    with pytest.raises(ValueError, match="CUDA tensors"):
        torc.GainOracle(backend="cuda").gains(f, eye, n, X, kern=tk)
    with pytest.raises(ValueError, match="invalid"):
        torc.GainOracle(backend="pallas")


@pytest.mark.parametrize("traced", [True, False])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_logdet_append_sequence_matches(kind, traced):
    jk, tk = kern_pair(kind)
    jf = JLogDet(K=K, d=D, kernel=JKC(kind, 1.3), backend="jnp")
    tf = TLogDet(K=K, d=D, kernel=TKC(kind, 1.3), backend="torch",
                 device="cpu")
    js, ts = jf.init(), tf.init()
    for i, x in enumerate(stream(5, K, D)):
        js = jf.append(js, jnp.asarray(x), jk if traced else None)
        ts = tf.append(ts, torch.from_numpy(x), tk if traced else None)
        assert_states_match(js, ts, msg=f"append {i}")
    # maybe_append with take=False leaves the state as it was
    full = tf.maybe_append(ts, torch.ones(D), torch.tensor(False), tk)
    assert all(torch.equal(a, b) for a, b in zip(
        (full.feats, full.L, full.Linv, full.n), (ts.feats, ts.L, ts.Linv,
                                                   ts.n)))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_logdet_fval_is_half_logdet_and_linv_inverts_l(kind):
    _, tk = kern_pair(kind, ls=0.9)
    tf = TLogDet(K=K, d=D, kernel=TKC(kind, 0.9), device="cpu")
    st = tf.init()
    X = stream(6, 6, D)
    for x in X:
        st = tf.append(st, torch.from_numpy(x), tk)
    ref = naive_logdet(torch.from_numpy(X).double(), TKC(kind, 0.9), 1.0)
    assert math.isclose(float(st.fval), float(ref), rel_tol=1e-5,
                        abs_tol=1e-5)
    np.testing.assert_allclose((st.L @ st.Linv).numpy(), np.eye(K),
                               atol=1e-5)


def test_gain_kernel_block_geometry():
    from repro_torch.kernels.rbf_gain import block_rows, gain_traced, smem_bytes
    from repro_torch.kernels.rbf_gain.kernel import SMEM_LIMIT

    assert [block_rows(k) for k in (1, 100, 384, 385, 1024, 3072)] == [
        64, 64, 64, 32, 16, 8]
    assert smem_bytes(1024) <= SMEM_LIMIT
    with pytest.raises(ValueError, match="budget"):
        block_rows(3073)
    z = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        gain_traced(z, z, z, z, z, z, a=1.0)


# (B, I, K) -> the tile and grid of one gain launch: two blocks per SM
# (264 on the H100) where B x I allows it, else the smallest tile
GAIN_GRIDS = [
    (1024, 1, 100, 8, (128, 1)),  # ThreeSieves: 128 blocks, not 16
    (1025, 1, 100, 8, (129, 1)),
    (7, 1, 100, 8, (1, 1)),
    (1, 1, 100, 8, (1, 1)),  # an ISI query
    (65536, 1, 100, 64, (1024, 1)),  # a Greedy round
    (1024, 49, 100, 64, (16, 49)),  # SieveStreaming's stack
    (1024, 147, 100, 64, (16, 147)),  # Salsa's stack
    (65536, 1, 1024, 32, (2048, 1)),  # 64 rows of Km at K = 1024 do not fit
    (1024, 1, 3072, 8, (128, 1)),
]


@pytest.mark.parametrize("B,I,K,bt,grid", GAIN_GRIDS)
def test_gain_grid_fills_the_card(B, I, K, bt, grid):
    from repro_torch.kernels.rbf_gain import gain_block_rows, gain_grid
    from repro_torch.kernels.rbf_gain.kernel import SMEM_LIMIT

    got_bt, got_grid, smem = gain_grid(B, I, K)
    assert (got_bt, got_grid) == (bt, grid)
    assert gain_block_rows(B, I, K) == bt
    assert smem <= SMEM_LIMIT


def test_gain_grid_threesieves_launches_64_blocks_or_more():
    from repro_torch.kernels.rbf_gain import gain_grid

    _, (bx, by), _ = gain_grid(1024, 1, 100)
    assert bx * by >= 64


@pytest.mark.parametrize("K", [1, 100, 384, 1024, 2048, 3072])
def test_gain_smem_fits_up_to_k_3072(K):
    """Every tile the geometry may pick at K fits the 227 KB of one block;
    at K = 3072 only the 8- and 16-row tiles do."""
    from repro_torch.kernels.rbf_gain import gain_block_rows, smem_bytes
    from repro_torch.kernels.rbf_gain.kernel import GAIN_TILES, SMEM_LIMIT

    fits = [bt for bt in GAIN_TILES if smem_bytes(K, bt) <= SMEM_LIMIT]
    assert fits and fits[-1] == 8
    for B, I in ((1, 1), (1024, 1), (65536, 1), (1024, 147)):
        assert smem_bytes(K, gain_block_rows(B, I, K)) <= SMEM_LIMIT
    if K == 3072:
        assert fits == [16, 8]


def test_gain_grid_refusal_past_k_3072_is_unchanged():
    from repro_torch.kernels.rbf_gain import gain_block_rows, gain_grid

    for fn in (lambda: gain_block_rows(1, 1, 3073),
               lambda: gain_grid(1024, 147, 4096)):
        with pytest.raises(ValueError, match="budget"):
            fn()


# ------------------------------------------------ static kernel (gain_pallas)
@pytest.mark.parametrize("n", [0, 3, K])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_gain_ref_matches_jax_ref_and_interpret(kind, n):
    """The plain ``gain_static`` against the JAX ``gain_ref`` and against
    ``gain_pallas`` in interpret mode; the CPU wrapper is the plain
    version."""
    from repro.kernels.rbf_gain import fused_gains as jfused
    from repro.kernels.rbf_gain.ref import gain_ref as jgain_ref
    from repro_torch.kernels.rbf_gain import fused_gains, gain_ref

    _, st = summary(kind, n, ls=0.9)
    X = stream(7, B, D)
    inv2l2 = 1.0 / (2.0 * 0.9 ** 2)
    mask = (np.arange(K) < n).astype(np.float32)[None, :]
    want = np.asarray(jgain_ref(jnp.asarray(X), st.feats, st.Linv,
                                jnp.asarray(mask), a=1.0, inv2l2=inv2l2,
                                kind=kind))[:, 0]
    interp = np.asarray(jfused(jnp.asarray(X), st.feats, st.Linv, st.n,
                               a=1.0, inv2l2=inv2l2, kind=kind,
                               interpret=True))
    feats, linv = (torch.from_numpy(np.array(st.feats)),
                   torch.from_numpy(np.array(st.Linv)))
    got = gain_ref(torch.from_numpy(X), feats, linv, torch.from_numpy(mask),
                   a=1.0, inv2l2=inv2l2, kind=kind)[:, 0]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), interp, rtol=RTOL, atol=ATOL)
    wrapped = fused_gains(torch.from_numpy(X), feats, linv,
                          torch.tensor(n, dtype=torch.int32), a=1.0,
                          inv2l2=inv2l2, kind=kind)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_kernel_block_matches_jax(kind):
    from repro.kernels.rbf_gain.ref import kernel_block as jkb
    from repro_torch.kernels.rbf_gain import kernel_block

    x, y = stream(8, B, D), stream(9, K, D)
    want = np.asarray(jkb(jnp.asarray(x), jnp.asarray(y), inv2l2=0.7,
                          kind=kind))
    got = kernel_block(torch.from_numpy(x), torch.from_numpy(y), inv2l2=0.7,
                       kind=kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_gain_static_block_rows_and_cpu_refusal():
    from repro_torch.kernels.rbf_gain import (gain_static, rbf_gain,
                                              static_block_rows)

    assert [static_block_rows(b, 100) for b in (1, 8, 9, 65536)] == [
        8, 8, 8, 64]
    assert static_block_rows(65536, 1024) == 32
    z = torch.zeros(2, 2)
    n = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        gain_static(z, z, z, n, a=1.0, inv2l2=1.0)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rbf_gain(z, z, z, n, a=1.0, inv2l2=1.0)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_stacked_traced_gains_match_jax_vmap(kind):
    """Stacked summaries (the instance axis of ``gain_traced``) against
    ``jax.vmap`` of the JAX oracle, and against the port's own unstacked
    call per instance."""
    import jax

    jk, tk = kern_pair(kind)
    states = [summary(kind, n, seed=s)[1] for s, n in ((0, 0), (1, 3),
                                                       (2, K))]
    X = stream(10, B, D)
    jf = JLogDet(K=K, d=D, kernel=JKC(kind, 1.3), backend="jnp")
    stk = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
    want = np.asarray(jax.vmap(lambda ld: jf.gains(ld, jnp.asarray(X), jk))(
        stk))
    feats, linv, n = (torch.from_numpy(np.array(a))
                      for a in (stk.feats, stk.Linv, stk.n))
    xt = torch.from_numpy(X)
    got = fused_gains_traced(xt, feats, linv, n, tk, a=1.0)
    assert got.shape == (3, B)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    for i in range(3):
        one = gain_traced_ref(xt, feats[i], linv[i], n[i], tk, a=1.0)
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), rtol=RTOL,
                                   atol=ATOL)
    # the oracle's stacked single-item query
    to = torc.GainOracle(kernel=TKC(kind, 1.3))
    g1 = to.gain1(feats, linv, n, xt[4], kern=tk)
    np.testing.assert_allclose(g1.numpy(), got[:, 4].numpy(), rtol=RTOL,
                               atol=ATOL)


# --------------------------------------------------- refactor / evaluate
@pytest.mark.parametrize("n", [0, 5, K])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_refactor_matches_jax_and_float64_slogdet(kind, n):
    X = stream(11, K, D)
    jf = JLogDet(K=K, d=D, kernel=JKC(kind, 0.9), backend="jnp")
    tf = TLogDet(K=K, d=D, kernel=TKC(kind, 0.9), device="cpu")
    js = jf.refactor(jnp.asarray(X), jnp.int32(n))
    ts = tf.refactor(torch.from_numpy(X), torch.tensor(n, dtype=torch.int32))
    assert_states_match(js, ts, msg="refactor")
    ref = naive_logdet(torch.from_numpy(X[:n]).double(), TKC(kind, 0.9), 1.0)
    assert math.isclose(float(tf.evaluate(torch.from_numpy(X),
                                          torch.tensor(n))),
                        float(ref), rel_tol=1e-5, abs_tol=1e-5)


def test_refactor_batches_over_leading_axes():
    """One batched factorization equals the per-buffer ones (Preemption's
    K swaps, QuickStream's c groups)."""
    tf = TLogDet(K=K, d=D, kernel=TKC("rbf", 0.9), device="cpu")
    X = torch.from_numpy(stream(12, 3 * K, D)).reshape(3, K, D)
    ns = torch.tensor([0, 4, K], dtype=torch.int32)
    batched = tf.refactor(X, ns)
    for i in range(3):
        one = tf.refactor(X[i], ns[i])
        for name in ("feats", "L", "Linv", "fval"):
            torch.testing.assert_close(getattr(batched, name)[i],
                                       getattr(one, name), rtol=RTOL,
                                       atol=ATOL)
        assert int(batched.n[i]) == int(one.n)


@pytest.mark.parametrize("traced", [True, False])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_stacked_append_matches_jax_vmap(kind, traced):
    import jax

    jk, tk = kern_pair(kind)
    states = [summary(kind, n, seed=s)[1] for s, n in ((0, 0), (1, 3),
                                                       (2, K - 1), (3, 5))]
    jf = JLogDet(K=K, d=D, kernel=JKC(kind, 1.3), backend="jnp")
    tf = TLogDet(K=K, d=D, kernel=TKC(kind, 1.3), device="cpu")
    stk = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
    takes = np.array([True, True, True, False])
    x = stream(13, 1, D)[0]
    want = jax.vmap(lambda ld, t: jf.maybe_append(
        ld, jnp.asarray(x), t, jk if traced else None))(stk,
                                                        jnp.asarray(takes))
    tst = convert.state_from_numpy(TLogDetState, jax_leaves(stk),
                                   device="cpu")
    got = tf.maybe_append_stacked(tst, torch.from_numpy(x),
                                  torch.from_numpy(takes),
                                  tk if traced else None)
    assert_states_match(want, got, msg="stacked append")
