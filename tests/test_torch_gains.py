# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of the gain path: kernel rows, the gain oracle and the LogDet
Cholesky state, held against the JAX package on the same numpy inputs
(the JAX gain also through its Pallas kernel in interpret mode)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import kernelmath as jkm  # noqa: E402
from repro.core import oracle as jorc  # noqa: E402
from repro.core.functions import KernelConfig as JKC  # noqa: E402
from repro.core.functions import LogDet as JLogDet  # noqa: E402
from repro_torch import kernelmath as tkm  # noqa: E402
from repro_torch.core import oracle as torc  # noqa: E402
from repro_torch.core.functions import KernelConfig as TKC  # noqa: E402
from repro_torch.core.functions import LogDet as TLogDet  # noqa: E402
from repro_torch.core.functions import naive_logdet  # noqa: E402
from repro_torch.kernels.rbf_gain import (fused_gains_traced,  # noqa: E402
                                          gain_traced_ref)

from _torch_port import ATOL, RTOL, assert_states_match, stream  # noqa: E402

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
