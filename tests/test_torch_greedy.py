# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of Greedy, the paper's quality yardstick: the same selected rows
and f(S) as the JAX package on the same ground set, through both oracle
backends (``auto`` on a CPU tensor runs the plain ``gain_static``)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import api as japi  # noqa: E402
from repro.core.spec import SessionSpec as JSpec  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core.functions import KernelConfig, naive_logdet  # noqa
from repro_torch.core.spec import SessionSpec as TSpec  # noqa: E402

from _torch_port import ATOL, RTOL, TIE, stream  # noqa: E402

D, N = 7, 64


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("kind,ls,K,scale", [
    ("rbf", 0.8, 8, 0.1), ("rbf", 2.0, 5, 0.3), ("linear_norm", 1.0, 6, 0.3)])
def test_greedy_select_matches_jax(kind, ls, K, scale, backend):
    kw = dict(algo="greedy", K=K, d=D, lengthscale=ls, kernel_kind=kind)
    ja = japi.make(JSpec(backend="jnp", **kw))
    ta = tapi.make(TSpec(backend=backend, **kw), device="cpu")
    # items close enough that every round's top two gains stay apart
    X = stream(400 + K, N, D, scale)
    jf, jn, jv = ja.select(jnp.asarray(X))
    margins = []
    tf, tn, tv = ta.select(torch.from_numpy(X), margins=margins)
    # round 0 prices every item at the empty summary: an exact tie that
    # every implementation breaks the same way (the first item)
    assert min(margins[1:]) > TIE, margins
    assert int(tn) == int(jn) == K
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert math.isclose(float(tv), float(jv), rel_tol=RTOL, abs_tol=ATOL)
    want = naive_logdet(tf.double(), KernelConfig(kind, ls), 1.0)
    assert math.isclose(float(tv), float(want), rel_tol=1e-5, abs_tol=1e-5)


def test_greedy_beats_every_streaming_algorithm():
    """Greedy is the yardstick: on one stream each sieve's summary is no
    better than Greedy's (f / f_greedy <= 1 + tolerance)."""
    X = torch.from_numpy(stream(420, N, D, 0.8))
    kw = dict(K=6, d=D, lengthscale=0.8, eps=0.2, T=8)
    _, _, fg = tapi.make(TSpec(algo="greedy", **kw),
                         device="cpu").select(X)
    for name in tapi.SIEVE_FAMILY:
        algo = tapi.make(TSpec(algo=name, **kw), device="cpu")
        st = algo.run_batched(algo.init(), X)
        _, n, f = algo.summary(st)
        assert 0 < int(n) <= 6
        assert 0.0 < float(f) / float(fg) <= 1.0 + 1e-5, name
