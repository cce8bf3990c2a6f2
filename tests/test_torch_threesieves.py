# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ThreeSieves: ``run_batched`` against the JAX package on the
same numpy streams (ragged ``n_valid``, saturated summaries, several
chunks), and ``run == run_batched`` inside the port."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from _torch_port import (assert_clear_margins, assert_states_match,  # noqa
                         jax_algo, stream, torch_algo)

D, C = 6, 16
CASES = {
    # name: (hyper kwargs, chunk scale, n_valid per chunk)
    "ragged": (dict(K=8, T=4, eps=0.2, lengthscale=1.0), 0.5,
               [16, 7, 0, 1, 16, 11]),
    "saturated": (dict(K=3, T=3, eps=0.3, lengthscale=0.6), 2.0,
                  [16, 16, 16]),
    "linear_norm": (dict(K=6, T=5, eps=0.1, lengthscale=1.0,
                         kind="linear_norm"), 0.5, [16, 16, 9, 16]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_batched_matches_jax(case):
    hyper, scale, counts = CASES[case]
    ja, ta = jax_algo(d=D, **hyper), torch_algo(d=D, **hyper)
    step = jax.jit(ja.run_batched)
    js, ts = ja.init(), ta.init()
    margins = []
    for i, nv in enumerate(counts):
        X = stream(100 + i, C, D, scale)
        js = step(js, jnp.asarray(X), jnp.int32(nv))
        margins.append({})
        ts = ta.run_batched(ts, torch.from_numpy(X), nv, margins=margins[-1])
        assert_states_match(js, ts, msg=f"{case} chunk {i}")
    assert_clear_margins(margins)
    assert int(ts.ld.n) > 0
    if case == "saturated":
        assert int(ts.ld.n) == int(ts.hp.k_cap)


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_equals_run_batched(case):
    hyper, scale, counts = CASES[case]
    ta = torch_algo(d=D, **hyper)
    a, b = ta.init(), ta.init()
    for i, nv in enumerate(counts):
        X = torch.from_numpy(stream(200 + i, C, D, scale))
        a = ta.run(a, X, nv)
        b = ta.run_batched(b, X, nv)
    # run counts no fused passes; everything else is equal
    b = dataclasses.replace(b, n_fused=a.n_fused)
    for name in ("feats", "L", "Linv", "n", "fval", "n_queries"):
        assert torch.allclose(getattr(a.ld, name), getattr(b.ld, name),
                              rtol=1e-5, atol=1e-5), name
    assert (int(a.j), int(a.t)) == (int(b.j), int(b.t))
