# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Shared helpers of the tests/test_torch_*.py files: the same numpy
inputs through the JAX package and its PyTorch port, compared leaf by
leaf (integers equal; floats within f32 tolerance); and the port's
compile budget, ``compile_budget``."""
import contextlib

import numpy as np
import pytest
import torch

RTOL = ATOL = 1e-5  # f32, different summation order (XLA vs ATen) at K <= 8
TIE = 1e-4  # decision margins of the fixtures must exceed this


def jax_algo(K=8, d=5, T=10, eps=0.2, lengthscale=1.5, kind="rbf"):
    from repro.core import api
    from repro.core.spec import SessionSpec

    return api.make(SessionSpec(K=K, d=d, T=T, eps=eps,
                                lengthscale=lengthscale, kernel_kind=kind,
                                backend="jnp"))


def torch_algo(K=8, d=5, T=10, eps=0.2, lengthscale=1.5, kind="rbf",
               backend="torch"):
    from repro_torch.core import api
    from repro_torch.core.spec import SessionSpec

    return api.make(SessionSpec(K=K, d=d, T=T, eps=eps,
                                lengthscale=lengthscale, kernel_kind=kind,
                                backend=backend), device="cpu")


def jax_leaves(tree):
    from repro.ckpt.store import _flatten_with_keys

    return {k: np.asarray(v) for k, v in _flatten_with_keys(tree).items()}


def torch_leaves(tree):
    from repro_torch.tree import leaves_with_keys

    return {k: v.detach().cpu().numpy()
            for k, v in leaves_with_keys(tree).items()}


def assert_leaves_match(jl, tl, msg=""):
    assert set(jl) == set(tl), set(jl) ^ set(tl)
    for k in sorted(jl):
        a, b = np.asarray(jl[k]), np.asarray(tl[k])
        assert a.shape == b.shape, (msg, k, a.shape, b.shape)
        assert a.dtype == b.dtype, (msg, k, a.dtype, b.dtype)
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=f"{msg} {k}")
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{msg} {k}")


def assert_states_match(jax_state, torch_state, msg=""):
    assert_leaves_match(jax_leaves(jax_state), torch_leaves(torch_state), msg)


def assert_clear_margins(margins, bound=TIE):
    """Every decided item sits further than ``bound`` (relative) from its
    threshold, so one ulp of summation order cannot flip a decision."""
    ms = [m for d in margins for m in d.values()]
    assert ms, "no decisions were made"
    assert min(ms) > bound, f"near-tie fixture: min margin {min(ms)}"


def stream(seed, n, d, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(
        (n, d))).astype(np.float32)


def port_config(jcfg, **overrides):
    """The port's ``ModelConfig`` with the field values of a JAX package
    config (nested dataclasses rebuilt as the port's), then overrides."""
    import dataclasses

    from repro_torch.models import config as tc

    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(tc, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return dataclasses.replace(tc.ModelConfig(**kw), **overrides)


def model_pair(jcfg, *, seed=0, **port_overrides):
    """(JAX Model, JAX params, port Model on the CPU, port params): the
    JAX package's seeded init carried across key for key."""
    import jax

    from repro.models import Model as JModel
    from repro_torch.convert import model_params_from_jax
    from repro_torch.models import Model as TModel

    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = TModel(port_config(jcfg, **port_overrides), device="cpu")
    tp = tm.load(model_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    return jm, jp, tm, tp


class CompileBudget:
    """Counts fresh ``torch.compile`` (Dynamo) compiles; ``budget(n)``
    asserts at scope exit that at most ``n`` happened inside it (the
    port's ``retrace_guard``, tests/conftest.py).

    Usage::

        def test_x(compile_budget):
            step(x)                          # warm-up: compiles here
            with compile_budget.budget(0):   # the guarded region
                step(x)                      # must hit the cache
    """

    def __init__(self):
        self.compiles = 0
        self._active = False

    def _on_end(self, args):
        if self._active:
            self.compiles += 1

    @contextlib.contextmanager
    def budget(self, max_compiles=0):
        start = self.compiles
        self._active = True
        try:
            yield self
        finally:
            self._active = False
        fresh = self.compiles - start
        assert fresh <= max_compiles, (
            f"compile_budget: {fresh} fresh Dynamo compile(s) inside a "
            f"budget of {max_compiles}: something recompiled (new shapes, "
            "dtypes, a Python constant, or an uncached compile wrapper)")


_BUDGET = []  # the one CompileBudget, its listener registered once


@pytest.fixture
def compile_budget():
    """Per-test compile budget (``CompileBudget``): Dynamo has no
    per-test listener scope, so one listener is registered at first use
    and toggled."""
    if not _BUDGET:
        from torch._dynamo.callback import callback_handler

        _BUDGET.append(CompileBudget())
        callback_handler.register_end_callback(_BUDGET[0]._on_end)
    _BUDGET[0].compiles = 0
    _BUDGET[0]._active = False
    yield _BUDGET[0]
