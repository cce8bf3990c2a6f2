# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The port's backend selection (``core/oracle.py``: ``default_backend``,
``resolve_backend``, ``GainOracle.resolved``; ``kernels/pod_step/ops.py``:
``default_backend``, ``resolve``), held against the reference's
(``repro/core/oracle.py:62-93``, ``repro/kernels/pod_step/ops.py:
59-105``) where they agree, and raising where the reference degrades to
its plain path with a warning: the port never falls back."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import oracle as toracle  # noqa: E402
from repro_torch.core.functions import KernelConfig  # noqa: E402
from repro_torch.core.sieve_family import stack_states  # noqa: E402
from repro_torch.kernels.pod_step import ops as pops  # noqa: E402
from repro_torch.tree import leaves_with_keys  # noqa: E402

ORACLE_ENV, PODSTEP_ENV = ("REPRO_TORCH_ORACLE_BACKEND",
                           "REPRO_TORCH_PODSTEP_BACKEND")
CUDA = torch.device("cuda")  # a device name only: nothing is placed there


@pytest.fixture
def clean_env(monkeypatch):
    for var in (ORACLE_ENV, PODSTEP_ENV, "REPRO_ORACLE_BACKEND",
                "REPRO_PODSTEP_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


# ---------------------------------------------------------------- oracle
@pytest.mark.parametrize("mod,var", [(toracle, ORACLE_ENV),
                                     (pops, PODSTEP_ENV)])
def test_default_backend_reads_the_ports_own_variable(mod, var, clean_env):
    assert mod.default_backend() == "auto"
    for name in mod.BACKENDS:
        clean_env.setenv(var, name)
        assert mod.default_backend() == name
    clean_env.setenv(var, "pallas")  # a JAX package value: invalid here
    with pytest.raises(ValueError, match=r"choose from \('auto', 'torch', "
                                         r"'cuda'\)"):
        mod.default_backend()
    # the JAX package's variables do not reach the port
    clean_env.delenv(var)
    clean_env.setenv("REPRO_ORACLE_BACKEND", "pallas")
    clean_env.setenv("REPRO_PODSTEP_BACKEND", "jnp")
    assert mod.default_backend() == "auto"


@pytest.mark.parametrize("backend,device,route", [
    ("auto", "cpu", "plain"), ("auto", CUDA, "cuda"),
    ("torch", "cpu", "torch"), ("torch", CUDA, "torch"),
    ("cuda", CUDA, "cuda")])
def test_resolve_backend(backend, device, route):
    assert toracle.resolve_backend(backend, device) == route
    assert toracle.GainOracle(backend=backend).resolved(device) == route


def test_explicit_cuda_on_the_cpu_raises_where_jax_degrades():
    """The reference runs ``pallas`` off the TPU as ``jnp`` with a warning
    and a fallback count; the port raises, with the reason."""
    with pytest.raises(ValueError, match="does not fall back"):
        toracle.resolve_backend("cuda", "cpu")
    with pytest.raises(ValueError, match="invalid"):
        toracle.resolve_backend("pallas", "cpu")
    f = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        toracle.GainOracle(backend="cuda").gains(
            f, torch.eye(4), torch.tensor(0), torch.zeros(2, 3))


def test_make_reads_the_process_default(clean_env):
    """``make(backend=None)`` takes the variable's backend, and that
    backend's route prices the same gains as asking for it by name."""
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32))
    linv, n = torch.eye(4), torch.tensor(2)
    kern = KernelConfig(lengthscale=1.3)
    assert toracle.make(kern).backend == "auto"
    clean_env.setenv(ORACLE_ENV, "torch")
    o = toracle.make(kern)
    assert o.backend == "torch" and o.resolved(X.device) == "torch"
    assert toracle.make(kern, backend="auto").backend == "auto"
    assert torch.equal(o.gains(feats, linv, n, X), toracle.make(
        kern, backend="torch").gains(feats, linv, n, X))
    clean_env.setenv(ORACLE_ENV, "jnp")
    with pytest.raises(ValueError, match=ORACLE_ENV):
        toracle.make(kern)


# -------------------------------------------------------------- pod step
def _algo(name):
    return tapi.make(name, K=4, d=3, lengthscale=1.0, eps=0.3,
                     backend="torch", device="cpu")


@pytest.mark.parametrize("name,backend,device,route", [
    ("threesieves", "auto", "cpu", "torch"),
    ("threesieves", "auto", CUDA, "cuda"),
    ("threesieves", "cuda", CUDA, "cuda"),
    ("threesieves", "torch", CUDA, "torch"),
    ("sievestreaming++", "auto", "cpu", "slots"),
    ("sievestreaming++", "auto", CUDA, "slots"),
    ("salsa", "cuda", CUDA, "cuda"),
    ("salsa", "torch", "cpu", "torch"),
    ("quickstream", "auto", CUDA, "torch"),
    ("quickstream", "torch", "cpu", "torch")])
def test_pod_step_resolve(name, backend, device, route):
    assert pops.resolve(backend, _algo(name), device=device) == route


@pytest.mark.parametrize("name,device,match", [
    ("threesieves", "cpu", "needs CUDA tensors"),
    ("quickstream", CUDA, "QuickStream has no pod-step kernel"),
    ("quickstream", "cpu", "needs CUDA tensors")])
def test_pod_step_cuda_request_raises_where_jax_degrades(name, device,
                                                         match):
    """The reference degrades ``pallas`` for an algorithm without a fused
    kernel (and off the TPU) to its jnp path with a warning; the port
    raises, naming the reason."""
    with pytest.raises(ValueError, match=match):
        pops.resolve("cuda", _algo(name), device=device)
    with pytest.raises(ValueError, match="invalid"):
        pops.resolve("pallas", _algo(name), device="cpu")


def test_pod_step_default_reads_the_variable(clean_env):
    """``pod_step(backend=None)`` takes REPRO_TORCH_PODSTEP_BACKEND: under
    ``torch`` a stacked sieve runs the per-slot loop, not ``run_slots``."""
    algo = _algo("sievestreaming")
    state = stack_states(algo.init(), 2)
    chunks = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 6, 3)).astype(np.float32))
    counts = torch.tensor([6, 3], dtype=torch.int32)
    calls = []
    ref = pops.pod_step_ref

    def counted(*a, **kw):
        calls.append(1)
        return ref(*a, **kw)

    clean_env.setattr(pops, "pod_step_ref", counted)
    pops.pod_step(algo, state, chunks, counts)  # auto: run_slots
    assert calls == []
    clean_env.setenv(PODSTEP_ENV, "torch")
    want = stack_states(algo.init(), 2)
    pops.pod_step(algo, want, chunks, counts, backend="torch")
    got = stack_states(algo.init(), 2)
    pops.pod_step(algo, got, chunks, counts)
    assert len(calls) == 2
    a, b = leaves_with_keys(got), leaves_with_keys(want)
    assert all(torch.equal(a[k], b[k]) for k in a)
