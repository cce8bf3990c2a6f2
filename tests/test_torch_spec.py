# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of the numeric foundation: HyperParams, Ladder, SessionSpec, and
the package guards (no JAX, explicit device)."""
import math
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.spec import HyperParams as JHyper  # noqa: E402
from repro.core.spec import SessionSpec as JSpec  # noqa: E402
from repro.core.thresholds import Ladder as JLadder  # noqa: E402
from repro_torch.core.spec import HyperParams as THyper  # noqa: E402
from repro_torch.core.spec import SessionSpec as TSpec  # noqa: E402
from repro_torch.core.thresholds import Ladder as TLadder  # noqa: E402

from _torch_port import jax_leaves, torch_leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
M = 0.5 * math.log(2.0)


@pytest.mark.parametrize("K,T,eps,ls,kind", [
    (1, 1, 0.5, 1.0, "rbf"), (10, 500, 0.05, 1 / (2 * 16), "rbf"),
    (50, 1000, 0.01, 1 / 16, "rbf"), (100, 2500, 0.005, 1 / 16,
                                      "linear_norm"),
    (7, 3, 0.3, 2.5, 1), (1024, 10, 1e-3, 0.37, "rbf"),
])
def test_hyperparams_rows_bit_equal(K, T, eps, ls, kind):
    j = jax_leaves(JHyper.build(K=K, T=T, eps=eps, m=M, lengthscale=ls,
                                kernel_kind=kind))
    t = torch_leaves(THyper.build(K=K, T=T, eps=eps, m=M, lengthscale=ls,
                                  kernel_kind=kind, device="cpu"))
    assert set(j) == set(t)
    for k in j:
        assert j[k].dtype == t[k].dtype, k
        assert j[k].tobytes() == t[k].tobytes(), (k, j[k], t[k])


@pytest.mark.parametrize("eps,m,K", [(0.1, M, 10), (0.01, M, 100),
                                     (1e-3, 0.2, 1), (0.5, 3.0, 17)])
def test_ladder_bounds_equal(eps, m, K):
    a, b = JLadder(eps=eps, m=m, K=K), TLadder(eps=eps, m=m, K=K)
    assert (a.ilo, a.ihi, a.num_rungs) == (b.ilo, b.ihi, b.num_rungs)


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("kw", [
    {"K": 0}, {"eps": 0.0}, {"eps": float("nan")}, {"T": 0}, {"d": 0},
    {"c": 0}, {"kernel_kind": "poly"}, {"lengthscale": -1.0},
])
def test_session_spec_validation_messages(kw):
    assert _message(lambda: JSpec(**kw)) == _message(lambda: TSpec(**kw))


@pytest.mark.parametrize("kw", [
    {"T": 0}, {"kernel_kind": "poly"}, {"kernel_kind": 5},
    {"lengthscale": 0.0}, {"eps": -0.1}, {"K": 0},
])
def test_hyperparams_build_validation_messages(kw):
    base = dict(K=4, T=5, eps=0.1, m=M)
    base.update(kw)
    assert (_message(lambda: JHyper.build(**base))
            == _message(lambda: THyper.build(**base, device="cpu")))


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch.serve.summarize, repro_torch.convert, "
            "repro_torch.core.api, repro_torch.launch.serve, "
            "repro_torch.kernels.flash_attention; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_import_no_jax_and_no_repro():
    banned = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert files
    for p in files:
        for line in p.read_text().splitlines():
            assert not banned.match(line), (p, line)
    assert banned.match("from repro.core import api")
    assert banned.match("import jax.numpy as jnp")
    assert not banned.match("from repro_torch.core import api")


def test_port_files_carry_the_podlint_skip_line():
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
             + sorted((ROOT / "tests").glob("test_torch_*.py"))
             + [ROOT / "tests" / "_torch_port.py"])
    for p in files:
        head = p.read_text().splitlines()[:5]
        assert any("podlint: skip-file" in ln for ln in head), p


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None legitimately runs there")
    from repro_torch.core.api import make
    from repro_torch.core.functions import LogDet
    from repro_torch.serve.summarize import SummarizerPod

    spec = TSpec(K=4, d=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        LogDet(K=4, d=3)
    algo = make(spec, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SummarizerPod(algo=algo, sessions=2, chunk=4)
    pod = SummarizerPod(algo=algo, sessions=2, chunk=4, device="cpu")
    assert pod.init().sid.device.type == "cpu"


def test_make_registry_threesieves_only():
    """Every name of the JAX registry, and every alias, builds in the
    port; unknown names and a missing d are refused."""
    from repro_torch.core.api import ALGORITHMS, _ALIASES, algo_name, make

    assert len(ALGORITHMS) == 9
    for name in ALGORITHMS + tuple(_ALIASES):
        algo = make(TSpec(algo=name, K=4, d=3), device="cpu")
        assert algo_name(algo) == _ALIASES.get(name, name)
        assert algo.f.K == 4 and algo.f.device.type == "cpu"
    with pytest.raises(ValueError, match="unknown algorithm"):
        make(TSpec(algo="nope", K=4, d=3), device="cpu")
    with pytest.raises(ValueError, match="SessionSpec.d"):
        make(TSpec(K=4), device="cpu")
    algo = make("threesieves", 4, 3, device="cpu")
    assert np.isclose(algo.f.singleton_value, M)
