# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Algorithm registry (port of ``repro/core/api.py``), ThreeSieves only.

``make(spec)`` with a ``SessionSpec`` is the canonical constructor; the
kwarg form ``make(name, K, d, ...)`` is a shim over it.  The other
algorithms of the JAX registry raise ``NotImplementedError`` until they
are ported (ROADMAP.md, section 1).
"""
from __future__ import annotations

from typing import Any, Union

from .functions import KernelConfig, LogDet, rbf_lengthscale_batch
from .spec import SessionSpec
from .threesieves import ThreeSieves

_CONSTRUCTORS = {
    "threesieves": lambda f, s: ThreeSieves(f=f, T=s.T, eps=s.eps),
}

ALGORITHMS = tuple(_CONSTRUCTORS)

# registered in the JAX package, not yet in the port
NOT_PORTED = ("sievestreaming", "sievestreaming++", "salsa", "random",
              "independentsetimprovement", "preemptionstreaming",
              "quickstream", "greedy")

_ALIASES = {
    "sievestreamingpp": "sievestreaming++",
    "isi": "independentsetimprovement",
    "preemption": "preemptionstreaming",
}


def make_objective(K: int, d: int, a: float = 1.0,
                   lengthscale: float | None = None,
                   kernel_kind: str = "rbf", backend: str | None = None,
                   device=None) -> LogDet:
    if lengthscale is None:
        lengthscale = rbf_lengthscale_batch(d)
    return LogDet(K=K, d=d, a=a,
                  kernel=KernelConfig(kind=kernel_kind,
                                      lengthscale=lengthscale),
                  backend=backend, device=device)


def algo_name(algo: Any) -> str:
    """Canonical registry name of an algorithm instance."""
    if type(algo) is ThreeSieves:
        return "threesieves"
    raise ValueError(f"unknown algorithm instance {type(algo).__name__}")


def make(spec: Union[SessionSpec, str], K: int | None = None,
         d: int | None = None, *, a: float = 1.0,
         lengthscale: float | None = None, eps: float = 0.1, T: int = 500,
         c: int = 4, kernel_kind: str = "rbf", backend: str | None = None,
         device=None) -> Any:
    """Build an algorithm on ``device`` (``None`` means ``cuda``) from a
    ``SessionSpec`` or from the kwarg form ``make(name, K, d, ...)``."""
    if isinstance(spec, SessionSpec):
        if K is not None or d is not None:
            raise TypeError("make(spec) takes no positional K/d — put them "
                            "in the SessionSpec")
    else:
        if K is None or d is None:
            raise TypeError("make(name, K, d, ...) requires K and d")
        spec = SessionSpec(algo=str(spec), K=K, d=d, a=a,
                           lengthscale=lengthscale, eps=eps, T=T, c=c,
                           kernel_kind=kernel_kind, backend=backend)
    if spec.d is None:
        raise ValueError("SessionSpec.d is required to construct an "
                         "algorithm (admission specs may omit it; "
                         "construction cannot)")
    name = _ALIASES.get(spec.algo.lower(), spec.algo.lower())
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported to repro_torch yet; only "
            f"{ALGORITHMS} is (see ROADMAP.md, section 1)")
    if name not in _CONSTRUCTORS:
        raise ValueError(f"unknown algorithm {spec.algo!r}; choose from "
                         f"{ALGORITHMS}")
    f = make_objective(spec.K, spec.d, a=spec.a,
                       lengthscale=spec.lengthscale,
                       kernel_kind=spec.kernel_kind, backend=spec.backend,
                       device=device)
    return _CONSTRUCTORS[name](f, spec)
