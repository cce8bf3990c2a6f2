# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Uniform registry over all summary-selection algorithms (port of
``repro/core/api.py``).

Every algorithm exposes ``init / step / run / run_batched / summary /
memory_elements`` (Greedy: ``select``); the sieve family also carries its
(K, T, eps) as state (``init(algo.hyper(...))``) and counts
``insertions``.  ``make(spec)`` with a ``SessionSpec`` is the canonical
constructor; the kwarg form ``make(name, K, d, ...)`` is a shim over it.
``backend`` selects the gain oracle (``auto`` | ``torch`` | ``cuda``).
"""
from __future__ import annotations

import functools
from typing import Any, Union

from .baselines import (IndependentSetImprovement, PreemptionStreaming,
                        QuickStream, RandomReservoir)
from .functions import KernelConfig, LogDet, rbf_lengthscale_batch
from .greedy import Greedy
from .salsa import Salsa
from .sieves import SieveStreaming
from .spec import SessionSpec
from .threesieves import ThreeSieves

# name -> constructor(f, spec): the single registry ``ALGORITHMS``,
# ``make`` and (inverted) ``algo_name`` all derive from
_CONSTRUCTORS = {
    "threesieves": lambda f, s: ThreeSieves(f=f, T=s.T, eps=s.eps),
    "sievestreaming": lambda f, s: SieveStreaming(f=f, eps=s.eps,
                                                  plus_plus=False),
    "sievestreaming++": lambda f, s: SieveStreaming(f=f, eps=s.eps,
                                                    plus_plus=True),
    "salsa": lambda f, s: Salsa(f=f, eps=s.eps),
    "random": lambda f, s: RandomReservoir(f=f),
    "independentsetimprovement": lambda f, s: IndependentSetImprovement(f=f),
    "preemptionstreaming": lambda f, s: PreemptionStreaming(f=f),
    "quickstream": lambda f, s: QuickStream(f=f, c=s.c),
    "greedy": lambda f, s: Greedy(f=f),
}

ALGORITHMS = tuple(_CONSTRUCTORS)

# the sieve family: the threshold-ladder accept rule, a batched
# ``run_batched`` (one gain pass per state change) and per-instance
# hyperparameters as state
SIEVE_FAMILY = ("threesieves", "sievestreaming", "sievestreaming++",
                "salsa")

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
    """Canonical registry name of an algorithm instance (the inverse of
    ``make``), derived from the registry: each entry is built once on a
    throwaway CPU objective and matched by type and by the fields that
    tell entries of the same class apart (SieveStreaming vs ++)."""
    for name, probe in _registry_probes().items():
        if type(algo) is type(probe) and all(
                getattr(algo, f) == getattr(probe, f)
                for f in _DISTINGUISHING.get(type(probe).__name__, ())):
            return name
    raise ValueError(f"unknown algorithm instance {type(algo).__name__}")


# fields that tell registry entries of the SAME class apart
_DISTINGUISHING = {"SieveStreaming": ("plus_plus",)}


@functools.cache
def _registry_probes() -> dict:
    """One throwaway instance per registry entry."""
    spec = SessionSpec(K=1, d=1)
    f = LogDet(K=1, d=1, device="cpu")
    return {name: ctor(f, spec) for name, ctor in _CONSTRUCTORS.items()}


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
    if name not in _CONSTRUCTORS:
        raise ValueError(f"unknown algorithm {spec.algo!r}; choose from "
                         f"{ALGORITHMS}")
    f = make_objective(spec.K, spec.d, a=spec.a,
                       lengthscale=spec.lengthscale,
                       kernel_kind=spec.kernel_kind, backend=spec.backend,
                       device=device)
    return _CONSTRUCTORS[name](f, spec)
