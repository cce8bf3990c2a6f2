# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""SessionSpec and HyperParams (port of ``repro/core/spec.py``).

``SessionSpec`` is the plain, validated construction-time description of
a session.  ``HyperParams`` is its state form: (K, T, eps), the ladder
bounds and the kernel constants as 0-dim tensors, carried inside the
algorithm state so one pod hosts tenants with different budgets and
kernels.  The bounds are derived on the host in float64 by ``Ladder``,
the same arithmetic as the JAX package, so the rows agree bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

from repro_torch.kernelmath import KERNEL_KIND_IDS, KernelParams

from .thresholds import Ladder


@dataclasses.dataclass(frozen=True)
class HyperParams:
    """Per-instance (K, T, eps) + derived ladder geometry, as tensors."""

    k_cap: torch.Tensor  # () int32 — summary budget K
    T: torch.Tensor  # () int32 — Rule-of-Three observation count
    eps: torch.Tensor  # () float32 — ladder resolution (informational)
    base: torch.Tensor  # () float32 — 1 + eps, rounded once on the host
    ihi: torch.Tensor  # () int32 — top rung index
    num_rungs: torch.Tensor  # () int32 — live rung count
    lengthscale: torch.Tensor  # () float32 — informational
    inv2l2: torch.Tensor  # () float32 — 1/(2 l^2), float64 then rounded
    kernel_kind: torch.Tensor  # () int32 — KERNEL_KIND_IDS id

    @property
    def kern(self) -> KernelParams:
        return KernelParams(inv2l2=self.inv2l2, kind_id=self.kernel_kind)

    @classmethod
    def build(cls, *, K: int, T: int, eps: float, m: float,
              lengthscale: float = 1.0,
              kernel_kind: Union[str, int] = "rbf",
              device="cpu") -> "HyperParams":
        """Host-side constructor: validates, derives the ladder bounds and
        the kernel constant in float64, and freezes them into 0-dim
        tensors on ``device``."""
        if int(T) < 1:
            raise ValueError(f"T must be >= 1 (got {T!r}): ThreeSieves "
                             "discards a threshold after T consecutive "
                             "rejections, and T = 0 divides by zero")
        if isinstance(kernel_kind, str):
            if kernel_kind not in KERNEL_KIND_IDS:
                raise ValueError(
                    f"unknown kernel kind {kernel_kind!r}; choose from "
                    f"{sorted(KERNEL_KIND_IDS)}")
            kind_id = KERNEL_KIND_IDS[kernel_kind]
        else:
            kind_id = int(kernel_kind)
            if kind_id not in KERNEL_KIND_IDS.values():
                raise ValueError(
                    f"unknown kernel kind id {kind_id!r}; known ids: "
                    f"{sorted(KERNEL_KIND_IDS.values())}")
        ls = float(lengthscale)
        if not (math.isfinite(ls) and ls > 0.0):
            raise ValueError(f"lengthscale must be a positive finite "
                             f"number, got {lengthscale!r}")
        lad = Ladder(eps=float(eps), m=float(m), K=int(K))  # validates eps/K

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=device)

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return cls(
            k_cap=i32(int(K)),
            T=i32(int(T)),
            eps=f32(float(eps)),
            base=f32(1.0 + float(eps)),
            ihi=i32(lad.ihi),
            num_rungs=i32(lad.num_rungs),
            lengthscale=f32(ls),
            inv2l2=f32(1.0 / (2.0 * ls * ls)),
            kernel_kind=i32(kind_id),
        )


@dataclasses.dataclass(frozen=True)
class SessionSpec:
    """One session's full configuration — the canonical ``make`` input.

    ``d`` may stay ``None`` for admission specs (the pod's objective fixes
    it); ``make`` requires it.
    """

    algo: str = "threesieves"
    K: int = 10
    T: int = 500
    eps: float = 0.1
    d: Optional[int] = None
    a: float = 1.0
    lengthscale: Optional[float] = None
    kernel_kind: str = "rbf"
    backend: Optional[str] = None
    c: int = 4  # QuickStream buffer factor

    def __post_init__(self):
        if int(self.K) < 1:
            raise ValueError(f"K must be >= 1, got {self.K!r}")
        if not (math.isfinite(float(self.eps)) and float(self.eps) > 0.0):
            raise ValueError(f"eps must be a positive finite number, got "
                             f"{self.eps!r} — the threshold ladder is "
                             "geometric in (1 + eps)")
        if int(self.T) < 1:
            raise ValueError(f"T must be >= 1, got {self.T!r}")
        if self.d is not None and int(self.d) < 1:
            raise ValueError(f"d must be >= 1, got {self.d!r}")
        if int(self.c) < 1:
            raise ValueError(f"c must be >= 1, got {self.c!r}")
        if self.kernel_kind not in KERNEL_KIND_IDS:
            raise ValueError(f"unknown kernel kind {self.kernel_kind!r}; "
                             f"choose from {sorted(KERNEL_KIND_IDS)}")
        if self.lengthscale is not None:
            ls = float(self.lengthscale)
            if not (math.isfinite(ls) and ls > 0.0):
                raise ValueError(f"lengthscale must be a positive finite "
                                 f"number, got {self.lengthscale!r}")

    def replace(self, **kw) -> "SessionSpec":
        return dataclasses.replace(self, **kw)
