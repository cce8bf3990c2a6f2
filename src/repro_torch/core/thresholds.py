# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The geometric threshold ladder (port of ``repro/core/thresholds.py``).

  * ``Ladder``        — static: the bounds (ilo/ihi/num_rungs) come from
                        float64 Python ``math``, exactly as in the JAX
                        package; ``HyperParams.build`` derives per-session
                        rows from it; ``value``/``values`` give its rungs
                        in float32.
  * ``rung_value`` /  — the same rung values from 0-dim (or batched)
    ``TracedLadder``    tensors, geometry in float32; ``values``/``valid``
                        materialize a stacked sieve's rung axis.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Ladder:
    """Rungs are indexed j = 0 (largest) .. num_rungs-1 (smallest)."""

    eps: float
    m: float  # max singleton value
    K: int

    def __post_init__(self):
        if not (isinstance(self.eps, (int, float))
                and math.isfinite(self.eps) and self.eps > 0):
            raise ValueError(
                f"eps must be a positive finite number, got {self.eps!r} "
                "(the threshold ladder is geometric in 1 + eps)")
        if int(self.K) < 1:
            raise ValueError(f"K must be >= 1, got {self.K!r}")
        if not (math.isfinite(self.m) and self.m > 0):
            raise ValueError(
                f"max singleton value m must be positive and finite, got "
                f"{self.m!r} (m = f({{e}}) of a normalized kernel)")

    @property
    def ilo(self) -> int:
        return math.ceil(math.log(self.m) / math.log1p(self.eps) - 1e-9)

    @property
    def ihi(self) -> int:
        return math.floor(math.log(self.K * self.m) / math.log1p(self.eps)
                          + 1e-9)

    @property
    def num_rungs(self) -> int:
        return max(self.ihi - self.ilo + 1, 1)

    def value(self, j, dtype=torch.float32):
        """Threshold at rung j (an int or a tensor; clamped), largest
        first: ``(1 + eps) ** (ihi - j)`` in float32, delivered in
        ``dtype`` on ``j``'s device (the CPU for an int)."""
        j = torch.as_tensor(j)
        jc = torch.clamp(j, 0, self.num_rungs - 1)
        base = torch.tensor(1.0 + self.eps, device=j.device)
        return torch.pow(base, (self.ihi - jc).to(torch.float32)).to(dtype)

    def values(self, dtype=torch.float32) -> torch.Tensor:
        """All rungs, descending (the materialized ladder), on the CPU."""
        i = torch.arange(self.num_rungs, dtype=torch.float32)
        return torch.pow(torch.tensor(1.0 + self.eps), self.ihi - i).to(dtype)


def rung_value(base, ihi, num_rungs, j, dtype=torch.float32):
    """Threshold at rung ``j``: clamp to the live rung range, then
    ``base ** (ihi - j)`` in f32, delivered in ``dtype``.

    The CUDA pod-step kernel evaluates the same formula with ``powf``
    (``csrc/pod_step.cu``)."""
    jc = torch.minimum(torch.clamp_min(j, 0), num_rungs - 1)
    v = torch.pow(base, (ihi - jc).to(torch.float32))
    return v.to(dtype)


@dataclasses.dataclass(frozen=True)
class TracedLadder:
    """Rung math over tensor hyperparameters (``HyperParams`` rows)."""

    base: torch.Tensor  # () float32 — 1 + eps
    ihi: torch.Tensor  # () int32
    num_rungs: torch.Tensor  # () int32

    @classmethod
    def of(cls, hp) -> "TracedLadder":
        return cls(base=hp.base, ihi=hp.ihi, num_rungs=hp.num_rungs)

    def value(self, j, dtype=torch.float32):
        return rung_value(self.base, self.ihi, self.num_rungs, j, dtype)

    def values(self, cap: int, dtype=torch.float32):
        """Materialized rungs for a ``cap``-instance stack, descending.

        Entries past ``num_rungs`` belong to dead instances (``valid``);
        they continue the geometric sequence but never reach a decision.
        """
        i = torch.arange(cap, dtype=torch.int32, device=self.base.device)
        v = torch.pow(self.base, (self.ihi - i).to(torch.float32))
        return v.to(dtype)

    def valid(self, cap: int) -> torch.Tensor:
        """(cap,) bool — which stacked rung instances are live for this
        (K, eps)."""
        i = torch.arange(cap, dtype=torch.int32, device=self.base.device)
        return i < self.num_rungs
