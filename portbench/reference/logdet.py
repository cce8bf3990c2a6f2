"""The IVM log-determinant objective f(S) = 1/2 log det(I + a K_SS), kept
as a Cholesky factor L of I + a K_SS and grown one row at a time.

``Arith`` fixes the precision the arithmetic runs in: ``float64`` is the
reference; ``tf32`` is its control, float32 with the operands of every
inner product rounded to TF32 (10 explicit mantissa bits, as the tensor
cores take them), the step below the float32 that the configurations
state.
"""
from __future__ import annotations

import math

import torch

GAIN_FLOOR = 1e-12  # the residual (1 + a) - |c|^2 is clamped here, then log
NORM_FLOOR = 1e-12  # row norms of the linear_norm kernel
KINDS = {"rbf": 0, "linear_norm": 1}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at 10 mantissa bits."""
    x = x.to(torch.float32).contiguous()
    v = x.view(torch.int32)
    bias = 0x0FFF + ((v >> 13) & 1)
    return ((v + bias) & ~0x1FFF).view(torch.float32)


class Arith:
    """The precision of a run: ``float64`` (the reference) or ``tf32``."""

    def __init__(self, precision: str):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32

    def kernel(self, x, Y, inv2l2, kind):
        """k(x, y) of each row of Y (..., K, d) against x (..., d) ->
        (..., K); ``inv2l2`` and ``kind`` broadcast over the leading axes.
        The reference takes squared distances from differences; the
        control from the expanded inner product, as a matrix unit would."""
        if self.precision == "float64":
            diff = Y - x[..., None, :]
            d2 = (diff * diff).sum(-1)
            g = (Y * x[..., None, :]).sum(-1)
        else:
            g = (tf32_round(Y) @ tf32_round(x)[..., :, None])[..., 0]
            d2 = torch.clamp_min((x * x).sum(-1)[..., None] + (Y * Y).sum(-1)
                                 - 2.0 * g, 0.0)
        rbf = torch.exp(-inv2l2[..., None] * d2)
        nx = torch.clamp_min(torch.linalg.vector_norm(x, dim=-1), NORM_FLOOR)
        ny = torch.clamp_min(torch.linalg.vector_norm(Y, dim=-1), NORM_FLOOR)
        lin = 0.5 * (g / (nx[..., None] * ny) + 1.0)
        return torch.where(kind[..., None] == KINDS["rbf"], rbf, lin)

    def gain(self, L, kx, live, a):
        """Whitened residual of a candidate against summaries with factors
        L (..., K, K) and kernel row kx (..., K) on the ``live`` rows ->
        (c (..., K), residual (...), gain (...))."""
        rhs = (a * kx * live)[..., None]
        c = torch.linalg.solve_triangular(L, rhs, upper=False)[..., 0]
        res = torch.clamp_min((1.0 + a) - (c * c).sum(-1), GAIN_FLOOR)
        return c, res, 0.5 * torch.log(res)


def ladder(K: int, eps: float, a: float):
    """(ihi, num_rungs, base) of the geometric threshold ladder for budget
    K: rungs (1 + eps)^i between the singleton value m = 1/2 log(1 + a)
    and K m, largest first; base is 1 + eps rounded to float32, as the
    configuration's hyperparameters are stored."""
    m = 0.5 * math.log1p(a)
    ilo = math.ceil(math.log(m) / math.log1p(eps) - 1e-9)
    ihi = math.floor(math.log(K * m) / math.log1p(eps) + 1e-9)
    base = float(torch.tensor(1.0 + eps, dtype=torch.float32))
    return ihi, max(ihi - ilo + 1, 1), base


def rung_values(base, ihi, j, dtype):
    """(1 + eps)^(ihi - j), elementwise over tensors of rung indices."""
    return torch.pow(base.to(dtype), (ihi - j).to(dtype))
