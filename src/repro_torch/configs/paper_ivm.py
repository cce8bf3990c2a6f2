# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The paper's own 'architecture': the IVM log-det summarization stack.

Not an LM — this config parameterizes the summarization task itself
(objective scale a, kernel lengthscale convention, K, stream dims) exactly
as in the paper's experiments (§4): log-det with RBF kernel, a=1,
l = 1/(2 sqrt(d)) batch / 1/sqrt(d) streaming.

Port of ``repro/configs/paper_ivm.py``: the same fields, field for field.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperIVMConfig:
    K: int = 50
    d: int = 16
    a: float = 1.0
    eps: float = 1e-3
    T: int = 5000
    regime: str = "batch"  # "batch" | "stream" (lengthscale convention)

    @property
    def lengthscale(self) -> float:
        return (1.0 / (2.0 * self.d**0.5) if self.regime == "batch"
                else 1.0 / self.d**0.5)


CONFIG = PaperIVMConfig()


def reduced() -> PaperIVMConfig:
    return PaperIVMConfig(K=10, d=8, T=100, eps=0.01)
