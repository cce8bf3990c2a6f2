# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""ThreeSieves as a data-pipeline feature: on-the-fly coreset selection
over example embeddings (port of ``repro/data/coreset.py``).

``CoresetSelector`` wraps any ``repro_torch.core`` algorithm (default:
ThreeSieves) behind a chunk-oriented API the input pipeline calls per
batch:

    sel = CoresetSelector(K=64, d=emb_dim, T=1000, eps=0.001)
    for batch, embeds in stream:
        sel.update(embeds)            # one fused gain pass per accept
    feats, n, fval = sel.summary()

The per-batch cost is one fused gain pass in the common all-rejected
case (``run_batched``; the ``gain_traced`` kernel on the card).  Drift
handling per the paper §3: re-arm with ``reset()``, or watch
``accept_rate`` to trigger re-selection.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.api import make


class CoresetSelector:
    def __init__(self, K: int, d: int, *, T: int = 1000, eps: float = 1e-3,
                 a: float = 1.0, lengthscale: Optional[float] = None,
                 algorithm: str = "threesieves",
                 backend: Optional[str] = None, device=None):
        self.algo = make(algorithm, K, d, a=a, lengthscale=lengthscale,
                         eps=eps, T=T, backend=backend, device=device)
        self._state = self.algo.init()
        self._n_seen = 0

    # ------------------------------------------------------------------ api
    def update(self, embeds: torch.Tensor) -> None:
        """Consume one (B, d) chunk of the stream."""
        self._state = self.algo.run_batched(self._state, embeds)
        self._n_seen += embeds.shape[0]

    def summary(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(feats (K, d) zero-padded, n_selected, f(S))."""
        return self.algo.summary(self._state)

    def reset(self) -> None:
        """Re-arm (concept-drift re-selection, paper §3)."""
        self._state = self.algo.init()
        self._n_seen = 0

    @property
    def n_selected(self) -> int:
        return int(self.summary()[1])

    @property
    def n_seen(self) -> int:
        return self._n_seen

    @property
    def accept_rate(self) -> float:
        return self.n_selected / max(self._n_seen, 1)

    def assign(self, embeds: torch.Tensor) -> torch.Tensor:
        """Nearest-summary-item index per row (the paper's FACT use case:
        cluster the stream around the summary for expert inspection)."""
        feats, n, _ = self.summary()
        k = self.algo.f.kernel.pairwise(embeds, feats)  # (B, K)
        live = torch.arange(feats.shape[0], device=feats.device) < n
        k = torch.where(live[None, :], k, -torch.inf)
        return torch.argmax(k, dim=1)
